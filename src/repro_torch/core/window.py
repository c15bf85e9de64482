"""RMA window analogue: persistent, reusable device receive buffers.

Port of ``repro.core.window``.  The paper caches the ``MPI_Win`` between
iterations and only recreates it when ``total_recv_bytes`` changes.  Here a
window slot is one long-lived device tensor holding every virtual rank's
receive rows, ``[P * recv_rows, *F]``; each epoch's unpack stores the valid
rows straight into it, in place, so stale padding bytes persist across
epochs exactly like uninitialized window memory does in real RMA, and an
epoch allocates no output.

With one process per rank (``launch.mesh.ProcessMesh``) a window is a
``SharedWindow``: per slot, this rank's ``[recv_rows, *F]`` receive buffer
and a registered region, the ``MPI_Win_create`` of the port.  Its create
and free are collective.  Each rank allocates its region (a signal pad of
int64 flags, then the bytes its peers put into) and the ranks exchange
handles over the control plane; each rank then maps every peer's region,
so an epoch's put is a store through the peer's mapping
(``kernels.rma_signal.PeerWindow``).  On a card the region is a
``cudaMalloc`` shared by CUDA IPC handles; on the CPU (the plain versions)
a shared-memory file (``torch.from_file(..., shared=True)``), removed at
FREE and at exit.  FREE waits on a barrier of every rank before it closes
anything, so no peer can write into a freed mapping.  The reuse rule
stays: a window is found by ``(recv_rows, feature, dtype)``, i.e. while
``total_recv_bytes`` is unchanged, and each slot is registered once, again
only if a plan sharing the window needs a larger region.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import tempfile
from typing import Any

import torch

from ..kernels import a2a_fence, a2a_lock, rma_signal
from .metadata import dtype_name


@dataclasses.dataclass
class Window:
    """One exposed receive buffer (per-rank rows x feature).

    A window holds one buffer per *slot*.  Slot 0 is the classic
    START/WAIT window; ``ExchangePlan.start_pipelined`` rotates through
    ``depth`` slots (default 2, classic double buffering) so epoch k+1
    never writes the slot epoch k's consumer is reading; an epoch's output
    slot is recycled after ``depth`` further starts (the RMA exposure-epoch
    rule).  Slots materialize lazily.
    """

    rows: int
    feature_shape: tuple[int, ...]
    dtype: Any                       # torch dtype
    nbytes_per_rank: int
    generation: int = 0              # bumped every (re)create of any slot
    _slots: dict = dataclasses.field(default_factory=dict)

    @property
    def buffer(self) -> torch.Tensor | None:
        """The primary (slot 0) buffer — the single-buffer window view."""
        return self._slots.get(0)

    def materialize(self, global_shape: tuple[int, ...], device: torch.device,
                    slot: int = 0) -> torch.Tensor:
        buf = self._slots.get(slot)
        if buf is None or tuple(buf.shape) != global_shape or buf.device != device:
            buf = torch.zeros(global_shape, dtype=self.dtype, device=device)
            self._slots[slot] = buf
            self.generation += 1
        return buf

    def release(self) -> None:
        """Drop every slot's device buffer (FREE)."""
        self._slots.clear()


class WindowCache:
    """Cache of windows keyed by (rows, feature, dtype) — the paper's
    total_recv_bytes reuse rule, with hit/recreate statistics."""

    def __init__(self) -> None:
        self._windows: dict[tuple, Window] = {}
        self.hits = 0
        self.recreates = 0

    def get(self, rows: int, feature_shape: tuple[int, ...], dtype,
            mesh=None) -> "Window | SharedWindow":
        """The window of ``rows`` x ``feature_shape`` of ``dtype``; a
        ``SharedWindow`` of ``mesh`` for a process mesh."""
        shared = getattr(mesh, "is_process_mesh", False)
        key = (rows, tuple(feature_shape), dtype_name(dtype)) + (
            (id(mesh),) if shared else ())
        win = self._windows.get(key)
        if win is not None:
            self.hits += 1
            return win
        self.recreates += 1
        if shared:
            win = SharedWindow(mesh, rows, tuple(feature_shape), dtype)
        else:
            row_elems = 1
            for s in feature_shape:
                row_elems *= s
            win = Window(
                rows=rows,
                feature_shape=tuple(feature_shape),
                dtype=dtype,
                nbytes_per_rank=rows * row_elems * dtype.itemsize,
            )
        self._windows[key] = win
        return win

    def free(self) -> None:
        for w in self._windows.values():
            w.release()              # every slot, not only slot 0
        self._windows.clear()

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "recreates": self.recreates, "live": len(self._windows)}


# -- windows shared across processes -------------------------------------------

PAD_ALIGN = 256          # the exposed bytes start 256-byte aligned
_OWN_FILES: set[str] = set()


def shm_dir() -> str:
    """Where CPU windows live: ``/dev/shm`` (memory) where it is writable,
    else the temporary directory."""
    d = "/dev/shm"
    return d if os.path.isdir(d) and os.access(d, os.W_OK) else tempfile.gettempdir()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@atexit.register
def _remove_own_files() -> None:
    for path in list(_OWN_FILES):
        try:
            os.unlink(path)
        except OSError:
            pass
    _OWN_FILES.clear()


def peer_geometry(mesh) -> dict:
    """The peer kernels' geometry as this rank sees its card: the window's
    memory (``cpu`` or ``cuda``), the ranks that share the card, and the
    CTAs of the peer K2 and K4, each the card's resident CTAs of that
    kernel split over those ranks (``rma_signal.grid_budget``).  One each
    on the CPU, whose plain versions have no grid."""
    r = mesh.ranks_on_device
    if mesh.device.type != "cuda":
        return {"memory": "cpu", "ranks_on_device": r, "fence_ctas": 1,
                "lock_ctas": 1}
    idx = mesh.device.index
    return {"memory": "cuda", "ranks_on_device": r,
            "fence_ctas": rma_signal.grid_budget(
                a2a_fence.peer_resident_ctas(idx), r),
            "lock_ctas": rma_signal.grid_budget(
                a2a_lock.peer_resident_ctas(idx), r)}


def agreed_geometry(mesh) -> dict:
    """The geometry a window registration uses on this rank (collective).
    Every rank's ``peer_geometry`` is all-gathered.  The peer K4's CTAs, and
    the round slots per origin in every pad, are the fewest over the ranks,
    so the slots match and every grid stays within its card's budget, also
    where the ranks spread unevenly over the cards.  The peer K2 keeps its
    own budget: its grid has no per-CTA slots.  Flags take system scope
    where any rank is on another card.  Windows in memory of two kinds (one
    rank's on the CPU, another's on a card) cannot map each other: that
    raises ``ValueError`` on every rank."""
    own = peer_geometry(mesh)
    every = mesh.all_gather_object(own)
    bad = [r for r, g in enumerate(every) if g["memory"] != every[0]["memory"]]
    if bad:
        raise ValueError(
            f"rank {mesh.rank}: ranks disagree on the peer kernels' geometry "
            f"(the windows' memory): rank 0 has {every[0]['memory']!r}, "
            f"ranks {bad} have {[every[r]['memory'] for r in bad]!r}")
    return {**own, "lock_ctas": min(g["lock_ctas"] for g in every),
            "sys_scope": any(g["ranks_on_device"] < mesh.world_size
                             for g in every)}


class SharedRegion:
    """One registered window (collective): this rank's allocation, its
    mappings of every peer's, and the ``PeerWindow`` over them, with the
    geometry every rank agreed (``agreed_geometry``)."""

    def __init__(self, mesh, nbytes: int):
        p, me = mesh.world_size, mesh.rank
        self.mesh = mesh
        geo = agreed_geometry(mesh)
        flags = rma_signal.pad_len(p, geo["lock_ctas"])
        pad_bytes = _round_up(flags * 8, PAD_ALIGN)
        total = pad_bytes + _round_up(max(int(nbytes), 1), PAD_ALIGN)
        self.path = None
        self.ptrs: list[int] = []
        dev = mesh.device
        if dev.type == "cpu":
            self.path = os.path.join(
                shm_dir(), f"repro_torch_{mesh.token}_{me}_{mesh.next_region()}")
            _OWN_FILES.add(self.path)
            own = torch.from_file(self.path, shared=True, size=total,
                                  dtype=torch.uint8)
            paths = mesh.all_gather_object(self.path)
            bufs = [own if r == me else torch.from_file(
                        paths[r], shared=True, size=total, dtype=torch.uint8)
                    for r in range(p)]
            extra = {}
        else:
            with torch.cuda.device(dev):
                ptr, handle = rma_signal.ipc_alloc(total)
                handles = mesh.all_gather_object(handle)
                self.ptrs = [ptr if r == me else rma_signal.ipc_open(h)
                             for r, h in enumerate(handles)]
                bufs = [rma_signal.device_bytes(q, total, dev)
                        for q in self.ptrs]
            extra = {"peer_ptrs": torch.tensor(
                         [q + pad_bytes for q in self.ptrs], dtype=torch.int64,
                         device=dev),
                     "pad_ptrs": torch.tensor(self.ptrs, dtype=torch.int64,
                                              device=dev),
                     "sync": torch.zeros(rma_signal.SYNC_WORDS,
                                         dtype=torch.int64, device=dev),
                     "error": torch.zeros(4, dtype=torch.int64,
                                          pin_memory=True)}
        pads = [b[:flags * 8].view(torch.int64) for b in bufs]
        peers = [b[pad_bytes:pad_bytes + int(nbytes)] for b in bufs]
        self.win = rma_signal.PeerWindow(
            rank=me, p=p, local=peers[me], peers=peers, pad=pads[me],
            pads=pads, timeout=mesh.flag_timeout,
            lock_ctas=geo["lock_ctas"], fence_ctas=geo["fence_ctas"],
            sys_scope=geo["sys_scope"], **extra)

    def free(self) -> None:
        """``MPI_Win_free``: wait for this rank's epochs, meet every rank at
        a barrier, then unmap the peers' regions and free this rank's."""
        mesh = self.mesh
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.barrier()
        self.win = None
        if self.path is not None:
            _OWN_FILES.discard(self.path)
            os.unlink(self.path)
        if self.ptrs:
            with torch.cuda.device(mesh.device):
                for r, q in enumerate(self.ptrs):
                    if r == mesh.rank:
                        rma_signal.ipc_free(q)
                    else:
                        rma_signal.ipc_close(q)
        self.ptrs = []


@dataclasses.dataclass
class WindowSlot:
    """One slot of a ``SharedWindow``: the registered region and this
    rank's receive buffer ``[recv_rows, *F]``."""

    region: SharedRegion
    recv: torch.Tensor

    @property
    def win(self) -> "rma_signal.PeerWindow":
        return self.region.win


class SharedWindow:
    """The window of a process-mesh plan: per slot a ``WindowSlot``,
    registered collectively at its first use and again only when a plan
    needs more exposed bytes than it has.  ``generation`` counts the
    registrations."""

    def __init__(self, mesh, rows: int, feature_shape: tuple[int, ...], dtype):
        self.mesh = mesh
        self.rows = rows
        self.feature_shape = tuple(feature_shape)
        self.dtype = dtype
        row_elems = 1
        for s in feature_shape:
            row_elems *= s
        self.nbytes_per_rank = rows * row_elems * dtype.itemsize
        self.generation = 0
        self._slots: dict[int, WindowSlot] = {}

    def slot(self, slot: int, exposed_bytes: int) -> WindowSlot:
        """Slot ``slot`` with at least ``exposed_bytes`` of exposed window
        per rank, registering it (collective) if it has none or too few."""
        cur = self._slots.get(slot)
        if cur is not None and cur.win.nbytes >= exposed_bytes:
            return cur
        recv = (cur.recv if cur is not None else torch.zeros(
            (self.rows,) + self.feature_shape, dtype=self.dtype,
            device=self.mesh.device))
        if cur is not None:
            cur.region.free()
        self._slots[slot] = WindowSlot(SharedRegion(self.mesh, exposed_bytes),
                                       recv)
        self.generation += 1
        return self._slots[slot]

    def release(self) -> None:
        """FREE every slot (collective)."""
        for slot in self._slots.values():
            slot.region.free()
        self._slots.clear()
