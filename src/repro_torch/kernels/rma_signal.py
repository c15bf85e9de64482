"""Flags and windows of the peer epochs: ranks in separate processes.

With one process per rank (``launch.mesh.ProcessMesh``) every rank exposes
a window, a region of its own memory that its peers write into through
their own mapping of it, beside a signal pad of int64 flags.  A
``PeerWindow`` is one rank's view of one registered window: its own bytes,
every rank's bytes as this process maps them, and the pads.
``core.window.SharedWindow`` registers and frees them.

The flags (``csrc/rma_flags.cuh``): a pad of P origins holds ``open[P]``,
``close[P]`` and ``round[P][S]``, S round slots per origin, one for each
CTA of the peer K4 (the window's ``lock_ctas``, ``pad_len``,
``flag_index``).  A flag is written by its origin only (a round slot by
that CTA of the origin's K4) and holds the number of the last epoch it
signalled; it is never reset, and a wait is for it to reach the epoch at
hand.  Purposes: ``OPEN`` (the target's window is free for this epoch),
``CLOSE`` (the origin's puts have landed) and ``ROUND`` (the lock's
per-round put).  A signal or wait of ``ROUND`` covers every slot of the
origin.

The peer K2 and K4 (``a2a_fence``, ``a2a_lock``) signal and wait inside
their one launch per epoch, on a grid of at most the card's resident CTAs
of that kernel split over the ranks that share the card (``grid_budget``).
``rma_signal(win, purpose, epoch, signal, wait)`` signals ``purpose`` of
``epoch`` on every peer and waits for every peer's flag in the local pad,
for the peer K3's epoch:

- CPU tensors (pads in shared-memory files): the plain version below, a
  store per peer and a host wait on each flag;
- CUDA tensors: ``csrc/rma_signal.cu``'s signal kernel, one block on the
  current stream (counter ``SIGNAL``).

Every wait is bounded by ``win.timeout`` seconds (the plain version raises
``RuntimeError``; a kernel traps after recording rank, epoch and flag in
``win.error``, which ``flag_error`` turns into the message), so a lost
peer is an error, not a hang.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from . import _build

OPEN, CLOSE, ROUND = 0, 1, 2
# A kernel's error record may also name GRID: a wait on its own grid (a
# barrier, the fence's go word) that no peer wait explains.
GRID = 3
PURPOSES = ("open", "close", "round", "grid")
# Words of a window's SyncWords (csrc/rma_flags.cuh), as int64.
SYNC_WORDS = 4

SIGNAL = _build.register(_build.CudaKernel(
    "rma_signal", "rma_signal", "repro_rma_signal",
    [_build.VOIDP] + [_build.INT] * 4 + [_build.I64, _build.INT, _build.INT,
                                         _build.I64, _build.VOIDP,
                                         _build.VOIDP]))


def pad_len(p: int, slots: int = 1) -> int:
    """Flags (int64) of a pad of ``p`` origins with ``slots`` round slots
    each."""
    return (2 + slots) * p


def flag_index(p: int, slots: int, purpose: int, origin: int) -> int:
    """Where the flag (``purpose``, ``origin``) lies in a pad of ``p``
    origins with ``slots`` round slots each (for ``ROUND``, its first
    slot)."""
    if purpose == ROUND:
        return 2 * p + origin * slots
    return purpose * p + origin


def grid_budget(resident: int, ranks_on_device: int) -> int:
    """CTAs of one rank's peer kernel grid: the CTAs of that kernel the card
    holds at once (``resident``, from the occupancy query) split evenly over
    the ranks that share the card, never below one.  With a card of its own
    a rank takes the whole card; with 8 ranks on one card, an eighth."""
    return max(1, int(resident) // max(1, int(ranks_on_device)))


@dataclasses.dataclass
class PeerWindow:
    """One registered window as rank ``rank`` of ``p`` sees it.

    ``local``: this rank's exposed bytes (uint8); ``peers[t]``: rank t's
    exposed bytes as this process maps them (``peers[rank]`` is ``local``);
    ``pad`` / ``pads[t]``: the signal pads likewise (int64 ``[pad_len(p,
    lock_ctas)]``).  ``lock_ctas`` and ``fence_ctas``: the peer K4's grid
    (and round slots per origin) and the peer K2's largest grid, which
    every rank agreed at registration (one each on the CPU).
    ``sys_scope``: whether the peer K2 and K4 order their flags at system
    scope, which a peer on another card needs, or at GPU scope, where every
    rank shares this card (``csrc/rma_flags.cuh``).  On a card
    also the device tables ``peer_ptrs`` and ``pad_ptrs`` (int64 ``[p]``:
    the mapped addresses) the kernels take, ``sync``, this rank's
    SyncWords (device, zeroed), and ``error``, four int64 of pinned host
    memory a timed-out wait writes.  ``epoch`` counts the epochs run on
    this window (every rank runs them in the same order); ``timeout``
    bounds every wait, in seconds."""

    rank: int
    p: int
    local: torch.Tensor
    peers: list
    pad: torch.Tensor
    pads: list
    timeout: float = 10.0
    lock_ctas: int = 1
    fence_ctas: int = 1
    sys_scope: bool = True
    peer_ptrs: torch.Tensor | None = None
    pad_ptrs: torch.Tensor | None = None
    sync: torch.Tensor | None = None
    error: torch.Tensor | None = None
    epoch: int = 0

    @property
    def nbytes(self) -> int:
        return self.local.numel()

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def view(self, rows: int, feature_shape, dtype) -> torch.Tensor:
        """This rank's window as ``[rows, *feature_shape]`` of ``dtype``."""
        n = rows * torch.Size(feature_shape).numel() * dtype.itemsize
        return self.local[:n].view(dtype).view((rows,) + tuple(feature_shape))

    @property
    def timeout_ns(self) -> int:
        return int(self.timeout * 1e9)

    def flag_error(self) -> RuntimeError | None:
        """The timed-out wait a kernel recorded, as an error, or None."""
        if self.error is None or int(self.error[0]) == 0:
            return None
        epoch, flag, rank = (int(v) for v in self.error[1:])
        if flag // self.p == GRID:
            return RuntimeError(
                f"rank {rank}, epoch {epoch}: its own grid did not meet "
                f"within {2 * self.timeout} s")
        return RuntimeError(
            f"rank {rank}, epoch {epoch}: the {PURPOSES[flag // self.p]} "
            f"flag of rank {flag % self.p} did not reach the epoch within "
            f"{self.timeout} s (a lost or stalled peer)")


def rma_signal(win: PeerWindow, purpose: int, epoch: int, signal: bool = True,
               wait: bool = True) -> None:
    """Signal ``purpose`` of ``epoch`` on every peer and/or wait for every
    peer's flag in this rank's pad: the kernel for a window on a card, the
    plain version for one in host memory."""
    if win.local.device.type == "cpu":
        rma_signal_plain(win, purpose, epoch, signal, wait)
        return
    _build.check_cuda(win.local, win.pad_ptrs)
    SIGNAL.launch(win.pad_ptrs.data_ptr(), win.rank, win.p, win.lock_ctas,
                  purpose, epoch, int(signal), int(wait), win.timeout_ns,
                  win.error.data_ptr(), _build.stream_handle(win.local))


def rma_signal_plain(win: PeerWindow, purpose: int, epoch: int,
                     signal: bool = True, wait: bool = True) -> None:
    """The plain version: a store of ``epoch`` into each peer's pad, then a
    host wait on each peer's flag in this rank's pad.  Works on pads in
    shared-memory files (the CPU) and on a card's mapped pads (each read
    synchronises the stream)."""
    SIGNAL.plain_calls += 1
    me, p = win.rank, win.p
    if signal:
        n = win.lock_ctas if purpose == ROUND else 1
        i = flag_index(p, win.lock_ctas, purpose, me)
        for t in range(p):
            if t != me:
                win.pads[t][i:i + n] = epoch
    if wait:
        for j in range(p):
            if j != me:
                wait_flag(win, purpose, j, epoch)


def wait_flag(win: PeerWindow, purpose: int, origin: int, epoch: int) -> None:
    """Host wait until ``origin``'s flag ``purpose`` (every round slot of
    it) in this rank's pad reaches ``epoch``; ``RuntimeError`` after
    ``win.timeout`` seconds."""
    i = flag_index(win.p, win.lock_ctas, purpose, origin)
    flags = win.pad[i:i + (win.lock_ctas if purpose == ROUND else 1)]
    t0 = time.monotonic()
    spins = 0
    while int(flags.min()) < epoch:
        if time.monotonic() - t0 > win.timeout:
            raise RuntimeError(
                f"rank {win.rank}, epoch {epoch}: the {PURPOSES[purpose]} flag "
                f"of rank {origin} stayed at {int(flags.min())} for "
                f"{win.timeout} s (a lost or stalled peer)")
        spins += 1
        time.sleep(0 if spins < 100 else 1e-4)


# -- window registration on a card (CUDA IPC) ----------------------------------

def _ipc(symbol: str, argtypes):
    return SIGNAL.c_function(symbol, argtypes)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {SIGNAL.error_string(rc)}")


def ipc_alloc(nbytes: int) -> tuple[int, bytes]:
    """A zeroed allocation of ``nbytes`` on the current device and its IPC
    handle."""
    size = _ipc("repro_ipc_handle_bytes", [])()
    ptr = ctypes.c_void_p()
    handle = (ctypes.c_char * size)()
    _check(_ipc("repro_ipc_alloc", [_build.I64, _build.VOIDP, _build.VOIDP])(
        nbytes, ctypes.byref(ptr), handle), "cudaMalloc / cudaIpcGetMemHandle")
    return ptr.value, bytes(handle)


def ipc_open(handle: bytes) -> int:
    """Map a peer's allocation into this process (current device)."""
    ptr = ctypes.c_void_p()
    _check(_ipc("repro_ipc_open", [ctypes.c_char_p, _build.VOIDP])(
        handle, ctypes.byref(ptr)), "cudaIpcOpenMemHandle")
    return ptr.value


def ipc_close(ptr: int) -> None:
    _check(_ipc("repro_ipc_close", [_build.VOIDP])(ptr), "cudaIpcCloseMemHandle")


def ipc_free(ptr: int) -> None:
    _check(_ipc("repro_ipc_free", [_build.VOIDP])(ptr), "cudaFree")


class _DeviceBytes:
    """``nbytes`` at a device address, for ``torch.as_tensor`` (which keeps
    this object alive as long as the tensor; the memory is freed by its
    owner, never by the tensor)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


def device_bytes(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 tensor over ``nbytes`` at device address ``ptr``."""
    t = torch.as_tensor(_DeviceBytes(ptr, nbytes), device=device)
    if t.data_ptr() != ptr:
        raise RuntimeError("torch.as_tensor copied a device buffer it was "
                           "asked to wrap")
    return t
