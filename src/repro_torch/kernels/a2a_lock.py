"""K4: the lock-synchronised (passive-target) alltoallv epoch over P
virtual ranks.

Port of the Pallas kernel ``repro.kernels.a2a_lock.rma_alltoallv_lock``
(the paper's Algorithm 3), extended with the per-round capacities and round
elision of ``repro.core.variants.lock_exchange``, so one kernel serves both
the full-capacity epoch and a persistent plan's elided schedule.  The CUDA
kernels are in ``csrc/a2a_lock.cu``.

Round ``r`` (1 <= r < P) sends rank ``i``'s bucket to ``(i + r) % P``
(ring) or ``i ^ r`` (pairwise).  Each round moves ``round_capacities[r]``
rows per bucket (the global capacity when none are given); rows above that
are zero in the received bucket, and a round of capacity 0 carries nothing.
The epoch's phases are ``lock_steps``: the first carries round 0 (the local
bucket), the zero buckets of the elided rounds and the first active round;
every later active round is a phase of its own.

Which kernel a call takes (``kernel_for``), by a rule on the inputs alone:

- CPU tensors: the plain version below;
- ``meta`` tensors: an empty output of the right shape, nothing computed
  or counted as a launch (the dry run traces a step this way);
- CUDA tensors whose row width is a multiple of 16 bytes on a 16-byte
  aligned base: ``lock_cluster_kernel``, the whole epoch in ONE launch, one
  thread-block cluster per origin rank whose CTAs meet at a cluster barrier
  after each phase (counter ``CLUSTER``);
- other CUDA tensors: ``lock_step_kernel``, one launch per phase in stream
  order, a phase of more than ``MAX_STEP_ROUNDS`` entries split over
  consecutive launches (``step_launches``; counter ``KERNEL``).

Any P is taken, as by the reference: the cluster kernel reads its round
table from device memory, and only the step kernel's by-value rounds are
capped per launch.

Neither is a fallback for the other: a build or launch error raises.

The peer form (``rma_alltoallv_lock_peer``) runs one rank's share of the
epoch with one process per rank (``launch.mesh.ProcessMesh``): after an
OPEN signal to every peer (no wait), round ``r`` waits until its target
has opened its window, puts this rank's bucket into rows ``[me*C, me*C +
cap_r)`` of the target's window (``rma_signal.PeerWindow``), signals the
target's ROUND flag and waits for the ROUND flag of the rank that puts to
this one in the round: the recv-side wait of the TPU kernel's
``rdma.wait()``.  Its phases are ``lock_peer_steps``: the elided rounds
are left out, since they move nothing and wait on nothing.  CPU windows
take the plain version; windows on a card ``lock_peer_kernel`` (counter
``PEER``): the whole epoch, its OPEN included, in ONE launch of the
window's ``lock_ctas`` CTAs (at most the card's resident CTAs of this
kernel split over the ranks that share it; a cooperative launch, so all are
resident at once), each moving its share of every round, with
a round slot per CTA in each pad and a grid barrier per round; rows of
16-byte multiples on aligned bases by TMA bulk copies, other rows by
4-byte or byte register copies (``lock_peer_width``), every wait bounded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from . import _build
from .gather_rows import row_bytes
from .rma_signal import (OPEN, ROUND, PeerWindow, flag_index, rma_signal_plain,
                         wait_flag)

KERNEL = _build.register(_build.CudaKernel(
    "a2a_lock", "a2a_lock", "repro_a2a_lock_step",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 3
    + [_build.VOIDP, _build.VOIDP, _build.INT, _build.INT, _build.VOIDP],
    kid="K4"))
CLUSTER = _build.register(_build.CudaKernel(
    "a2a_lock_cluster", "a2a_lock", "repro_a2a_lock_cluster",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 3
    + [_build.VOIDP] + [_build.INT] * 4 + [_build.VOIDP], kid="K4"))

PEER = _build.register(_build.CudaKernel(
    "a2a_lock_peer", "a2a_lock", "repro_a2a_lock_peer",
    [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.I64] * 2 + [_build.VOIDP]
    + [_build.INT] * 6 + [_build.I64] * 2 + [_build.VOIDP] * 3, kid="K4"))

# Entries one launch of the step kernel can carry (it takes them by value).
MAX_STEP_ROUNDS = 256
# Cluster sizes the cluster kernel takes, largest first (16 is above the
# portable 8: the launcher allows non-portable sizes).
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# Bulk copies move 16-byte multiples from and to 16-byte aligned addresses.
BULK_ALIGN = 16


def lock_steps(p: int, capacity: int,
               round_capacities: Sequence[int] | None = None,
               schedule: str = "ring") -> list[list[tuple[int, int]]]:
    """The phases of one lock epoch, each a list of ``(round, capacity)``.

    The first phase carries round 0 (the local bucket, full capacity), the
    elided rounds (capacity 0: their received buckets are zero) and the
    first active round; every later active round is a phase of its own.
    ``lock_step_kernel`` launches once per phase (``step_launches``).
    """
    if schedule not in ("ring", "pairwise"):
        raise ValueError(f"unknown lock schedule {schedule!r}")
    if schedule == "pairwise" and p & (p - 1):
        raise ValueError("pairwise schedule requires power-of-two P")
    caps = [(r, min(int(round_capacities[r]) if round_capacities is not None
                    else capacity, capacity)) for r in range(1, p)]
    active = [(r, c) for r, c in caps if c > 0]
    elided = [(r, 0) for r, c in caps if c == 0]
    return [[(0, capacity)] + elided + active[:1]] + [[rc] for rc in active[1:]]


def step_launches(steps: list[list[tuple[int, int]]]
                  ) -> list[list[tuple[int, int]]]:
    """The launches of ``lock_step_kernel`` for the phases ``steps``: each
    phase in order, one longer than ``MAX_STEP_ROUNDS`` entries cut into
    consecutive launches of at most that many.  A phase's entries write
    disjoint output buckets, so the cut changes nothing."""
    return [step[i:i + MAX_STEP_ROUNDS] for step in steps
            for i in range(0, len(step), MAX_STEP_ROUNDS)]


def kernel_choice(device_type: str, row_width: int, addr: int) -> str:
    """The rule of ``kernel_for`` on plain values: "plain", "cluster" or
    "step"."""
    if device_type == "cpu":
        return "plain"
    if row_width % BULK_ALIGN == 0 and addr % BULK_ALIGN == 0:
        return "cluster"
    return "step"


def kernel_for(packed: torch.Tensor) -> str:
    """Which kernel ``rma_alltoallv_lock(packed, ...)`` takes."""
    return kernel_choice(packed.device.type, row_bytes(packed),
                         packed.data_ptr())


def cuda_kernel(row_width: int) -> _build.CudaKernel:
    """The kernel a CUDA call with rows of ``row_width`` bytes on an aligned
    base (any fresh torch allocation) launches: what a plan names."""
    return CLUSTER if kernel_choice("cuda", row_width, 0) == "cluster" else KERNEL


def lock_cluster_size(p: int, active: dict[int, int]) -> int:
    """CTAs per cluster: the largest size for which the card holds all
    ``p`` clusters at once (``active[size]`` clusters, from the occupancy
    query), else 1."""
    for size in CLUSTER_SIZES[:-1]:
        if active.get(size, 0) >= p:
            return size
    return 1


@dataclasses.dataclass(frozen=True)
class LockSchedule:
    """The cluster kernel's view of one epoch: an int32 table
    ``[rounds(n) | caps(n) | phase_start(phases + 1)]`` over the entries of
    ``lock_steps`` in order, and its two lengths."""
    table: np.ndarray
    n_entries: int
    n_phases: int


@functools.lru_cache(maxsize=None)
def lock_schedule(p: int, capacity: int, caps_key: bytes | None,
                  schedule: str) -> LockSchedule:
    """``LockSchedule`` of ``lock_steps(p, capacity, caps, schedule)``, built
    once per schedule (``caps_key`` is the round capacities as int64 bytes,
    or None for every round at the full capacity)."""
    caps = None if caps_key is None else np.frombuffer(caps_key, np.int64)
    steps = lock_steps(p, capacity, caps, schedule)
    entries = [rc for step in steps for rc in step]
    starts = np.cumsum([0] + [len(step) for step in steps])
    table = np.concatenate([[r for r, _ in entries], [c for _, c in entries],
                            starts]).astype(np.int32)
    table.flags.writeable = False
    return LockSchedule(table, len(entries), len(steps))


def caps_key(round_capacities) -> bytes | None:
    if round_capacities is None:
        return None
    return np.asarray(round_capacities, np.int64).tobytes()


@functools.lru_cache(maxsize=None)
def active_clusters(device_index: int) -> dict[int, int]:
    """Clusters of each size the card holds at once for the cluster kernel
    (``cudaOccupancyMaxActiveClusters``); raises if the query fails.  The
    query also sets the kernel's launch attributes on that device (its
    shared memory, clusters above 8 CTAs), which its launches need."""
    active = (ctypes.c_int * len(CLUSTER_SIZES))()
    with torch.cuda.device(device_index):
        rc = CLUSTER.c_function("repro_a2a_lock_cluster_occupancy",
                                [_build.VOIDP])(ctypes.cast(active, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"a2a_lock_cluster: occupancy query failed, CUDA "
                           f"error {rc}: {CLUSTER.error_string(rc)}")
    return {size: active[j] for j, size in enumerate(sorted(CLUSTER_SIZES))}


# The round tables on the card, uploaded once per (schedule, device).
_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}


def _check_packed(packed: torch.Tensor, p: int, capacity: int) -> None:
    if packed.dim() < 2 or tuple(packed.shape[:2]) != (p, p * capacity):
        raise ValueError(f"packed must be [P={p}, P*C={p * capacity}, *F], "
                         f"got {tuple(packed.shape)}")


@_build.counted(KERNEL, lambda out, packed, *a, **k:
                (0, _build.tensor_bytes(packed, out)))
def rma_alltoallv_lock(packed: torch.Tensor, p: int, capacity: int,
                       round_capacities: Sequence[int] | None = None,
                       schedule: str = "ring") -> torch.Tensor:
    """[P, P*C, *F] -> [P, P*C, *F]: on CUDA one launch of the cluster
    kernel, or one launch of the step kernel per phase (``kernel_for``);
    on ``meta`` the output's shape alone."""
    _check_packed(packed, p, capacity)
    if packed.device.type == "meta":
        _build.check_meta(packed)
        return torch.empty_like(packed)
    if packed.device.type == "cpu":
        return rma_alltoallv_lock_plain(packed, p, capacity,
                                        round_capacities, schedule)
    if kernel_for(packed) == "cluster":
        return lock_cluster_kernel(packed, p, capacity, round_capacities,
                                   schedule)
    return lock_step_kernel(packed, p, capacity, round_capacities, schedule)


def lock_cluster_kernel(packed: torch.Tensor, p: int, capacity: int,
                        round_capacities: Sequence[int] | None = None,
                        schedule: str = "ring") -> torch.Tensor:
    """The whole epoch in one launch of ``lock_cluster_kernel`` (CUDA
    only; the launcher refuses rows or bases that are not 16-byte
    multiples)."""
    _check_packed(packed, p, capacity)
    _build.check_cuda(packed)
    key = (p, capacity, caps_key(round_capacities), schedule)
    sched = lock_schedule(*key)
    table = _DEVICE_TABLES.get(key + (packed.device,))
    if table is None:
        table = _DEVICE_TABLES[key + (packed.device,)] = torch.from_numpy(
            sched.table.copy()).to(packed.device)
    cluster = lock_cluster_size(p, active_clusters(packed.device.index))
    out = torch.empty_like(packed)
    CLUSTER.launch(packed.data_ptr(), out.data_ptr(), p, capacity,
                   row_bytes(packed), table.data_ptr(), sched.n_entries,
                   sched.n_phases, int(schedule == "pairwise"), cluster,
                   _build.stream_handle(packed))
    return out


def lock_step_kernel(packed: torch.Tensor, p: int, capacity: int,
                     round_capacities: Sequence[int] | None = None,
                     schedule: str = "ring") -> torch.Tensor:
    """The epoch as one launch of ``lock_step_kernel`` per phase, or per
    piece of a phase (``step_launches``; CUDA only; any row width and
    base)."""
    _check_packed(packed, p, capacity)
    steps = lock_steps(p, capacity, round_capacities, schedule)
    _build.check_cuda(packed)
    out = torch.empty_like(packed)
    rb, stream = row_bytes(packed), _build.stream_handle(packed)
    pairwise = int(schedule == "pairwise")
    for step in step_launches(steps):
        rounds = (ctypes.c_int * len(step))(*(r for r, _ in step))
        caps = (ctypes.c_int * len(step))(*(c for _, c in step))
        KERNEL.launch(packed.data_ptr(), out.data_ptr(), p, capacity, rb,
                      ctypes.cast(rounds, ctypes.c_void_p),
                      ctypes.cast(caps, ctypes.c_void_p), len(step), pairwise,
                      stream)
    return out


def rma_alltoallv_lock_plain(packed: torch.Tensor, p: int, capacity: int,
                             round_capacities: Sequence[int] | None = None,
                             schedule: str = "ring") -> torch.Tensor:
    _check_packed(packed, p, capacity)
    KERNEL.plain_calls += 1
    feat = tuple(packed.shape[2:])
    src = packed.reshape((p, p, capacity) + feat)
    out = torch.zeros_like(packed)
    dst = out.view((p, p, capacity) + feat)
    ranks = torch.arange(p, device=packed.device)
    for step in lock_steps(p, capacity, round_capacities, schedule):
        for r, cap in step:
            tgt = ranks ^ r if schedule == "pairwise" else (ranks + r) % p
            dst[tgt, ranks, :cap] = src[ranks, tgt, :cap]
    return out


# -- the peer form: one process per rank ---------------------------------------

def lock_peer_steps(p: int, capacity: int,
                    round_capacities: Sequence[int] | None = None,
                    schedule: str = "ring") -> list[list[tuple[int, int]]]:
    """The phases of one rank's peer lock epoch, each a list of ``(round,
    capacity)``: round 0 (the local bucket) with the first active round,
    then every later active round alone.  Elided rounds (capacity 0) are
    not there: no rank sends in them, so none waits in them."""
    steps = lock_steps(p, capacity, round_capacities, schedule)
    active = [rc for step in steps for rc in step if rc[0] > 0 and rc[1] > 0]
    return [[(0, capacity)] + active[:1]] + [[rc] for rc in active[1:]]


@functools.lru_cache(maxsize=None)
def lock_peer_schedule(p: int, capacity: int, caps_key: bytes | None,
                       schedule: str) -> LockSchedule:
    """``LockSchedule`` of ``lock_peer_steps``, built once per schedule."""
    caps = None if caps_key is None else np.frombuffer(caps_key, np.int64)
    steps = lock_peer_steps(p, capacity, caps, schedule)
    entries = [rc for step in steps for rc in step]
    starts = np.cumsum([0] + [len(step) for step in steps])
    table = np.concatenate([[r for r, _ in entries], [c for _, c in entries],
                            starts]).astype(np.int32)
    table.flags.writeable = False
    return LockSchedule(table, len(entries), len(steps))


# Access widths of the peer kernel's forms: TMA bulk copies of 16-byte
# multiples, 4-byte words, bytes.
PEER_WIDTHS = (16, 4, 1)


@functools.lru_cache(maxsize=None)
def peer_info(device_index: int, width: int) -> dict:
    """What the card says of the peer kernel's form for ``width``
    (``_build.kernel_info``).  The query also sets the 16-byte form's
    shared-memory limit on that device, which its launches need."""
    return _build.kernel_info(PEER, "repro_a2a_lock_peer_info", width,
                              device_index)


def peer_resident_ctas(device_index: int) -> int:
    """CTAs of the peer kernel the card holds at once (the least of its
    forms: the 16-byte form's shared ring)."""
    return min(i["blocks_per_sm"] * i["sms"] for i in
               (peer_info(device_index, w) for w in PEER_WIDTHS))


def lock_peer_width(row_width: int, addr: int) -> int:
    """The access width of the peer kernel for rows of ``row_width`` bytes
    from a send buffer at ``addr`` (window bases are 256-byte aligned)."""
    return next(w for w in PEER_WIDTHS
                if row_width % w == 0 and addr % w == 0)


def _peer_target(me: int, r: int, p: int, schedule: str) -> tuple[int, int]:
    """Round ``r``'s target of rank ``me`` and the rank that puts to it."""
    if schedule == "pairwise":
        return me ^ r, me ^ r
    return (me + r) % p, (me - r) % p


def _check_peer_packed(packed: torch.Tensor, win: PeerWindow,
                       capacity: int) -> int:
    p = win.p
    if packed.dim() < 1 or packed.shape[0] != p * capacity:
        raise ValueError(f"packed must be [P*C={p * capacity}, *F], got "
                         f"{tuple(packed.shape)}")
    rb = torch.Size(packed.shape[1:]).numel() * packed.element_size()
    if p * capacity * rb > win.nbytes:
        raise ValueError(f"a window of {win.nbytes} bytes cannot take {p} "
                         f"buckets of {capacity} rows of {rb} bytes")
    return rb


@_build.counted(PEER, lambda out, packed, *a, **k:
                (0, 2 * _build.tensor_bytes(packed)))
def rma_alltoallv_lock_peer(packed: torch.Tensor, win: PeerWindow,
                            capacity: int,
                            round_capacities: Sequence[int] | None = None,
                            schedule: str = "ring",
                            epoch: int | None = None) -> None:
    """This rank's lock epoch ``epoch`` (default: the window's next):
    ``packed [P*C, *F]`` (bucket t for rank t) round by round into rows
    ``[me*C, me*C + cap_r)`` of each target's window.  When it returns (on
    a card: when the stream reaches its end) every peer's rows for this
    rank are in this rank's window."""
    rb = _check_peer_packed(packed, win, capacity)
    epoch = win.next_epoch() if epoch is None else epoch
    if packed.device.type == "cpu":
        rma_alltoallv_lock_peer_plain(packed, win, capacity, round_capacities,
                                      schedule, epoch)
        return
    lock_peer_kernel(packed, win, capacity, round_capacities, schedule, epoch,
                     rb)


def lock_peer_kernel(packed: torch.Tensor, win: PeerWindow, capacity: int,
                     round_capacities: Sequence[int] | None = None,
                     schedule: str = "ring", epoch: int = 1,
                     rb: int | None = None) -> None:
    """The whole peer lock epoch in one launch of ``lock_peer_kernel``
    (CUDA only) on the window's ``lock_ctas`` CTAs."""
    _build.check_cuda(packed, win.local)
    if rb is None:
        rb = _check_peer_packed(packed, win, capacity)
    p = win.p
    key = (p, capacity, caps_key(round_capacities), schedule)
    sched = lock_peer_schedule(*key)
    dkey = ("peer",) + key + (packed.device,)
    table = _DEVICE_TABLES.get(dkey)
    if table is None:
        table = _DEVICE_TABLES[dkey] = torch.from_numpy(
            sched.table.copy()).to(packed.device)
    width = lock_peer_width(rb, packed.data_ptr())
    peer_info(packed.device.index, width)     # sets its launch attributes
    PEER.launch(packed.data_ptr(), win.peer_ptrs.data_ptr(),
                win.pad_ptrs.data_ptr(), win.rank, p, capacity, rb,
                table.data_ptr(), sched.n_entries, sched.n_phases,
                int(schedule == "pairwise"), width, win.lock_ctas,
                int(win.sys_scope), epoch,
                win.timeout_ns, win.sync.data_ptr(), win.error.data_ptr(),
                _build.stream_handle(packed))


def lock_peer_rounds_plain(packed: torch.Tensor, win: PeerWindow,
                           capacity: int,
                           round_capacities: Sequence[int] | None = None,
                           schedule: str = "ring", epoch: int = 1) -> None:
    """The rounds of K4's peer form as tensor copies and host flag waits,
    writing the kernel's flag slots: every round slot of this rank in each
    target's pad."""
    rb = _check_peer_packed(packed, win, capacity)
    me, p, slots = win.rank, win.p, win.lock_ctas
    src = packed.contiguous().reshape(-1).view(torch.uint8)
    bucket = capacity * rb
    mine = flag_index(p, slots, ROUND, me)
    for step in lock_peer_steps(p, capacity, round_capacities, schedule):
        for r, cap in step:
            t, _ = _peer_target(me, r, p, schedule)
            if t != me:
                wait_flag(win, OPEN, t, epoch)
            win.peers[t][me * bucket:me * bucket + cap * rb].copy_(
                src[t * bucket:t * bucket + cap * rb])
        for r, _ in step:
            t, _ = _peer_target(me, r, p, schedule)
            if t != me:
                win.pads[t][mine:mine + slots] = epoch
        for r, _ in step:
            _, s = _peer_target(me, r, p, schedule)
            if s != me:
                wait_flag(win, ROUND, s, epoch)


def rma_alltoallv_lock_peer_plain(packed: torch.Tensor, win: PeerWindow,
                                  capacity: int,
                                  round_capacities: Sequence[int] | None = None,
                                  schedule: str = "ring",
                                  epoch: int = 1) -> None:
    """The plain version of the whole peer lock epoch."""
    PEER.plain_calls += 1
    rma_signal_plain(win, OPEN, epoch, wait=False)
    lock_peer_rounds_plain(packed, win, capacity, round_capacities, schedule,
                           epoch)
