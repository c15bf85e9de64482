"""K4: the lock-synchronised (passive-target) alltoallv epoch over P
virtual ranks.

Port of the Pallas kernel ``repro.kernels.a2a_lock.rma_alltoallv_lock``
(the paper's Algorithm 3), extended with the per-round capacities and round
elision of ``repro.core.variants.lock_exchange``, so one kernel serves both
the full-capacity epoch and a persistent plan's elided schedule.  The CUDA
kernel is ``csrc/a2a_lock.cu``.

Round ``r`` (1 <= r < P) sends rank ``i``'s bucket to ``(i + r) % P``
(ring) or ``i ^ r`` (pairwise).  Each round moves ``round_capacities[r]``
rows per bucket (the global capacity when none are given); rows above that
are zero in the received bucket, and a round of capacity 0 carries nothing.
Each active round is one launch, in order on the stream: stream order is
the per-target lock.  The first launch also carries the local bucket and
the zero buckets of the elided rounds (``lock_steps``).

A CPU tensor takes the plain version in this module; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .gather_rows import row_bytes

KERNEL = _build.register(_build.CudaKernel(
    "a2a_lock", "a2a_lock", "repro_a2a_lock_step",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 3
    + [_build.VOIDP, _build.VOIDP, _build.INT, _build.INT, _build.VOIDP]))

# Rounds one launch can carry (the kernel takes them by value).
MAX_STEP_ROUNDS = 256


def lock_steps(p: int, capacity: int,
               round_capacities: Sequence[int] | None = None,
               schedule: str = "ring") -> list[list[tuple[int, int]]]:
    """The launches of one lock epoch, each a list of ``(round, capacity)``.

    The first launch carries round 0 (the local bucket, full capacity), the
    elided rounds (capacity 0: their received buckets are zero) and the
    first active round; every later active round is a launch of its own.
    """
    if schedule not in ("ring", "pairwise"):
        raise ValueError(f"unknown lock schedule {schedule!r}")
    if schedule == "pairwise" and p & (p - 1):
        raise ValueError("pairwise schedule requires power-of-two P")
    if p > MAX_STEP_ROUNDS:
        raise ValueError(f"the lock kernel takes P <= {MAX_STEP_ROUNDS}, got {p}")
    caps = [(r, min(int(round_capacities[r]) if round_capacities is not None
                    else capacity, capacity)) for r in range(1, p)]
    active = [(r, c) for r, c in caps if c > 0]
    elided = [(r, 0) for r, c in caps if c == 0]
    return [[(0, capacity)] + elided + active[:1]] + [[rc] for rc in active[1:]]


def _check_packed(packed: torch.Tensor, p: int, capacity: int) -> None:
    if packed.dim() < 2 or tuple(packed.shape[:2]) != (p, p * capacity):
        raise ValueError(f"packed must be [P={p}, P*C={p * capacity}, *F], "
                         f"got {tuple(packed.shape)}")


def rma_alltoallv_lock(packed: torch.Tensor, p: int, capacity: int,
                       round_capacities: Sequence[int] | None = None,
                       schedule: str = "ring") -> torch.Tensor:
    """[P, P*C, *F] -> [P, P*C, *F]: one launch per active round."""
    _check_packed(packed, p, capacity)
    steps = lock_steps(p, capacity, round_capacities, schedule)
    if packed.device.type == "cpu":
        return rma_alltoallv_lock_plain(packed, p, capacity,
                                        round_capacities, schedule)
    _build.check_cuda(packed)
    out = torch.empty_like(packed)
    rb, stream = row_bytes(packed), _build.stream_handle(packed)
    pairwise = int(schedule == "pairwise")
    for step in steps:
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
