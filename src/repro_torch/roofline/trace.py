"""Count what a step issues: the port's counterpart of
``repro.roofline.hlo``.

The JAX package reads a compiled module's FLOPs and bytes from XLA's
``cost_analysis()`` and its collectives from the optimized HLO text.  The
port has no HLO: a step is Python that issues aten ops, calls the
hand-written kernels' wrappers and runs the exchange plans.  A
``StepCounter`` is a ``TorchDispatchMode`` that is active only while a
step is traced (``with StepCounter() as c: step(...)``) and counts:

- **aten FLOPs**, by ``torch.utils.flop_counter``'s formulas (the matmul
  family and convolutions; elementwise ops count none, as there);
- **bytes accessed**: each aten op's tensor inputs plus its outputs (views
  and ``empty`` move nothing).  Nothing is fused here, so this is an upper
  figure of what the card moves;
- **each kernel K1-K6**: calls, FLOPs and bytes, worked out by the
  kernel's wrapper from its input and output shapes (``kernel``): every
  input read once and every output written once, the tables included;
  K6 does 2*E*N*D*F operations.  The figures do not depend on the
  implementation that ran, and the aten ops of a plain version running
  inside a wrapper are not counted again (``hidden``), so a CPU run, a
  ``meta`` trace and a CUDA run of the same step count the same;
- **each exchange** (``collective``): the op kind, the result bytes per
  rank and the group size, summed into a ``CollectiveStats`` with the
  JAX package's fields and ring models (``wire_bytes``).  Every epoch of
  an alltoallv plan, the ragged one included, is an ``all-to-all``; the
  allgatherv an ``all-gather``; the reduce-scatter family a
  ``reduce-scatter``; the hierarchy's leader hop a
  ``collective-permute``; the cross-pod sum an ``all-reduce``.  The
  collectives GSPMD inserts under FSDP or tensor parallelism have no
  counterpart on one card (every virtual rank holds the global view), so
  they are not counted; they come with the multi-process transport;
- **live bytes**: the high-water mark of live tensor storage during the
  trace, over the storages live when it began (``hold``) and every
  storage an op or a wrapper makes, for the memory estimate.

Library code reports through ``active()``, which costs one call into the
dispatcher when no counter is active.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
KERNEL_IDS = ("K1", "K2", "K3", "K4", "K5", "K6")

# Ops that move no bytes of their own: allocation and autograd's detach.
_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_like,
             torch.ops.aten.empty_strided, torch.ops.aten.detach,
             torch.ops.aten.lift_fresh}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def per_rank_bytes(t: torch.Tensor) -> int:
    """Bytes of one rank's slice of a ``[ranks, ...]`` buffer."""
    return nbytes(t) // max(t.shape[0], 1)


def wire_bytes(op: str, size: float, n: int) -> float:
    """Ring-model wire bytes per rank of one collective whose result is
    ``size`` bytes per rank over ``n`` ranks (``repro.roofline.hlo``)."""
    frac = (n - 1) / n if n > 1 else 0.0
    if op == "all-reduce":
        return 2 * size * frac
    if op == "all-gather":
        return size * frac
    if op == "reduce-scatter":
        return n * size * frac
    if op == "all-to-all":
        return size * frac
    if op == "collective-permute":       # one hop
        return float(size)
    raise ValueError(f"unknown collective {op!r}; one of {OPS}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict          # op -> count
    result_bytes: dict    # op -> sum of per-rank result bytes
    wire_bytes: dict      # op -> ring-model wire bytes per rank
    total_wire_bytes: int
    total_result_bytes: int

    def to_json(self) -> dict:
        return {
            "counts": dict(self.counts),
            "result_bytes": {k: int(v) for k, v in self.result_bytes.items()},
            "wire_bytes": {k: int(v) for k, v in self.wire_bytes.items()},
            "total_wire_bytes": int(self.total_wire_bytes),
            "total_result_bytes": int(self.total_result_bytes),
        }


def collective_stats(records) -> CollectiveStats:
    """``CollectiveStats`` of ``(op, result bytes per rank, group size)``
    records, summed as the JAX package sums parsed HLO ops (records of
    0 bytes are dropped, as there)."""
    counts: dict = defaultdict(int)
    rbytes: dict = defaultdict(int)
    wbytes: dict = defaultdict(float)
    for op, size, n in records:
        if size == 0:
            continue
        counts[op] += 1
        rbytes[op] += size
        wbytes[op] += wire_bytes(op, size, n)
    return CollectiveStats(
        counts=dict(counts), result_bytes=dict(rbytes),
        wire_bytes={k: int(v) for k, v in wbytes.items()},
        total_wire_bytes=int(sum(wbytes.values())),
        total_result_bytes=int(sum(rbytes.values())),
    )


class StepCounter(TorchDispatchMode):
    """Counts a traced step's aten FLOPs and bytes, kernel calls and
    exchanges, and the high-water mark of live storage (module docstring).
    """

    def __init__(self):
        super().__init__()
        self.aten_flops = 0
        self.aten_bytes = 0
        self.kernels = {k: {"calls": 0, "flops": 0, "bytes": 0}
                        for k in KERNEL_IDS}
        self.records: list[tuple[str, int, int]] = []
        self.live_bytes = 0
        self.live_start_bytes = 0
        self.live_peak_bytes = 0
        self._storages: dict[int, weakref.finalize] = {}
        self._local = threading.local()

    # -- reports from library code -------------------------------------------
    def kernel(self, kid: str, flops: int, nbytes_: int) -> None:
        """One call of kernel ``kid`` doing ``flops`` operations over
        ``nbytes_`` bytes (every input read once, every output written
        once)."""
        k = self.kernels[kid]
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes_)

    def collective(self, op: str, result_bytes: int, group: int) -> None:
        """One exchange: ``op`` (one of ``OPS``), ``result_bytes`` per rank,
        over groups of ``group`` ranks."""
        if op not in OPS:
            raise ValueError(f"unknown collective {op!r}; one of {OPS}")
        self.records.append((op, int(result_bytes), int(group)))

    def hidden(self):
        """Context in which aten ops are not counted (a kernel wrapper's
        plain version or launch); storage is still tracked."""
        return _Hidden(self._local)

    def hold(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (parameters,
        optimizer state, batch, caches) as live from the start."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.live_start_bytes = self.live_bytes

    # -- totals ----------------------------------------------------------------
    @property
    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k["bytes"] for k in self.kernels.values())

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes_accessed(self) -> int:
        return self.aten_bytes + self.kernel_bytes

    def stats(self) -> CollectiveStats:
        return collective_stats(self.records)

    def calls(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in self.kernels.items()}

    def totals(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "aten_flops": self.aten_flops, "aten_bytes": self.aten_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": self.stats().to_json(),
                "live_start_bytes": self.live_start_bytes,
                "live_peak_bytes": self.live_peak_bytes}

    # -- the mode ----------------------------------------------------------------
    def __exit__(self, *exc):
        for fin in self._storages.values():
            fin.detach()
        self._storages.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if not getattr(self._local, "depth", 0):
            count = flop_registry.get(packet)
            if count is not None:
                self.aten_flops += int(count(*args, **kwargs, out_val=out))
            if not func.is_view and packet not in _NO_BYTES:
                self.aten_bytes += sum(
                    nbytes(t) for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        if t.layout != torch.strided:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        size = storage.nbytes()
        self._storages[key] = weakref.finalize(storage, self._free, key, size)
        self.live_bytes += size
        self.live_peak_bytes = max(self.live_peak_bytes, self.live_bytes)

    def _free(self, key: int, size: int) -> None:
        self._storages.pop(key, None)
        self.live_bytes -= size


class _Hidden:
    def __init__(self, local):
        self._local = local

    def __enter__(self):
        self._local.depth = getattr(self._local, "depth", 0) + 1

    def __exit__(self, *exc):
        self._local.depth -= 1


def active() -> StepCounter | None:
    """The innermost active ``StepCounter``, or None (the common case,
    one call into the dispatcher)."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepCounter):
            return mode
    return None


def report_collective(op: str, result_bytes: int, group: int) -> None:
    """Record one exchange on the active counter, if any."""
    c = active()
    if c is not None:
        c.collective(op, result_bytes, group)
