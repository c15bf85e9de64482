"""RMA window analogue: persistent, reusable device receive buffers.

Port of ``repro.core.window``.  The paper caches the ``MPI_Win`` between
iterations and only recreates it when ``total_recv_bytes`` changes.  Here a
window slot is one long-lived device tensor holding every virtual rank's
receive rows, ``[P * recv_rows, *F]``; each epoch's unpack stores the valid
rows straight into it, in place, so stale padding bytes persist across
epochs exactly like uninitialized window memory does in real RMA, and an
epoch allocates no output.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

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

    def get(self, rows: int, feature_shape: tuple[int, ...], dtype) -> Window:
        key = (rows, tuple(feature_shape), dtype_name(dtype))
        win = self._windows.get(key)
        if win is not None:
            self.hits += 1
            return win
        self.recreates += 1
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
