"""Wire codecs: payload encodings for persistent alltoallv exchanges (port of
``repro.parallel.wirecodec``).

A codec maps the send payload ``[rows, *F] dtype`` to a wire payload
``[rows, *F] wire_dtype`` plus an optional per-row float32 scale side
channel ``[rows, 1]``; both ride the *same* variant exchange body (pack /
fence / lock / hierarchy only move rows, so correctness is codec-agnostic),
and decode follows the unpack.  Encode and decode are plain tensor ops: the
JAX package has no Pallas kernel for them.

Lossy codecs are strictly opt-in: INIT callers declare an error tolerance
(worst-case per-element error relative to the row's max magnitude) and
only codecs whose declared bound fits are eligible.  With no tolerance
declared, ``identity`` is the only legal codec.

    codec      wire bits  scales   declared rel. error bound
    identity   32 (=in)   no       0
    bf16       16         no       2^-8      (bfloat16 roundoff)
    int8       8          yes      0.5/127   (per-row symmetric quant step)
    fp8        8          yes      2^-4      (e4m3 roundoff, scaled rows)

``inline_rows`` / ``split_rows`` carry the float32 scale inside extra
wire-dtype lanes of each row (``Tensor.view(dtype)`` bitcasts), so one
exchange moves payload and scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

_TINY = 1e-30  # keeps all-zero rows from dividing by zero


def _row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-row max magnitude over all trailing dims -> [rows, 1] float32."""
    r = x.shape[0]
    return x.float().reshape(r, -1).abs().amax(dim=1).reshape(r, 1)


def _bcast(scales: torch.Tensor, ndim: int) -> torch.Tensor:
    """[rows, 1] scales broadcast-shaped against a [rows, *F] payload."""
    return scales.reshape((scales.shape[0],) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One payload encoding.  ``encode`` returns ``(wire, scales)`` where
    ``scales`` is a ``[rows, 1] float32`` side channel or None; ``decode``
    inverts it back to ``out_dtype``.  ``rel_error`` is the declared
    worst-case per-element error relative to the row max, the quantity a
    caller's ``error_tol`` gates on."""

    name: str
    wire_bits: int
    lossy: bool
    rel_error: float
    has_scales: bool
    _encode: Callable
    _decode: Callable
    # Concrete wire element type (None for identity: the input dtype IS the
    # wire dtype).  Callers that move pre-encoded wire rows through a plain
    # byte-moving exchange (the fused MoE path) size buffers off this.
    wire_dtype: Optional[Any] = None

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._encode(x)

    def decode(self, wire: torch.Tensor, scales: Optional[torch.Tensor],
               out_dtype) -> torch.Tensor:
        return self._decode(wire, scales, out_dtype)

    @property
    def ratio(self) -> float:
        """Nominal payload shrink factor vs float32 (scales excluded)."""
        return 32.0 / self.wire_bits

    @property
    def scale_lanes(self) -> int:
        """Extra wire-dtype lanes one inlined float32 row scale occupies
        (0 for unscaled codecs)."""
        if not self.has_scales or self.wire_dtype is None:
            return 0
        return 4 // self.wire_dtype.itemsize


# ---------------------------------------------------------------------------
# Codec implementations
# ---------------------------------------------------------------------------


def _identity_enc(x):
    return x, None


def _identity_dec(wire, scales, out_dtype):
    return wire if wire.dtype == out_dtype else wire.to(out_dtype)


def _bf16_enc(x):
    return x.to(torch.bfloat16), None


def _bf16_dec(wire, scales, out_dtype):
    return wire.to(out_dtype)


def _int8_enc(x):
    step = _row_absmax(x).clamp(min=_TINY) / 127.0
    q = torch.round(x.float() / _bcast(step, x.dim())).clamp(-127.0, 127.0)
    return q.to(torch.int8), step


def _scaled_dec(wire, scales, out_dtype):
    return (wire.float() * _bcast(scales, wire.dim())).to(out_dtype)


_FP8_MAX = 448.0  # float8_e4m3fn dynamic-range ceiling


def _fp8_enc(x):
    scale = _row_absmax(x).clamp(min=_TINY) / _FP8_MAX
    wire = (x.float() / _bcast(scale, x.dim())).to(torch.float8_e4m3fn)
    return wire, scale


# ---------------------------------------------------------------------------
# Scale inlining: ride the per-row float32 scale inside the payload rows
# ---------------------------------------------------------------------------


def inline_lanes(wire: torch.Tensor, scales: Optional[torch.Tensor]) -> int:
    """Trailing wire-dtype lanes one float32 row scale occupies when
    inlined, or 0 when inlining does not apply (no scale channel, a payload
    that is not 2-D, or a wire itemsize not dividing the scale's)."""
    if scales is None or wire.dim() != 2:
        return 0
    k, rem = divmod(scales.element_size(), wire.element_size())
    return k if rem == 0 else 0


def inline_rows(wire: torch.Tensor, scales: torch.Tensor, k: int) -> torch.Tensor:
    """[rows, d] wire + [rows, 1] scales -> [rows, d+k] wire."""
    sb = scales.contiguous().view(wire.dtype).reshape(wire.shape[0], k)
    return torch.cat([wire, sb], dim=1)


def split_rows(packed: torch.Tensor, k: int,
               scale_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert ``inline_rows``: [rows, d+k] -> ([rows, d], [rows, 1])."""
    scales = packed[:, -k:].contiguous().view(scale_dtype)
    return packed[:, :-k], scales.reshape(packed.shape[0], 1)


IDENTITY = "identity"

CODECS: dict[str, WireCodec] = {
    "identity": WireCodec("identity", 32, False, 0.0, False,
                          _identity_enc, _identity_dec),
    "bf16": WireCodec("bf16", 16, True, 2.0 ** -8, False,
                      _bf16_enc, _bf16_dec, wire_dtype=torch.bfloat16),
    "int8": WireCodec("int8", 8, True, 0.5 / 127.0, True,
                      _int8_enc, _scaled_dec, wire_dtype=torch.int8),
    "fp8": WireCodec("fp8", 8, True, 2.0 ** -4, True,
                     _fp8_enc, _scaled_dec, wire_dtype=torch.float8_e4m3fn),
}


def get(name: str) -> WireCodec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {name!r}; have {sorted(CODECS)}") from None


def require(name: str, error_tol: Optional[float]) -> WireCodec:
    """Resolve a codec by name, enforcing the lossy opt-in contract: a
    lossy codec needs a declared ``error_tol`` covering its rel. error
    bound.  The single gate every codec entry point shares."""
    c = get(name)
    if c.lossy and (error_tol is None or c.rel_error > float(error_tol)):
        raise ValueError(
            f"codec {name!r} is lossy (declared rel. error "
            f"{c.rel_error:g}); pass error_tol >= that bound to opt in "
            f"(got {error_tol!r}) — lossy wire compression is never "
            f"enabled silently")
    return c


def allowed(error_tol: Optional[float]) -> Tuple[str, ...]:
    """Codec names eligible under a declared tolerance, cheapest wire first.
    ``identity`` is always eligible; ``error_tol=None`` admits it alone."""
    names = ["identity"]
    if error_tol is not None:
        tol = float(error_tol)
        if tol < 0:
            raise ValueError(f"error_tol must be >= 0, got {tol}")
        names += [c.name for c in CODECS.values()
                  if c.lossy and c.rel_error <= tol]
    return tuple(sorted(names, key=lambda n: (CODECS[n].wire_bits, n)))
