"""Feed-forward blocks (port of ``repro.models.mlp``): SwiGLU (the llama
family), squared-ReLU (nemotron-4) and GELU (whisper).

The parameter names, layouts and inits are the JAX package's: ``w_gate``
and ``w_up`` (SwiGLU) or ``w_in`` ``[D, F]``, and ``w_down`` ``[F, D]``.
The products are plain ``torch.matmul``, as the JAX package leaves them to
XLA outside any Pallas kernel, in the promoted dtype of input and weight
(JAX's promotion: Whisper's float32 encoder runs its bf16 weights in
float32).  On one card nothing
is sharded, so the JAX package's sharding hints on the hidden and output
activations are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import ScopedFactory, normal_init


def init_mlp(f: ScopedFactory, activation: str, d_model: int, d_ff: int) -> None:
    std_in = d_model ** -0.5
    std_out = d_ff ** -0.5
    if activation == "swiglu":
        f.param("w_gate", (d_model, d_ff), ("embed", "ff"), normal_init(std_in))
        f.param("w_up", (d_model, d_ff), ("embed", "ff"), normal_init(std_in))
    else:
        f.param("w_in", (d_model, d_ff), ("embed", "ff"), normal_init(std_in))
    f.param("w_down", (d_ff, d_model), ("ff", "embed"), normal_init(std_out))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``."""
    if x.dtype == w.dtype:
        return x @ w
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def apply_mlp(params: dict, activation: str, x: torch.Tensor) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(_mm(x, params["w_gate"])) * _mm(x, params["w_up"])
    elif activation == "squared_relu":
        h = torch.square(F.relu(_mm(x, params["w_in"])))
    elif activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(_mm(x, params["w_in"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return _mm(h, params["w_down"])
