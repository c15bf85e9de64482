"""Logical-axis rules and parameter creation (port of the parts of
``repro.parallel.sharding`` that the serving slice reads).

The rule profiles map the models' logical axes ("batch", "experts", ...) to
mesh axes exactly as in the JAX package.  On one card nothing is sharded,
so ``cs(...)`` (a sharding hint) is left out; the rules still decide two
things: which mesh axis the MoE layer dispatches over (the ``experts``
rule) and how many ways a batch splits (``batch_ways``, which sizes the MoE
dispatch capacity).  ``ParamFactory`` builds a parameter tree with the JAX
package's keys and layouts, drawing from an explicit ``torch.Generator`` on
an explicit device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

# Physical axes: pod (outer data parallelism), data, model (tensor/expert).
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": ("model",),
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff": None,
    "d_inner": ("model",),
    "state": None,
    "conv": None,
    "frames": None,
    "stack": None,
}

# Decode: the KV cache shards over sequence on the model axis.
DECODE_RULES = dict(DEFAULT_RULES, seq=("model",), seq_sp=None)

# Long context: batch unsharded, sequence over the data axis.
LONG_CONTEXT_RULES = dict(DEFAULT_RULES, batch=None, seq=("data",),
                          seq_sp=None)

# Pure data parallelism: batch over every axis, no tensor parallelism.
PURE_DP_RULES = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    seq_sp=None, heads=None, kv_heads=None, ff=None, vocab=None,
    experts=None, d_inner=None,
)

# Hierarchical expert parallelism: experts over the (pod, model) pair,
# batch over data only.
HIER_EP_RULES = dict(DEFAULT_RULES, experts=("pod", "model"),
                     batch=("data",))

# Launch-profile registry (``--rules`` on the launchers).
RULE_PROFILES: dict[str, dict] = {
    "default": DEFAULT_RULES,
    "long_context": LONG_CONTEXT_RULES,
    "decode": DECODE_RULES,
    "pure_dp": PURE_DP_RULES,
    "hier_ep": HIER_EP_RULES,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(rules: dict, mesh=None):
    old = (_CTX.rules, _CTX.mesh)
    _CTX.rules = dict(rules)
    if mesh is not None:
        _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = old


def current_mesh():
    return _CTX.mesh


def active_rules() -> dict:
    """The logical-axis rule table currently in effect (a copy)."""
    return dict(_CTX.rules)


def rule_axes(logical: str, mesh) -> tuple[str, ...]:
    """Mesh axes of size > 1 that the active rule maps ``logical`` to."""
    if mesh is None:
        return ()
    rule = _CTX.rules.get(logical) or ()
    rule = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in rule
                 if a in mesh.axis_names and int(mesh.shape[a]) > 1)


def resolve(logical_axes: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None) -> tuple:
    """Logical axis names -> a partition spec under the active rules and
    mesh, as ``repro``'s ``resolve`` computes its ``PartitionSpec``: a tuple
    with one entry per leading dim (a mesh axis, a tuple of axes, or None),
    trailing Nones dropped.  Shape-aware: an axis is used only where the
    dim divides evenly.  On one card this is metadata: nothing is placed
    by it (the optimizer's ZeRO-1 specs are the consumer)."""
    mesh = _CTX.mesh
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    out: list = []
    used: set[str] = set()
    for i, ax in enumerate(logical_axes):
        phys = _CTX.rules.get(ax) if ax is not None else None
        if phys is None:
            out.append(None)
            continue
        cand = tuple(a for a in ((phys,) if isinstance(phys, str) else phys)
                     if a in mesh_axes and a not in used
                     and int(mesh.shape[a]) > 1)
        if shape is not None and cand:
            dim, ways, picked = int(shape[i]), 1, []
            for a in cand:
                w = int(mesh.shape[a])
                if dim % (ways * w) == 0:
                    picked.append(a)
                    ways *= w
            cand = tuple(picked)
        used.update(cand)
        out.append(cand if len(cand) > 1 else (cand[0] if cand else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_ways(n: int, mesh=None) -> int:
    """Ways a batch dim of size ``n`` shards under the active rules,
    divisibility-aware (``repro``'s ``resolve`` of ``("batch",)``): the
    single source of truth for MoE capacity sizing."""
    mesh = mesh if mesh is not None else _CTX.mesh
    ways = 1
    for a in rule_axes("batch", mesh):
        w = int(mesh.shape[a])
        if n % (ways * w) == 0:
            ways *= w
    return ways


# ---------------------------------------------------------------------------
# Parameter creation
# ---------------------------------------------------------------------------

Initializer = Callable[[torch.Generator, tuple[int, ...], torch.dtype,
                        torch.device], torch.Tensor]


def normal_init(stddev: float) -> Initializer:
    """Normal draws in float32 from the generator, scaled, then cast."""
    def f(gen, shape, dtype, device):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (t * stddev).to(dtype)
    return f


def zeros_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.zeros(shape, dtype=dtype,
                                                         device=device)


def ones_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.ones(shape, dtype=dtype,
                                                        device=device)


class ParamFactory:
    """Builds a parameter tree (nested dicts) and a parallel tree of the
    logical axes of every parameter, as the JAX package's does.  Draws
    come from ``generator``, which must live on ``device``."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device if device is not None
                                   else generator.device)
        self.params: dict = {}
        self.logical_specs: dict = {}

    def param(self, path: str, shape: Sequence[int],
              logical_axes: Sequence[Optional[str]],
              init: Initializer) -> torch.Tensor:
        """path is '/'-separated, e.g. 'slot0/attn/wq'."""
        assert len(shape) == len(logical_axes), (path, shape, logical_axes)
        arr = init(self.generator, tuple(shape), self.dtype, self.device)
        node, spec_node = self.params, self.logical_specs
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            spec_node = spec_node.setdefault(p, {})
        if parts[-1] in node:
            raise ValueError(f"duplicate param {path}")
        node[parts[-1]] = arr
        spec_node[parts[-1]] = tuple(logical_axes)
        return arr

    def scope(self, prefix: str) -> "ScopedFactory":
        return ScopedFactory(self, prefix)


class ScopedFactory:
    def __init__(self, base: ParamFactory, prefix: str):
        self._base = base
        self._prefix = prefix

    @property
    def dtype(self):
        return self._base.dtype

    def param(self, path, shape, logical_axes, init):
        return self._base.param(f"{self._prefix}/{path}", shape, logical_axes, init)

    def scope(self, prefix: str) -> "ScopedFactory":
        return ScopedFactory(self._base, f"{self._prefix}/{prefix}")
