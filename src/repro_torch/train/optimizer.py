"""Hand-rolled AdamW with mixed precision and ZeRO-1-style state specs
(port of ``repro.train.optimizer``).

Params may live in bf16; the optimizer keeps fp32 master weights plus fp32
(m, v).  The update is the JAX package's, in its order: decoupled weight
decay inside the step, on the fp32 master copy,
``master - lr * (mhat / (sqrt(vhat) + eps) + wd * master)``.
``torch.optim.AdamW`` scales the parameter before the step instead, which
differs in the last bits, so it is not used.

ZeRO-1: ``zero1_pspec`` and ``opt_state_shardings`` compute the partition
specs the JAX package places optimizer state with (the first even-dividing,
not yet model-sharded dim additionally over the data axes).  On one card,
where every virtual rank shares one allocation, they are metadata and
place nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from .._tree import leaves, tree_map
from ..parallel.sharding import axis_rules, active_rules, resolve


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_weights: bool = True   # keep fp32 master copy for bf16 params


def init_opt_state(params, cfg: AdamWConfig, grad_err: bool = False) -> dict:
    """``grad_err=True`` adds the error-feedback residual tree for the
    compressed gradient sync (``train.grad.compressed_sync``); living in
    the optimizer state, it rides the checkpoint and restore paths."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    state = {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_weights:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    if grad_err:
        state["grad_err"] = tree_map(zeros32, params)
    return state


def _leaf_update(g, m, v, base, lr, b1c, b2c, cfg: AdamWConfig):
    g32 = g.float()
    m_new = cfg.b1 * m + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mhat = m_new / b1c
    vhat = v_new / b2c
    step = lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base)
    return m_new, v_new, base - step


def adamw_update(grads, state: dict, params, lr, cfg: AdamWConfig):
    """One AdamW step, all math in fp32, written into ``params`` and
    ``state`` leaf by leaf as soon as each leaf's results are computed, so
    only one leaf's temporaries are ever live (the stand-in for JAX's
    buffer donation).  Returns (params, state), the same objects; JAX's
    returns new trees with the same values."""
    count = state["count"] + 1
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    lr = torch.as_tensor(lr, dtype=torch.float32)
    masters = leaves(state["master"]) if "master" in state else None
    with torch.no_grad():
        for i, (g, m, v, p) in enumerate(zip(
                leaves(grads), leaves(state["m"]), leaves(state["v"]),
                leaves(params))):
            base = masters[i] if masters is not None else p.float()
            m_new, v_new, master_new = _leaf_update(g, m, v, base, lr, b1c,
                                                    b2c, cfg)
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(master_new)
            if masters is not None:
                base.copy_(master_new)
        state["count"].copy_(count)
    return params, state


# ---------------------------------------------------------------------------
# ZeRO-1 specs of optimizer state (metadata on one card)
# ---------------------------------------------------------------------------


def zero1_pspec(logical_axes: tuple, shape: tuple, mesh,
                dp_axes: tuple[str, ...] = ("data",)) -> tuple:
    """Param's resolved spec, with the first even-dividing, currently
    unsharded dim additionally over ``dp_axes``.  Resolve under
    ``axis_rules(rules, mesh)``."""
    base = resolve(logical_axes, shape)
    parts = list(base) + [None] * (len(shape) - len(base))
    dp = tuple(a for a in dp_axes
               if a in mesh.axis_names and int(mesh.shape[a]) > 1)
    if not dp:
        return base
    dp_total = 1
    for a in dp:
        dp_total *= int(mesh.shape[a])
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % dp_total == 0 and dim >= dp_total:
            parts[i] = dp if len(dp) > 1 else dp[0]
            break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def opt_state_shardings(logical_specs, params, mesh, cfg: AdamWConfig,
                        zero1: bool = True, dp_axes=("data",),
                        grad_err: bool = False) -> dict:
    """Spec tree matching ``init_opt_state``'s structure (``repro``'s
    ``NamedSharding`` tree, as spec tuples)."""
    with axis_rules(active_rules(), mesh):
        def leaf_spec(axes, p):
            if zero1:
                return zero1_pspec(axes, tuple(p.shape), mesh, dp_axes)
            return resolve(axes)

        per_param = _map_specs(leaf_spec, logical_specs, params)
        out = {"m": per_param, "v": per_param, "count": ()}
        if cfg.master_weights:
            out["master"] = per_param
        if grad_err:
            # The EF residual stays DP-replicated (TP-only specs).
            out["grad_err"] = _map_specs(
                lambda axes, p: resolve(axes, tuple(p.shape)),
                logical_specs, params)
    return out


def _map_specs(fn, specs, params):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, params[k]) for k, v in specs.items()}
    return fn(specs, params)
