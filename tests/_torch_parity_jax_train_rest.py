"""Reference outputs of the JAX package for the rest of the port's training
path: the backward of every embedded epoch, the MoE layer under the wire
codecs, and training under a codec.

    PYTHONPATH=src python tests/_torch_parity_jax_train_rest.py OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz`` that
``tests/test_torch_train_rest.py`` reads:

  vjp/<case>/*    for every case of ``VJP_CASES``: the send buffer ``x``,
                  the cotangent ``cot``, and ``jax.vjp`` of the plan's
                  ``embed()`` under ``shard_map``: ``y`` and ``gx``.
  raise/<case>    for every case of ``RAISE_CASES``, the message of the
                  ``NotImplementedError`` that ``jax.vjp`` raises (traced
                  with ``jax.eval_shape``: the interpreted Pallas kernels
                  never run).
  moe/*           the reduced OLMoE MoE layer on a (1, 4) mesh, fence,
                  ``persistent_a2a``: the gradients of ``sum(y * cot) +
                  sum(aux * aux_cot)`` under every codec of ``MOE_CODECS``.
                  ``fp8_fixed`` is fp8 with the reference's faulty step
                  written correctly (``fixed_fp8_encode``).
  train/*         ``get_reduced("olmoe-1b-7b", n_layers=2)`` with
                  ``wire_codec="bf16"`` on (1, 4): the initial params and
                  optimizer state, and the losses and gradient norms of
                  ``N_STEPS`` steps of the train bundle.

The case lists are plain data, so the test module parametrizes over them
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

VJP_F = 8
CODEC_TOL = 0.1
# (collective, variant, pack_impl, codec, mesh shape, lock schedule)
VJP_CASES = (
    ("alltoallv", "fence", "jnp", "identity", (4,), "ring"),
    ("alltoallv", "lock", "jnp", "identity", (4,), "ring"),
    ("alltoallv", "lock", "jnp", "identity", (4,), "pairwise"),
    ("alltoallv", "fence_hierarchy", "jnp", "identity", (2, 4), "ring"),
    ("alltoallv", "fence_hierarchy", "pallas", "identity", (2, 4), "ring"),
    ("alltoallv", "fence", "jnp", "bf16", (4,), "ring"),
    ("alltoallv", "fence", "jnp", "int8", (4,), "ring"),
    ("alltoallv", "fence", "jnp", "fp8", (4,), "ring"),
    ("alltoallv", "lock", "jnp", "int8", (4,), "ring"),
    ("alltoallv", "fence_hierarchy", "jnp", "int8", (2, 4), "ring"),
    ("alltoallv", "fence_hierarchy", "pallas", "bf16", (2, 4), "ring"),
    ("allgatherv", "fence", "jnp", "identity", (4,), "ring"),
    ("allgatherv", "lock", "jnp", "identity", (4,), "ring"),
    ("allgatherv", "fence_hierarchy", "jnp", "identity", (2, 4), "ring"),
    ("reduce_scatter", "fence", "jnp", "identity", (4,), "ring"),
    ("reduce_scatter", "lock", "jnp", "identity", (4,), "ring"),
)
# Bodies whose Pallas kernels have no transpose: (variant, pack_impl, mesh).
RAISE_CASES = (("fence", "pallas", (4,)), ("fence", "fused", (4,)),
               ("fence_hierarchy", "fused", (2, 4)))

MOE_EP, MOE_TOKENS = 4, 64
# The cotangent's scale (a loss scale): large enough that fp8 cotangents
# of the wire rows do not all underflow (at 1/MOE_TOKENS every expert
# weight's fp8 gradient is zero).
MOE_COT_SCALE = 64.0
MOE_CODECS = ("bf16", "int8", "fp8", "fp8_fixed")
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, N_STEPS = 2, 4, 32, 2
PEAK_LR = 1e-3


def case_id(case) -> str:
    return "-".join(str(c) if not isinstance(c, tuple)
                    else "x".join(map(str, c)) for c in case)


def counts_of(collective: str, p: int):
    """The case's counts: a random ``[P, P]`` matrix with zeros, or a ``[P]``
    vector with a zero, for the pattern families."""
    import numpy as np
    rng = np.random.default_rng(11 + p)
    if collective == "alltoallv":
        return rng.integers(0, 9, (p, p))
    c = rng.integers(1, 12, p)
    c[1] = 0
    return c


def sched_kwargs() -> dict:
    return dict(kind="cosine", peak_lr=PEAK_LR, warmup_steps=1,
                total_steps=N_STEPS, decay_steps=1)


def fixed_fp8_encode(x):
    """The JAX package's fp8 encode with its faulty step written correctly.

    ``repro.parallel.wirecodec._fp8_enc`` clamps an all-zero row's scale
    with ``jnp.maximum(absmax, _TINY)``.  The division by that tiny scale
    has a cotangent ``-g * x * scale**-2``, and ``scale**-2`` overflows to
    inf, so the row's scale cotangent is ``0 * inf = NaN``; the maximum's
    derivative multiplies it by 0 where a select would drop it, and the NaN
    reaches the expert weights.  Here the clamp is a ``where``, whose
    transpose selects: the same forward values, a finite gradient."""
    import jax.numpy as jnp
    from repro.parallel import wirecodec as wc
    a = wc._row_absmax(x)
    scale = jnp.where(a > wc._TINY, a, wc._TINY) / wc._FP8_MAX
    wire = (x.astype(jnp.float32) / wc._bcast(scale, x.ndim)).astype(
        jnp.float8_e4m3fn)
    return wire, scale.astype(jnp.float32)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def _mesh(shape):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    names = ("x",) if len(shape) == 1 else ("o", "i")
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names), names


def _plan(collective, variant, impl, codec, shape, schedule):
    import numpy as np
    from repro.core import (PlanCache, allgatherv_init, alltoallv_init,
                            reduce_scatter_init)
    mesh, names = _mesh(shape)
    axis = names[0] if len(names) == 1 else names
    p = int(np.prod(shape))
    kw = dict(axis=axis, variant=variant, cache=PlanCache(), store=False)
    if collective == "alltoallv":
        plan = alltoallv_init(counts_of(collective, p), (VJP_F,), "float32",
                              mesh, pack_impl=impl, lock_schedule=schedule,
                              codec=codec, embeddable=True,
                              error_tol=None if codec == "identity"
                              else CODEC_TOL, **kw)
    else:
        init = (allgatherv_init if collective == "allgatherv"
                else reduce_scatter_init)
        plan = init(counts_of(collective, p), (VJP_F,), "float32", mesh, **kw)
    return plan, mesh, names


def _embedded(plan, mesh, names):
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    spec = P(names[0] if len(names) == 1 else names)
    return shard_map(plan.embed(), mesh=mesh, in_specs=spec, out_specs=spec,
                     check_vma=False)


def run_vjp(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    for k, case in enumerate(VJP_CASES):
        plan, mesh, names = _plan(*case)
        fn = _embedded(plan, mesh, names)
        rng = np.random.default_rng(100 + k)
        x = rng.standard_normal((plan.p * plan.send_rows, VJP_F)).astype(
            np.float32)
        cot = rng.standard_normal((plan.p * plan.recv_rows, VJP_F)).astype(
            np.float32)

        def vjp(xx, cc):
            y, f = jax.vjp(fn, xx)
            return y, f(cc)[0]

        y, gx = jax.jit(vjp)(jnp.asarray(x), jnp.asarray(cot))
        tag = f"vjp/{case_id(case)}"
        out[f"{tag}/x"], out[f"{tag}/cot"] = x, cot
        out[f"{tag}/y"], out[f"{tag}/gx"] = np.asarray(y), np.asarray(gx)


def run_raises(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    for case in RAISE_CASES:
        variant, impl, shape = case
        plan, mesh, names = _plan("alltoallv", variant, impl, "identity",
                                  shape, "ring")
        fn = _embedded(plan, mesh, names)
        x = jax.ShapeDtypeStruct((plan.p * plan.send_rows, VJP_F),
                                 jnp.float32)
        c = jax.ShapeDtypeStruct((plan.p * plan.recv_rows, VJP_F),
                                 jnp.float32)
        try:
            jax.eval_shape(lambda xx, cc: jax.vjp(fn, xx)[1](cc), x, c)
            msg = "no error"
        except NotImplementedError as e:
            msg = f"NotImplementedError: {e}"
        out[f"raise/{case_id(case)}"] = np.array(msg)


def run_moe(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models import moe as moe_mod
    from repro.parallel import wirecodec
    from repro.parallel.sharding import DEFAULT_RULES, ParamFactory, axis_rules

    olmoe = get_reduced("olmoe-1b-7b")
    d = olmoe.d_model
    f = ParamFactory(jax.random.key(3), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), d, olmoe.moe)
    params = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, MOE_TOKENS, d)).astype(np.float32)
    cot = (rng.standard_normal((1, MOE_TOKENS, d))
           * MOE_COT_SCALE).astype(np.float32)
    aux_cot = np.asarray([0.5, -0.25], np.float32)
    for k, v in params.items():
        out[f"moe/params/{k}"] = v
    out["moe/x"], out["moe/cot"], out["moe/aux_cot"] = x, cot, aux_cot
    mesh = make_mesh((1, MOE_EP), ("data", "model"))
    faulty = wirecodec.CODECS["fp8"]
    for name in MOE_CODECS:
        codec = "fp8" if name == "fp8_fixed" else name
        if name == "fp8_fixed":
            wirecodec.CODECS["fp8"] = dataclasses.replace(
                faulty, _encode=fixed_fp8_encode)
        mcfg = dataclasses.replace(olmoe.moe, dispatch="persistent_a2a",
                                   a2a_variant="fence", wire_codec=codec,
                                   codec_tol=CODEC_TOL)
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(
                mcfg, MOE_TOKENS, mesh, d_model=d, dtype=jnp.float32)

            def f_(prm, xx):
                y, aux = moe_mod.apply_moe(prm, xx, mcfg, plan)
                return jnp.sum(y * cot) + jnp.sum(aux * aux_cot), y

            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                f_, argnums=(0, 1), has_aux=True))(
                    {k2: jnp.asarray(v) for k2, v in params.items()},
                    jnp.asarray(x))
        wirecodec.CODECS["fp8"] = faulty
        out[f"moe/{name}/y"] = np.asarray(y)
        for k2, v in gp.items():
            out[f"moe/{name}/d{k2}"] = np.asarray(v)
        out[f"moe/{name}/dx"] = np.asarray(gx)


def run_train(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.ckpt.reshard import put_tree
    from repro.configs import get_reduced
    from repro.configs.base import ShapeConfig
    from repro.data.synthetic import DataConfig, SyntheticTokens
    from repro.launch import steps as steps_mod
    from repro.launch.mesh import make_mesh
    from repro.models import api as model_api
    from repro.train import ScheduleConfig, init_opt_state

    cfg = get_reduced("olmoe-1b-7b", n_layers=TRAIN_LAYERS)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_codec="bf16", codec_tol=CODEC_TOL))
    mesh = make_mesh((1, MOE_EP), ("data", "model"))
    shape = ShapeConfig("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**sched_kwargs()))
    params, _ = model_api.init_model(jax.random.key(0), cfg)
    opt = init_opt_state(params, bundle.meta["adamw"])
    _flatten(jax.tree.map(np.asarray, params), "train/params/", out)
    _flatten(jax.tree.map(np.asarray, opt), "train/opt/", out)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                      seed=1234))
    losses, gnorms = [], []
    with bundle.trace_context():
        prm = put_tree(params, bundle.meta["param_shardings"])
        st = put_tree(opt, bundle.meta["opt_shardings"])
        for s in range(N_STEPS):
            prm, st, m = bundle.jitted(
                prm, st, {"tokens": jnp.asarray(data.batch_at(s))},
                jnp.int32(s))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out["train/losses"] = np.asarray(losses, np.float32)
    out["train/grad_norms"] = np.asarray(gnorms, np.float32)


def main(argv) -> None:
    path = argv[1]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    for run in (run_vjp, run_raises, run_moe, run_train):
        run(out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
