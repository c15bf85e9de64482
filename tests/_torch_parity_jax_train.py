"""Reference outputs of the JAX package for the port's training tests.

    PYTHONPATH=src python tests/_torch_parity_jax_train.py OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz`` that
``tests/test_torch_train_parity.py`` reads:

  train/*   ``get_reduced("olmoe-1b-7b", n_layers=2)`` on a (1, 4) mesh
            ("data", "model"): the initial params and optimizer state, the
            first batch, the first step's loss, metrics and gradients
            (``model_loss`` under ``jax.value_and_grad``, remat on), and the
            losses of ``N_STEPS`` steps of the train bundle.  ``BATCH x SEQ``
            tokens split over the 4 EP ranks with no padding, so ``_route``
            agrees (ROADMAP.md queue 3).
  moe/*     the reduced OLMoE MoE layer's gradients (router, w_gate, w_up,
            w_down and the input) of ``sum(y * cot) + sum(aux * aux_cot)``
            (``cot`` scaled by 1/tokens: a mean, as the training loss)
            for every entry of ``MOE_GRAD_CASES``, on a (1, 4) mesh.
  vjp/*     the vjp of one identity embedded alltoallv epoch (uniform
            counts), fence and lock, on an 8-rank ("x",) mesh; and of the
            same epoch under the int8 codec (``vjp/int8``: ``CODEC_P``
            ranks, ``CODEC_ROWS`` rows of ``CODEC_F``) on a ("x",) mesh.
  sync/*    ``persistent_rs_sync`` and ``compressed_sync``, with and
            without error feedback, on a (2, 4) ("data", "model") mesh over
            ``sync_tree()``, every leaf replicated (specs ``P()``).
"""

from __future__ import annotations

import json
import os
import sys

N_LAYERS, BATCH, SEQ, N_STEPS, EP = 2, 4, 32, 3, 4
PEAK_LR = 1e-3
# (dispatch, a2a variant, overlap_chunks); capacity factor 1.25 drops
# entries under the reduced config's routing.
MOE_GRAD_CASES = (("persistent_a2a", "fence", 1), ("persistent_a2a", "fence", 2),
                  ("persistent_a2a", "lock", 1),
                  ("nonpersistent_a2a", "fence", 1), ("gspmd", "fence", 1))
MOE_TOKENS = 256
VJP_P, VJP_ROWS, VJP_F = 8, 8, 4
CODEC_P, CODEC_ROWS, CODEC_F = 4, 8, 16


def moe_case_id(case) -> str:
    return "-".join(str(c) for c in case)


def sched_kwargs() -> dict:
    return dict(kind="cosine", peak_lr=PEAK_LR, warmup_steps=1,
                total_steps=N_STEPS, decay_steps=1)


def sync_tree(seed: int = 5):
    """A small gradient tree (odd sizes: the flat buffer is padded) and an
    error-feedback residual of the same structure."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal((37,)).astype(np.float32),
               "d": (rng.standard_normal((3, 5)) * 1e-3).astype(np.float32)}}
    e = {"a": (rng.standard_normal((16, 8)) * 1e-3).astype(np.float32),
         "b": {"c": (rng.standard_normal((37,)) * 1e-3).astype(np.float32),
               "d": (rng.standard_normal((3, 5)) * 1e-6).astype(np.float32)}}
    return g, e


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def run_train(out: dict) -> None:
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

    cfg = get_reduced("olmoe-1b-7b", n_layers=N_LAYERS)
    mesh = make_mesh((1, EP), ("data", "model"))
    shape = ShapeConfig("train_4k", "train", SEQ, BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**sched_kwargs()))
    params, _ = model_api.init_model(jax.random.key(0), cfg)
    opt = init_opt_state(params, bundle.meta["adamw"])
    _flatten(jax.tree.map(np.asarray, params), "train/params/", out)
    _flatten(jax.tree.map(np.asarray, opt), "train/opt/", out)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=1234))
    batches = [data.batch_at(s) for s in range(N_STEPS)]
    out["train/tokens0"] = batches[0]
    moe_plan = bundle.meta["moe_plan"]
    out["train/plan"] = np.asarray([moe_plan.tokens_per_shard,
                                    moe_plan.capacity])

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, moe_plan=moe_plan, remat=True)

    with bundle.trace_context():
        prm = put_tree(params, bundle.meta["param_shardings"])
        (loss, metrics), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                prm, {"tokens": jnp.asarray(batches[0])})
        out["train/loss0"] = np.asarray(loss)
        for k, v in metrics.items():
            out[f"train/metrics0/{k}"] = np.asarray(v)
        _flatten(jax.tree.map(np.asarray, grads), "train/grads/", out)
        st = put_tree(opt, bundle.meta["opt_shardings"])
        losses, gnorms = [], []
        for s in range(N_STEPS):
            prm, st, m = bundle.jitted(prm, st, {"tokens": jnp.asarray(batches[s])},
                                       jnp.int32(s))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out["train/losses"] = np.asarray(losses, np.float32)
    out["train/grad_norms"] = np.asarray(gnorms, np.float32)


def run_moe_grads(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models import moe as moe_mod
    from repro.parallel.sharding import DEFAULT_RULES, ParamFactory, axis_rules

    olmoe = get_reduced("olmoe-1b-7b")
    d = olmoe.d_model
    f = ParamFactory(jax.random.key(3), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), d, olmoe.moe)
    params = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, MOE_TOKENS, d)).astype(np.float32)
    # A mean over the tokens, as the training loss is.
    cot = (rng.standard_normal((1, MOE_TOKENS, d))
           / MOE_TOKENS).astype(np.float32)
    aux_cot = np.asarray([0.5, -0.25], np.float32)
    for k, v in params.items():
        out[f"moe/params/{k}"] = v
    out["moe/x"], out["moe/cot"], out["moe/aux_cot"] = x, cot, aux_cot
    mesh = make_mesh((1, EP), ("data", "model"))
    for case in MOE_GRAD_CASES:
        dispatch, variant, k = case
        mcfg = dataclasses.replace(olmoe.moe, dispatch=dispatch,
                                   a2a_variant=variant, overlap_chunks=k)
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(
                mcfg, MOE_TOKENS, mesh, d_model=d, dtype=jnp.float32)

            def f_(prm, xx):
                y, aux = moe_mod.apply_moe(prm, xx, mcfg, plan)
                return jnp.sum(y * cot) + jnp.sum(aux * aux_cot)

            gp, gx = jax.jit(jax.grad(f_, argnums=(0, 1)))(
                {k2: jnp.asarray(v) for k2, v in params.items()},
                jnp.asarray(x))
        tag = f"moe/{moe_case_id(case)}"
        for k2, v in gp.items():
            out[f"{tag}/d{k2}"] = np.asarray(v)
        out[f"{tag}/dx"] = np.asarray(gx)


def run_vjp(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import alltoallv_init
    from repro.launch.mesh import make_mesh

    mesh = make_mesh((VJP_P,), ("x",))
    counts = np.full((VJP_P, VJP_P), VJP_ROWS, np.int64)
    rng = np.random.default_rng(9)
    n = VJP_P * VJP_P * VJP_ROWS
    x = rng.standard_normal((n, VJP_F)).astype(np.float32)
    cot = rng.standard_normal((n, VJP_F)).astype(np.float32)
    out["vjp/x"], out["vjp/cot"] = x, cot
    for variant in ("fence", "lock"):
        plan = alltoallv_init(counts, (VJP_F,), jnp.float32, mesh, axis="x",
                              variant=variant, embeddable=True)
        assert plan.identity_maps
        fn = shard_map(plan.embed(), mesh=mesh, in_specs=P("x"),
                       out_specs=P("x"), check_vma=False)
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        (gx,) = vjp(jnp.asarray(cot))
        out[f"vjp/{variant}/y"] = np.asarray(y)
        out[f"vjp/{variant}/gx"] = np.asarray(gx)
    mesh = make_mesh((CODEC_P,), ("x",))
    plan = alltoallv_init(np.full((CODEC_P, CODEC_P), CODEC_ROWS, np.int64),
                          (CODEC_F,), jnp.float32, mesh, axis="x",
                          codec="int8", error_tol=0.5 / 127, embeddable=True)
    fn = shard_map(plan.embed(), mesh=mesh, in_specs=P("x"),
                   out_specs=P("x"), check_vma=False)
    n = CODEC_P * CODEC_P * CODEC_ROWS
    x = rng.standard_normal((n, CODEC_F)).astype(np.float32)
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (gx,) = vjp(jnp.ones((n, CODEC_F), jnp.float32))
    out["vjp/int8/x"], out["vjp/int8/gx"] = x, np.asarray(gx)


def run_sync(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.train import grad as grad_util

    mesh = make_mesh((2, 4), ("data", "model"))
    g, e = sync_tree()
    specs = jax.tree.map(lambda _: P(), g)
    gj, ej = jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e)
    zeros = jax.tree.map(jnp.zeros_like, gj)
    rs = grad_util.persistent_rs_sync(mesh, specs, ("data",))
    _flatten(jax.tree.map(np.asarray, jax.jit(rs)(gj)), "sync/rs/", out)
    rs_ef = grad_util.persistent_rs_sync(mesh, specs, ("data",),
                                         error_feedback=True)
    comp = grad_util.compressed_sync(mesh, specs, ("data",))
    for tag, fn, err in (("rs_ef", rs_ef, ej), ("comp_ef", comp, ej),
                         ("comp", comp, zeros)):
        synced, new_err = jax.jit(fn)(gj, err)
        _flatten(jax.tree.map(np.asarray, synced), f"sync/{tag}/g/", out)
        _flatten(jax.tree.map(np.asarray, new_err), f"sync/{tag}/err/", out)


def main(argv) -> None:
    path = argv[1]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    for run in (run_vjp, run_sync, run_moe_grads, run_train):
        run(out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
