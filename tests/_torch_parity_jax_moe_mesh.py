"""Reference outputs of the JAX package for the port's MoE layer on meshes
with a data axis > 1 and with hierarchical EP.

    PYTHONPATH=src python tests/_torch_parity_jax_moe_mesh.py OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz`` that
``tests/test_torch_moe_mesh.py`` reads:

  layer/*  the reduced OLMoE-1B-7B's MoE layer (``get_reduced``: d_model
           128, 8 experts, top-2, d_expert 64, capacity factor 1.25) on
           ``LAYER_SHAPE`` seeded tokens, for every entry of
           ``LAYER_CASES``: the output, the aux losses and the gradients
           (router, w_gate, w_up, w_down and the input) of ``sum(y * cot) +
           sum(aux * aux_cot)``, and the plan's geometry.  Every data
           shard's tokens fill its EP ranks' ``t_loc`` exactly, so ``_route``
           agrees (ROADMAP.md queue 3).  ``fence_hierarchy`` runs with the
           JAX bundle's default ``pack_impl="jnp"`` (the interpreted K5 does
           not finish on these meshes).
  train/*  ``examples/train_moe_ep.py``'s setup on ``(2, 4)`` ("data",
           "model"): ``get_reduced("olmoe-1b-7b")``, seq 256, batch 8, the
           ``wsd`` schedule it builds for ``N_STEPS`` steps: the initial
           params and optimizer state, the plan geometry and the losses and
           gradient norms of ``N_STEPS`` steps of the train bundle on
           ``SyntheticTokens`` batches.
  hier_vjp/*  ``jax.vjp`` of the embedded ``fence_hierarchy`` epoch
           (``pack_impl="jnp"``) on a ragged pattern (``hier_vjp_counts``)
           over ``(2, 4)`` ("o", "i"): the send buffer, the cotangent, the
           output and the send buffer's gradient.

The case lists are plain data, so the test module parametrizes over them
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

# name -> (shape, axis names, rule profile)
MESHES = {"2x4": ((2, 4), ("data", "model"), "default"),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), "hier_ep"),
          "2x1x4": ((2, 1, 4), ("pod", "data", "model"), "hier_ep")}
# (mesh, a2a variant, overlap_chunks)
LAYER_CASES = (("2x4", "fence", 1), ("2x4", "fence", 2), ("2x4", "lock", 1),
               ("2x2x2", "fence", 1), ("2x2x2", "fence_hierarchy", 1),
               ("2x2x2", "fence_hierarchy", 2),
               ("2x1x4", "fence", 1), ("2x1x4", "fence_hierarchy", 1))
LAYER_SHAPE = (2, 256)          # [B, S] tokens: 512, 64 per EP rank
SEQ, BATCH, N_STEPS = 256, 8, 3


def case_id(case) -> str:
    return "-".join(str(c) for c in case)


def sched_kwargs(n_steps: int = N_STEPS) -> dict:
    """The schedule ``examples/train_moe_ep.py`` builds for ``n_steps``."""
    return dict(kind="wsd", peak_lr=3e-3, warmup_steps=6,
                total_steps=n_steps, decay_steps=n_steps // 5)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def run_layer(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models import moe as moe_mod
    from repro.parallel.sharding import (RULE_PROFILES, ParamFactory,
                                         axis_rules, batch_ways)

    olmoe = get_reduced("olmoe-1b-7b")
    d = olmoe.d_model
    f = ParamFactory(jax.random.key(3), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), d, olmoe.moe)
    params = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    rng = np.random.default_rng(11)
    b, s = LAYER_SHAPE
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cot = (rng.standard_normal((b, s, d)) / (b * s)).astype(np.float32)
    aux_cot = np.asarray([0.5, -0.25], np.float32)
    for k, v in params.items():
        out[f"layer/params/{k}"] = v
    out["layer/x"], out["layer/cot"], out["layer/aux_cot"] = x, cot, aux_cot
    for case in LAYER_CASES:
        name, variant, k = case
        shape, axes, rules = MESHES[name]
        mesh = make_mesh(shape, axes)
        mcfg = dataclasses.replace(olmoe.moe, a2a_variant=variant,
                                   overlap_chunks=k)
        with axis_rules(RULE_PROFILES[rules], mesh):
            n = b * s // batch_ways(b * s, mesh)
            plan = moe_mod.MoEDispatchPlan.build(mcfg, n, mesh, d_model=d,
                                                 dtype=jnp.float32)

            def f_(prm, xx):
                y, aux = moe_mod.apply_moe(prm, xx, mcfg, plan)
                return jnp.sum(y * cot) + jnp.sum(aux * aux_cot), (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(
                jax.value_and_grad(f_, argnums=(0, 1), has_aux=True))(
                    {k2: jnp.asarray(v) for k2, v in params.items()},
                    jnp.asarray(x))
        tag = f"layer/{case_id(case)}"
        out[f"{tag}/y"], out[f"{tag}/aux"] = np.asarray(y), np.asarray(aux)
        for k2, v in gp.items():
            out[f"{tag}/d{k2}"] = np.asarray(v)
        out[f"{tag}/dx"] = np.asarray(gx)
        out[f"{tag}/plan"] = np.asarray(
            [plan.ep_size, plan.tokens_per_shard, plan.capacity,
             plan.overlap_chunks])
        out[f"{tag}/variant"] = np.asarray(plan.variant)


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

    cfg = get_reduced("olmoe-1b-7b")
    mesh = make_mesh(*MESHES["2x4"][:2])
    shape = ShapeConfig("moe_ep", "train", SEQ, BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**sched_kwargs()))
    params, _ = model_api.init_model(jax.random.key(0), cfg)
    opt = init_opt_state(params, bundle.meta["adamw"])
    _flatten(jax.tree.map(np.asarray, params), "train/params/", out)
    _flatten(jax.tree.map(np.asarray, opt), "train/opt/", out)
    plan = bundle.meta["moe_plan"]
    out["train/plan"] = np.asarray([plan.ep_size, plan.tokens_per_shard,
                                    plan.capacity])
    data = SyntheticTokens(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=1234))
    with bundle.trace_context():
        prm = put_tree(params, bundle.meta["param_shardings"])
        st = put_tree(opt, bundle.meta["opt_shardings"])
        losses, gnorms = [], []
        for step in range(N_STEPS):
            prm, st, m = bundle.jitted(
                prm, st, {"tokens": jnp.asarray(data.batch_at(step))},
                jnp.int32(step))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out["train/losses"] = np.asarray(losses, np.float32)
    out["train/grad_norms"] = np.asarray(gnorms, np.float32)


def hier_vjp_counts():
    """A ragged ``[8, 8]`` pattern with zeros (numpy only)."""
    import numpy as np
    return np.random.default_rng(3).integers(0, 9, (8, 8))


def run_hier_vjp(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import PlanCache, alltoallv_init
    from repro.launch.mesh import make_mesh

    mesh = make_mesh((2, 4), ("o", "i"))
    plan = alltoallv_init(hier_vjp_counts(), (4,), jnp.float32, mesh,
                          axis=("o", "i"), variant="fence_hierarchy",
                          embeddable=True, cache=PlanCache(), store=False)
    fn = shard_map(plan.embed(), mesh=mesh, in_specs=P(("o", "i")),
                   out_specs=P(("o", "i")), check_vma=False)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8 * plan.send_rows, 4)).astype(np.float32)
    cot = rng.standard_normal((8 * plan.recv_rows, 4)).astype(np.float32)

    def vjp(xx, cc):
        y, f = jax.vjp(fn, xx)
        return y, f(cc)[0]

    y, gx = jax.jit(vjp)(jnp.asarray(x), jnp.asarray(cot))
    out["hier_vjp/x"], out["hier_vjp/cot"] = x, cot
    out["hier_vjp/y"], out["hier_vjp/gx"] = np.asarray(y), np.asarray(gx)


def main(argv) -> None:
    path = argv[1]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    for run in (run_layer, run_train, run_hier_vjp):
        run(out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
