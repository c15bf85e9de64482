"""Reference outputs of the JAX package for the port's MoE and serving tests.

    PYTHONPATH=src python tests/_torch_parity_jax_moe.py {moe|serve} OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz``:

  moe    for every case in ``MOE_CASES``: the MoE parameters and tokens
         (``dist_cases._routed_moe_setup``'s controlled routing) and JAX's
         ``apply_moe`` output and aux losses on a ``(1, P)`` mesh
         ("data", "model"); and ``MoEDispatchPlan.build``'s geometry for
         every entry of ``GEOMETRY``; and for every entry of
         ``CODEC_CASES``, the reduced OLMoE-1B-7B's MoE layer under a wire
         codec (and without one).  ``tests/test_torch_moe.py`` reads it.
  serve  the reduced OLMoE-1B-7B's parameters from
         ``init_model(jax.random.key(0), cfg)``; JAX's prefill bundle's
         last logits and caches on a (1, 8) mesh for every entry of
         ``PREFILL``; and ``ServeEngine``'s greedy tokens on a (1, 1) mesh
         for ``GENERATE``.  ``tests/test_torch_serve.py`` reads it.

The case lists are plain data, so the test modules parametrize over them
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

D_MODEL, TOKENS, N_EXPERTS = 64, 256, 8

# (P, routing pattern, dispatch, a2a variant, overlap_chunks, capacity
# factor).  Capacity factor 16 drops nothing; 1.25 drops under skew, and
# both packages then drop the same entries (no padding: 256 tokens split
# evenly over P ranks).
MOE_CASES = (
    [(p, pat, "persistent_a2a", "fence", 1, 16.0) for p in (4, 8)
     for pat in ("dense", "banded", "skewed")]
    + [(8, "dense", "persistent_a2a", "lock", 1, 16.0),
       (4, "skewed", "persistent_a2a", "lock", 1, 16.0),
       (8, "banded", "nonpersistent_a2a", "fence", 1, 16.0),
       (4, "dense", "nonpersistent_a2a", "lock", 1, 16.0),
       (8, "skewed", "gspmd", "fence", 1, 16.0),
       (4, "banded", "gspmd", "fence", 1, 16.0),
       (8, "dense", "persistent_a2a", "fence", 2, 16.0),
       (4, "banded", "persistent_a2a", "lock", 2, 16.0),
       (8, "skewed", "persistent_a2a", "fence", 1, 1.25),
       (4, "skewed", "persistent_a2a", "fence", 2, 1.25)]
)

# Token count with padding (200 tokens over 8 ranks of t_loc 32): the
# port's persistent output is held against JAX's gspmd dispatch here.
PADDED = (8, "skewed", 200)

# (n_tokens, ep, capacity_factor, top_k, n_experts, overlap_chunks)
GEOMETRY = ((256, 8, 16.0, 2, 8, 1), (200, 8, 1.25, 2, 8, 2),
            (4, 8, 1.25, 8, 64, 1), (512, 8, 1.25, 8, 64, 4),
            (1, 4, 1.0, 1, 8, 8), (1000, 4, 0.5, 2, 8, 3))

# (P, wire codec): the MoE layer of the reduced OLMoE-1B-7B
# (``get_reduced("olmoe-1b-7b")``: d_model 128, 8 experts, top-2, d_expert
# 64, capacity factor 1.25) on CODEC_TOKENS seeded tokens, fence dispatch.
CODEC_CASES = ((8, "int8"), (4, "int8"), (8, "fp8"), (8, "bf16"),
               (8, "identity"))
CODEC_TOKENS, CODEC_TOL = 256, 0.1

# (batch, prompt, capacity_factor); batch * prompt a multiple of 8*8, so no
# EP rank carries padding.  The second drops entries (t_loc 64, cap 8).
PREFILL = ((2, 32, 1.25), (4, 128, 0.5))
# (batch, prompt, new tokens, max_seq), no-drop capacity factor 8.
GENERATE = (2, 16, 4, 24)


def codec_case_id(case) -> str:
    return f"codec-P{case[0]}-{case[1]}"


def moe_case_id(case) -> str:
    p, pat, dispatch, variant, k, cf = case
    return f"P{p}-{pat}-{dispatch}-{variant}-ov{k}-cf{cf:g}"


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def _mesh(p):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:p]).reshape(1, p), ("data", "model"))


def run_moe(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import MoEConfig
    from repro.models import moe as moe_mod
    from repro.parallel.sharding import DEFAULT_RULES, ParamFactory, axis_rules
    from repro.testing.dist_cases import _routed_moe_setup

    base = MoEConfig(n_experts=N_EXPERTS, top_k=2, d_expert=32)
    f = ParamFactory(jax.random.key(0), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), D_MODEL, base)
    params = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    for k, v in params.items():
        out[f"params/{k}"] = v
    inputs = {}
    for pat in ("dense", "banded", "skewed"):
        x, router = _routed_moe_setup(pat, D_MODEL, TOKENS, N_EXPERTS, seed=3)
        inputs[pat] = (x, router)
        out[f"{pat}/x"], out[f"{pat}/router"] = x, router

    def run(p, pat, dispatch, variant, k, cf, x):
        mesh = _mesh(p)
        mcfg = dataclasses.replace(base, dispatch=dispatch, a2a_variant=variant,
                                   overlap_chunks=k, capacity_factor=cf)
        prm = {kk: jnp.asarray(v) for kk, v in params.items()}
        prm["router"] = jnp.asarray(inputs[pat][1])
        t = x.shape[0]
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(
                mcfg, t, mesh, d_model=D_MODEL, dtype=jnp.float32)
            y, aux = jax.jit(lambda xx: moe_mod.apply_moe(prm, xx, mcfg, plan))(
                jnp.asarray(x.reshape(1, t, D_MODEL)))
        return np.asarray(y).reshape(t, D_MODEL), np.asarray(aux)

    for case in MOE_CASES:
        p, pat, dispatch, variant, k, cf = case
        y, aux = run(p, pat, dispatch, variant, k, cf, inputs[pat][0])
        out[f"{moe_case_id(case)}/y"], out[f"{moe_case_id(case)}/aux"] = y, aux
    p, pat, t = PADDED
    y, _ = run(p, pat, "gspmd", "fence", 1, 16.0, inputs[pat][0][:t])
    out["padded/gspmd_y"] = y

    geometry = []
    for n_tokens, ep, cf, top_k, e, k in GEOMETRY:
        mcfg = MoEConfig(n_experts=e, top_k=top_k, d_expert=32,
                         capacity_factor=cf)
        mesh = _mesh(ep)
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(mcfg, n_tokens, mesh,
                                                 plan_backed=False,
                                                 overlap_chunks=k)
        geometry.append([plan.tokens_per_shard, plan.capacity, plan.e_local,
                         plan.overlap_chunks, plan.ep_size])
    out["geometry"] = np.asarray(geometry)

    from repro.configs import get_reduced
    olmoe = get_reduced("olmoe-1b-7b")
    d = olmoe.d_model
    f = ParamFactory(jax.random.key(1), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), d, olmoe.moe)
    cparams = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    for k, v in cparams.items():
        out[f"codec/params/{k}"] = v
    x = np.random.default_rng(11).standard_normal(
        (CODEC_TOKENS, d)).astype(np.float32)
    out["codec/x"] = x
    for case in CODEC_CASES:
        p, codec = case
        mesh = _mesh(p)
        mcfg = dataclasses.replace(
            olmoe.moe, wire_codec=codec,
            codec_tol=None if codec == "identity" else CODEC_TOL)
        prm = {kk: jnp.asarray(v) for kk, v in cparams.items()}
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(
                mcfg, CODEC_TOKENS, mesh, d_model=d, dtype=jnp.float32)
            y, _ = jax.jit(lambda xx: moe_mod.apply_moe(prm, xx, mcfg, plan))(
                jnp.asarray(x.reshape(1, CODEC_TOKENS, d)))
        out[f"{codec_case_id(case)}/y"] = np.asarray(y).reshape(CODEC_TOKENS, d)


def run_serve(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.ckpt.reshard import put_tree
    from repro.configs import get_reduced
    from repro.configs.base import ShapeConfig
    from repro.launch import steps as steps_mod
    from repro.launch.mesh import make_mesh
    from repro.models import api as model_api
    from repro.serve import ServeEngine

    cfg = get_reduced("olmoe-1b-7b")
    params, _ = model_api.init_model(jax.random.key(0), cfg)
    params = jax.tree.map(np.asarray, params)
    _flatten(params, "params/", out)
    rng = np.random.default_rng(0)

    def with_cf(cf):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))

    mesh = make_mesh((1, 8), ("data", "model"))
    for b, s, cf in PREFILL:
        tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        bundle = steps_mod.make_prefill_bundle(
            with_cf(cf), ShapeConfig("p", "prefill", s, b), mesh)
        with bundle.trace_context():
            prm = put_tree(params, bundle.meta["param_shardings"])
            logits, caches = bundle.jitted(prm, jnp.asarray(tokens))
        tag = f"prefill/{b}x{s}"
        out[f"{tag}/tokens"] = tokens
        out[f"{tag}/logits"] = np.asarray(logits)
        out[f"{tag}/k"] = np.asarray(caches[0]["k"])
        out[f"{tag}/v"] = np.asarray(caches[0]["v"])

    b, s, n, max_seq = GENERATE
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    eng = ServeEngine(with_cf(8.0), make_mesh((1, 1), ("data", "model")),
                      batch=b, prompt_len=s, max_seq=max_seq, params=params)
    toks, _ = eng.generate(prompts, n)
    out["generate/prompts"], out["generate/tokens"] = prompts, np.asarray(toks)


def main(argv) -> None:
    mode, path = argv[1], argv[2]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    {"moe": run_moe, "serve": run_serve}[mode](out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
