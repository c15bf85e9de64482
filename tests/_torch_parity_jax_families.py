"""Reference outputs of the JAX package for the port's attention-only
families: the dense FFN and its architectures, shared experts, the flash
attention path, Ulysses and the pod-aware collectives.

    PYTHONPATH=src python tests/_torch_parity_jax_families.py MODE OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz``.  MODE is one of:

  families     for every architecture of ``ARCHS`` at reduced size: its
               parameters from ``init_model(jax.random.key(i), cfg)``, the
               forward's logits on ``TOKENS``, a prefill into caches of
               ``MAX_SEQ`` positions and ``DECODE`` greedy decode steps
               (every step's logits and token), and one training step's
               loss, metrics and gradients (``model_loss`` under
               ``jax.value_and_grad``, remat on), all without a mesh.
               ``tests/test_torch_families.py`` reads it.
  shared       the reduced Moonshot-v1-16B-A3B's MoE layer (2 shared
               experts) for every case of ``SHARED_CASES``: output, aux
               losses and the gradients of every weight and of the input.
               ``tests/test_torch_shared_experts.py`` reads it.
  flash        ``_flash_attention`` and its vjp at ``FLASH`` for every
               position set of ``FLASH_POSITIONS``; ``apply_attention`` at
               ``FLASH_APPLY``'s 4096 keys; and, for every (queries, keys)
               of ``SWITCH``, whether ``apply_attention`` took the flash
               path (traced with ``jax.eval_shape``).
               ``tests/test_torch_flash.py`` reads it.
  ulysses      ``ulysses_attention`` on ``(4,)`` ("model") and, with the
               leader-combined head exchange, on ``(2, 2)`` ("pod",
               "model"), at the shapes of ``dist_cases``' Ulysses cases;
               the vjp on ``(4,)``.  ``tests/test_torch_ulysses.py`` reads
               it.
  collectives  ``hierarchical_psum_mean`` (raw and plan-backed) and
               ``flat_psum_mean`` on ``(2, 4)`` ("pod", "data") for every
               local shape of ``REDUCE_SHAPES``; ``plan_rs_ag_pair``'s
               capacity for every row count of ``PAIR_ROWS``.
               ``tests/test_torch_collectives.py`` reads it.

The case lists are plain data, so the test modules parametrize over them
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

# families: the four dense architectures and Moonshot (MoE with shared
# experts); batch x tokens, cache length, decode steps.
ARCHS = ("olmo-1b", "minicpm-2b", "nemotron-4-15b", "deepseek-67b",
         "moonshot-v1-16b-a3b")
BATCH, TOKENS, MAX_SEQ, DECODE = 2, 16, 24, 3

# shared: (P, dispatch, a2a variant) of the reduced Moonshot MoE layer on a
# (1, P) ("data", "model") mesh over SHARED_TOKENS tokens (no padding).
SHARED_CASES = ((8, "persistent_a2a", "fence"), (4, "persistent_a2a", "lock"),
                (8, "gspmd", "fence"))
SHARED_TOKENS = 256

# flash: q [B, S, N, G, dh] (GQA g = 2), keys of the same length.
FLASH = {"b": 1, "s": 2048, "n": 2, "g": 2, "dh": 16}
# "arange": q and k at 0..S-1.  "offset": queries at -50..S-51 (the first
# 50 rows see no key at all) and keys at (i + 1024) % S, so the first key
# chunk holds positions 1024..2047: every query below 1024 has its first
# chunk fully masked and its keys in the second.
FLASH_POSITIONS = ("arange", "offset")
FLASH_APPLY = {"b": 1, "s": 4096, "d_model": 32, "n_heads": 4, "n_kv": 2,
               "head_dim": 16}
# (queries, keys): apply_attention with a KV cache of ``keys`` positions.
SWITCH = ((1, 4096), (512, 4096), (513, 4096), (4096, 4096), (1024, 4095),
          (1024, 5120), (1536, 8192), (512, 1024), (100, 4096), (2048, 6144))

# ulysses: dist_cases' ulysses_attention_matches_local and
# ulysses_hier_attention.
ULYSSES = {"b": 2, "s": 32, "h": 4, "d": 8}
ULYSSES_MESHES = {"flat": ((4,), ("model",), "model", False),
                  "hier": ((2, 2), ("pod", "model"), ("pod", "model"), True)}

# collectives: each rank's local shape (scatter dim 1 of the first, as
# dist_cases' hierarchical_psum; the second not divisible by 4: the raw path
# falls back to the flat sum, the plan pads) and plan_rs_ag_pair's rows.
REDUCE_SHAPES = ((1, 16, 32), (1, 13, 32))
PAIR_ROWS = (1, 8, 13, 16, 33, 100, 2048)


def position_arrays(kind: str, s: int):
    import numpy as np
    i = np.arange(s, dtype=np.int32)
    if kind == "arange":
        return i[None], i[None]
    return (i - 50)[None], ((i + 1024) % s)[None]


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def _np_tree(tree):
    import jax
    import numpy as np
    return jax.tree.map(np.asarray, tree)


def run_families(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.models import api as model_api
    from repro.models import transformer

    for i, arch in enumerate(ARCHS):
        cfg = get_reduced(arch)
        params, _ = model_api.init_model(jax.random.key(i), cfg)
        _flatten(_np_tree(params), f"{arch}/params/", out)
        rng = np.random.default_rng(i)
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, TOKENS)).astype(np.int32)
        out[f"{arch}/tokens"] = tokens

        fwd = jax.jit(lambda p, t: transformer.forward(p, cfg, t, remat=False)[0])
        out[f"{arch}/logits"] = np.asarray(fwd(params, jnp.asarray(tokens)))

        step = jax.jit(lambda p, t, c, i0: transformer.forward(
            p, cfg, t, caches=c, cache_index=i0, remat=False))
        caches = transformer.init_caches(cfg, BATCH, MAX_SEQ, jnp.float32)
        logits, _, caches = step(params, jnp.asarray(tokens), caches,
                                 jnp.int32(0))
        out[f"{arch}/prefill_logits"] = np.asarray(logits)
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks = [np.asarray(nxt)]
        for d in range(DECODE):
            logits, _, caches = step(params, nxt, caches, jnp.int32(TOKENS + d))
            out[f"{arch}/decode{d}_logits"] = np.asarray(logits)
            nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(nxt))
        out[f"{arch}/greedy"] = np.concatenate(toks, axis=1)

        def loss_fn(p, t):
            return model_api.model_loss(p, cfg, {"tokens": t}, remat=True)

        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(tokens))
        out[f"{arch}/loss"] = np.asarray(loss)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = np.asarray(v)
        _flatten(_np_tree(grads), f"{arch}/grads/", out)


def _mesh(p):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:p]).reshape(1, p), ("data", "model"))


def run_shared(out: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.models import moe as moe_mod
    from repro.parallel.sharding import DEFAULT_RULES, ParamFactory, axis_rules

    cfg = get_reduced("moonshot-v1-16b-a3b")
    d = cfg.d_model
    f = ParamFactory(jax.random.key(5), jnp.float32)
    moe_mod.init_moe(f.scope("moe"), d, cfg.moe)
    params = {k: np.asarray(v) for k, v in f.params["moe"].items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, SHARED_TOKENS, d)).astype(np.float32)
    cot = (rng.standard_normal((1, SHARED_TOKENS, d))
           / SHARED_TOKENS).astype(np.float32)
    aux_cot = np.asarray([0.5, -0.25], np.float32)
    for k, v in params.items():
        out[f"params/{k}"] = v
    out["x"], out["cot"], out["aux_cot"] = x, cot, aux_cot
    for p, dispatch, variant in SHARED_CASES:
        mcfg = dataclasses.replace(cfg.moe, dispatch=dispatch,
                                   a2a_variant=variant)
        mesh = _mesh(p)
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe_mod.MoEDispatchPlan.build(
                mcfg, SHARED_TOKENS, mesh, d_model=d, dtype=jnp.float32)

            def f_(prm, xx):
                y, aux = moe_mod.apply_moe(prm, xx, mcfg, plan)
                return jnp.sum(y * cot) + jnp.sum(aux * aux_cot), (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f_, argnums=(0, 1), has_aux=True))(
                {k2: jnp.asarray(v) for k2, v in params.items()},
                jnp.asarray(x))
        tag = f"P{p}-{dispatch}-{variant}"
        out[f"{tag}/y"], out[f"{tag}/aux"] = np.asarray(y), np.asarray(aux)
        for k2, v in gp.items():
            out[f"{tag}/d{k2}"] = np.asarray(v)
        out[f"{tag}/dx"] = np.asarray(gx)


def run_flash(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import attention
    from repro.parallel.sharding import ParamFactory

    b, s, n, g, dh = (FLASH[k] for k in ("b", "s", "n", "g", "dh"))
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, s, n, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, n, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, n, dh)).astype(np.float32)
    do = rng.standard_normal((b, s, n, g, dh)).astype(np.float32)
    out["flash/q"], out["flash/k"], out["flash/v"], out["flash/do"] = q, k, v, do
    scale = dh ** -0.5
    for kind in FLASH_POSITIONS:
        qp, kp = (jnp.asarray(a) for a in position_arrays(kind, s))

        def fn(qq, kk, vv, qp=qp, kp=kp):
            return attention._flash_attention(qq, kk, vv, qp, kp, True, scale)

        o, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
        dq, dk, dv = vjp(jnp.asarray(do))
        for name, a in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            out[f"flash/{kind}/{name}"] = np.asarray(a)

    cfg = FLASH_APPLY
    f = ParamFactory(jax.random.key(2), jnp.float32)
    attention.init_attention(f.scope("attn"), cfg["d_model"], cfg["n_heads"],
                             cfg["n_kv"], cfg["head_dim"])
    prm = f.params["attn"]
    for key, val in prm.items():
        out[f"apply/params/{key}"] = np.asarray(val)
    x = rng.standard_normal((cfg["b"], cfg["s"], cfg["d_model"])).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(cfg["s"])[None], (cfg["b"], cfg["s"]))
    y, _ = jax.jit(lambda p, xx: attention.apply_attention(
        p, xx, n_heads=cfg["n_heads"], n_kv=cfg["n_kv"],
        head_dim=cfg["head_dim"], positions=pos))(prm, jnp.asarray(x))
    out["apply/x"], out["apply/y"] = x, np.asarray(y)

    # Which (queries, keys) take the flash path: a spy on the module's
    # _flash_attention, traced only (eval_shape computes nothing).
    real, took = attention._flash_attention, []

    def spy(*a):
        took.append(True)
        return real(*a)

    attention._flash_attention = spy
    try:
        flags = []
        for sq, sk in SWITCH:
            took.clear()
            cache = {"k": jnp.zeros((1, sk, cfg["n_kv"], cfg["head_dim"])),
                     "v": jnp.zeros((1, sk, cfg["n_kv"], cfg["head_dim"]))}
            jax.eval_shape(lambda xx, c: attention.apply_attention(
                prm, xx, n_heads=cfg["n_heads"], n_kv=cfg["n_kv"],
                head_dim=cfg["head_dim"],
                positions=jnp.arange(sq)[None], kv_cache=c, cache_index=0),
                jnp.zeros((1, sq, cfg["d_model"])), cache)
            flags.append(bool(took))
    finally:
        attention._flash_attention = real
    out["switch/flash"] = np.asarray(flags)


def run_ulysses(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.models import ulysses
    from repro.parallel.sharding import use_mesh

    b, s, h, d = (ULYSSES[k] for k in ("b", "s", "h", "d"))
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    out["q"], out["k"], out["v"], out["cot"], out["pos"] = q, k, v, cot, pos
    out["attend"] = np.asarray(ulysses._attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), True))
    for tag, (shape, names, axis, hier) in ULYSSES_MESHES.items():
        mesh = make_mesh(shape, names)
        with use_mesh(mesh):
            plan = ulysses.UlyssesPlan.build(h, d, mesh, axis=axis, hier=hier)
            spec = NamedSharding(mesh, P(None, axis))
            args = [jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)]

            fn = jax.jit(lambda qq, kk, vv, plan=plan: ulysses.ulysses_attention(
                qq, kk, vv, jnp.asarray(pos), plan))

            if hier:
                out[f"{tag}/o"] = np.asarray(fn(*args))
                continue
            o, vjp = jax.vjp(fn, *args)
            dq, dk, dv = vjp(jnp.asarray(cot))
        out[f"{tag}/o"] = np.asarray(o)
        out[f"{tag}/dq"], out[f"{tag}/dk"], out[f"{tag}/dv"] = (
            np.asarray(dq), np.asarray(dk), np.asarray(dv))


def run_collectives(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import shard_map
    from repro.launch.mesh import make_mesh
    from repro.parallel.collectives import (flat_psum_mean,
                                            hierarchical_psum_mean,
                                            plan_rs_ag_pair)

    mesh = make_mesh((2, 4), ("pod", "data"))
    spec = P(("pod", "data"))
    fns = {
        "raw": lambda t: hierarchical_psum_mean(
            t, inner_axis="data", outer_axis="pod", scatter_dim=1),
        "plan": lambda t: hierarchical_psum_mean(
            t, inner_axis="data", outer_axis="pod", scatter_dim=1, mesh=mesh),
        "flat": lambda t: flat_psum_mean(t, ("pod", "data")),
    }
    for i, local in enumerate(REDUCE_SHAPES):
        x = np.random.default_rng(i).standard_normal(
            (8 * local[0],) + local[1:]).astype(np.float32)
        out[f"{i}/x"] = x
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        for name, fn in fns.items():
            f = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec,
                                  out_specs=spec, check_vma=False))
            out[f"{i}/{name}"] = np.asarray(f(xs))
    caps = [plan_rs_ag_pair(r, (4,), jnp.float32, "data", mesh)[2]
            for r in PAIR_ROWS]
    out["pair_caps"] = np.asarray(caps)


def main(argv) -> None:
    mode, path = argv[1], argv[2]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    {"families": run_families, "shared": run_shared, "flash": run_flash,
     "ulysses": run_ulysses, "collectives": run_collectives}[mode](out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
