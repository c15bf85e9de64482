"""Reference outputs of the JAX package for the port's ragged, pattern and
codec parity tests.

    PYTHONPATH=src python tests/_torch_parity_jax_patterns.py {ragged|patterns|codec} OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes) and writes one ``.npz``:

  ragged    for every case in ``RAGGED_CASES``, the INIT metadata of a JAX
            ``ExchangePlan`` built with ``variant="ragged"`` (built only:
            XLA:CPU cannot execute ``ragged_all_to_all``).
            ``tests/test_torch_ragged.py`` reads it.
  patterns  for every plan in ``PATTERN_PLANS``, the integer-valued send
            buffer and the JAX plan's recv buffer.
            ``tests/test_torch_patterns.py`` reads it.
  codec     for every plan in ``CODEC_PLANS``, the send buffer and the JAX
            plan's recv buffer under the plan's wire codec.
            ``tests/test_torch_wirecodec.py`` reads it.

The case lists are plain data, so the test modules parametrize over them
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

# name -> (P, counts recipe).  dense/skewed/sparse/zero-row patterns.
RAGGED_CASES = {
    "dense4": (4, ("random", 0, 13)),
    "dense8": (8, ("random", 1, 13)),
    "skewed8": (8, ("skewed", 2)),
    "sparse8": (8, ("banded",)),
    "zero_rows8": (8, ("zero_rows", 3)),
    "zero_rows4": (4, ("zero_rows", 4)),
}

# INIT metadata the port must reproduce (besides the tables themselves).
RAGGED_SUMMARY_KEYS = ("capacity_rows", "send_rows", "recv_rows",
                       "total_recv_bytes", "payload_bytes_per_rank",
                       "identity_maps")

# (collective, variant, mesh shape) at P=8: the five plans of
# chip_smoke.py's patterns_path, at a CPU size.
PATTERN_PLANS = (("allgatherv", "fence", (8,)), ("allgatherv", "lock", (8,)),
                 ("allgatherv", "fence_hierarchy", (2, 4)),
                 ("reduce_scatter", "fence", (8,)),
                 ("reduce_scatter", "lock", (8,)))
PATTERN_FEATURE = (4,)

# (codec, variant, pack_impl, mesh shape) at P=8 on one random pattern.
# The interpreted fused kernels take seconds: each runs once.
CODEC_PLANS = (
    [(c, "fence", "jnp", (8,)) for c in ("bf16", "int8", "fp8")]
    + [("int8", "fence", "pallas", (8,)), ("int8", "fence", "fused", (8,)),
       ("int8", "lock", "jnp", (8,)), ("fp8", "lock", "pallas", (8,)),
       ("int8", "fence_hierarchy", "jnp", (2, 4))]
)
CODEC_FEATURE = (16,)
CODEC_COUNTS = ("random", 6, 11)
ERROR_TOL = 0.1


def ragged_counts_of(p, recipe):
    """The case's count matrix (numpy only)."""
    import numpy as np
    kind = recipe[0]
    if kind == "random":
        return np.random.default_rng(recipe[1]).integers(0, recipe[2], (p, p))
    if kind == "skewed":
        rng = np.random.default_rng(recipe[1])
        c = rng.integers(0, 4, (p, p))
        c[:, 3] += 40                       # one hot receiver
        c[1] += 9                           # one heavy sender
        return c
    if kind == "banded":
        c = np.zeros((p, p), np.int64)
        for i in range(p):
            c[i, (i + 1) % p] = 5 + i
        return c
    rng = np.random.default_rng(recipe[1])   # zero rows and columns
    c = rng.integers(0, 9, (p, p))
    c[1] = 0
    c[:, p - 1] = 0
    return c


def pattern_counts():
    """``benchmarks/collective_sweep.py::ragged_counts(8, seed=5)``: one hot
    rank."""
    import numpy as np
    c = np.random.default_rng(5).integers(8, 48, 8).astype(np.int64)
    c[0] += 64
    return c


def plan_id(case) -> str:
    return "-".join(str(x) if not isinstance(x, tuple) else "x".join(map(str, x))
                    for x in case)


def int_bufs(p, rows, feature, seed):
    """Integer-valued float32 send buffers: reduce-scatter sums are exact."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, (p, rows) + feature).astype(np.float32)


def _mesh(shape):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    names = ("x",) if len(shape) == 1 else ("o", "i")
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names), names


def _run(plan, x, shape):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as PS
    mesh, names = _mesh(shape)
    spec = PS(names[0] if len(names) == 1 else names)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    return np.asarray(plan.wait(plan.start(xs)))


def run_ragged(out: dict) -> None:
    import numpy as np
    from repro.core import PlanCache, alltoallv_init
    for name, (p, recipe) in RAGGED_CASES.items():
        mesh, _ = _mesh((p,))
        plan = alltoallv_init(ragged_counts_of(p, recipe), (4,), np.float32,
                              mesh, axis="x", variant="ragged",
                              cache=PlanCache(), store=False)
        for key in ("sdispls", "put_displs", "recv_counts", "send_counts"):
            out[f"{name}/{key}"] = np.asarray(getattr(plan, key))
        summary = {k: plan.metadata_summary()[k] for k in RAGGED_SUMMARY_KEYS}
        summary["digest"] = plan.signature.digest
        out[f"{name}/summary"] = np.array(json.dumps(summary))


def run_patterns(out: dict) -> None:
    from repro.core import PlanCache, allgatherv_init, reduce_scatter_init
    counts = pattern_counts()
    inits = {"allgatherv": allgatherv_init,
             "reduce_scatter": reduce_scatter_init}
    for k, case in enumerate(PATTERN_PLANS):
        coll, variant, shape = case
        mesh, names = _mesh(shape)
        axis = names[0] if len(names) == 1 else names
        plan = inits[coll](counts, PATTERN_FEATURE, "float32", mesh,
                           axis=axis, variant=variant, cache=PlanCache(),
                           store=False)
        x = int_bufs(8, plan.send_rows, PATTERN_FEATURE, seed=k)
        out[f"{plan_id(case)}/x"] = x
        out[f"{plan_id(case)}/out"] = _run(
            plan, x.reshape((-1,) + PATTERN_FEATURE), shape)


def run_codec(out: dict) -> None:
    import numpy as np
    from repro.core import PlanCache, alltoallv_init, reference
    counts = ragged_counts_of(8, CODEC_COUNTS)
    for k, case in enumerate(CODEC_PLANS):
        codec, variant, impl, shape = case
        mesh, names = _mesh(shape)
        axis = names[0] if len(names) == 1 else names
        plan = alltoallv_init(counts, CODEC_FEATURE, "float32", mesh,
                              axis=axis, variant=variant, pack_impl=impl,
                              codec=codec, error_tol=ERROR_TOL,
                              cache=PlanCache(), store=False)
        x = reference.make_testbufs(counts, CODEC_FEATURE, np.float32,
                                    plan.send_rows, seed=k)
        out[f"{plan_id(case)}/x"] = x
        out[f"{plan_id(case)}/out"] = _run(
            plan, x.reshape((-1,) + CODEC_FEATURE), shape)


def main(argv) -> None:
    mode, path = argv[1], argv[2]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    {"ragged": run_ragged, "patterns": run_patterns,
     "codec": run_codec}[mode](out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
