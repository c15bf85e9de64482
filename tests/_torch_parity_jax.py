"""Reference outputs of the JAX package for the PyTorch port's parity tests.

    PYTHONPATH=src python tests/_torch_parity_jax.py OUT.npz

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes, as in ``repro.testing.dist_cases``), and
writes one ``.npz`` holding, for every case in ``CASES``, the send buffer,
the JAX plan's recv buffer and its metadata, plus the Pallas RMA kernels'
outputs in interpret mode and ``variants.lock_exchange``'s buckets.
``tests/test_torch_plan.py`` runs it once per test run and feeds the same
arrays through the port.

The case list is plain data, so the test module can parametrize over it
without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

P = 8

# pattern -> (counts recipe, feature shape, numpy dtype name).  Each
# mirrors the dist case named beside it.
PATTERNS = {
    "variants": (("random", 0, 13), (4,), "float32"),        # alltoallv_variants
    "dtype_f8": (("random", 1, 9), (8,), "float32"),         # alltoallv_dtypes_and_features
    "dtype_f3x5": (("random", 2, 9), (3, 5), "float32"),
    "dtype_f16": (("random", 3, 9), (16,), "float16"),
    "dtype_scalar": (("random", 4, 9), (), "float32"),
    "banded": (("banded",), (4,), "float32"),                # sparse_lock_elision
    "fused": (("random", 9, 9), (4,), "float32"),            # fused_pack_fence
    "pallas": (("random", 5, 9), (4,), "float32"),           # pallas_pack_in_plan
}

# (pattern, variant, pack_impl, lock_schedule).  pack_impl="fused" runs
# once, on its own pattern: the interpreted fused kernel takes seconds.
CASES = (
    [("variants", "fence", impl, "ring") for impl in ("jnp", "pallas")]
    + [("variants", "lock", impl, s) for impl in ("jnp", "pallas")
       for s in ("ring", "pairwise")]
    + [(pat, v, "jnp", "ring") for pat in ("dtype_f8", "dtype_f3x5",
                                           "dtype_f16", "dtype_scalar")
       for v in ("fence", "lock")]
    + [("banded", "lock", impl, s) for impl in ("jnp", "pallas")
       for s in ("ring", "pairwise")]
    + [("banded", "fence", "jnp", "ring"),
       ("fused", "fence", "fused", "ring"),
       ("pallas", "fence", "pallas", "ring"),
       ("pallas", "lock", "pallas", "ring")]
)

# Plan metadata the port must reproduce.
SUMMARY_KEYS = ("capacity_rows", "send_rows", "recv_rows", "lock_rounds_active",
                "lock_rounds_total", "total_recv_bytes", "padded_bytes_per_rank",
                "payload_bytes_per_rank", "identity_maps")

# Bucketed exchange kernels: capacity and feature width of the packed input.
RMA_CAP, RMA_FEAT = 8, 16


def case_id(case) -> str:
    return "-".join(case)


def pattern_counts(name: str):
    """The pattern's count matrix (numpy only, as the dist cases make it)."""
    import numpy as np
    recipe = PATTERNS[name][0]
    if recipe[0] == "random":
        return np.random.default_rng(recipe[1]).integers(0, recipe[2], size=(P, P))
    rng = np.random.default_rng(3)          # dist_cases._banded_counts(p, 1)
    c = np.zeros((P, P), np.int64)
    for i in range(P):
        for d in (-1, 0, 1):
            c[i, (i + d) % P] = rng.integers(1, 11)
    return c


def main(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={P}")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from repro.compat import shard_map
    from repro.core import PlanCache, alltoallv_init, metadata as md, reference, variants
    from repro.kernels import ops
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh(P)
    shard = NamedSharding(mesh, PS("x"))
    res = {}
    for name, (_, feature, dtype) in PATTERNS.items():
        counts = pattern_counts(name)
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        bufs = reference.make_testbufs(counts, feature, np.dtype(dtype), send_rows)
        res[f"{name}/x"] = bufs.reshape((P * send_rows,) + feature)
    for case in CASES:
        name, variant, pack_impl, sched = case
        _, feature, dtype = PATTERNS[name]
        x = jax.device_put(jnp.asarray(res[f"{name}/x"]), shard)
        plan = alltoallv_init(pattern_counts(name), feature, jnp.dtype(dtype),
                              mesh, axis="x", variant=variant,
                              pack_impl=pack_impl, lock_schedule=sched,
                              cache=PlanCache(), store=False)
        res[f"{case_id(case)}/out"] = np.asarray(plan.wait(plan.start(x)))
        summary = {k: plan.metadata_summary()[k] for k in SUMMARY_KEYS}
        summary["digest"] = plan.signature.digest
        res[f"{case_id(case)}/summary"] = np.array(json.dumps(summary))

    # The Pallas RMA kernels, interpreted (dist case rma_kernels).
    rng = np.random.default_rng(0)
    packed_all = rng.standard_normal((P, P * RMA_CAP, RMA_FEAT)).astype(np.float32)
    res["rma/packed"] = packed_all
    xg = jax.device_put(jnp.asarray(packed_all.reshape(-1, RMA_FEAT)), shard)
    for variant in ("fence", "lock"):
        f = shard_map(
            lambda t, v=variant: ops.rma_alltoallv(
                t, variant=v, p=P, capacity=RMA_CAP, axis="x", mesh_axes=("x",)),
            mesh=mesh, in_specs=PS("x"), out_specs=PS("x"), check_vma=False)
        res[f"rma/{variant}"] = np.asarray(f(xg)).reshape(P, P * RMA_CAP, RMA_FEAT)

    # variants.lock_exchange with elided rounds (banded counts).
    banded = pattern_counts("banded")
    cap = md.global_capacity(banded)
    packed_lock = rng.standard_normal((P, P * cap, 4)).astype(np.float32)
    res["lock_exchange/packed"] = packed_lock
    xl = jax.device_put(jnp.asarray(packed_lock.reshape(-1, 4)), shard)
    for sched in ("ring", "pairwise"):
        caps = (md.xor_round_capacities(banded) if sched == "pairwise"
                else md.ring_round_capacities(banded))
        f = shard_map(
            lambda t, c=caps, s=sched: variants.lock_exchange(t, "x", P, cap, c, s),
            mesh=mesh, in_specs=PS("x"), out_specs=PS("x"), check_vma=False)
        res[f"lock_exchange/{sched}"] = np.asarray(f(xl)).reshape(P, P * cap, 4)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
