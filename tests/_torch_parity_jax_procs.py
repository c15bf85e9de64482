"""Reference outputs of the JAX package for the port's process-mesh tests.

    PYTHONPATH=src python tests/_torch_parity_jax_procs.py OUT.npz

Runs in a process of its own with 4 host devices (the device count is
fixed before JAX initializes) and writes, for every key of ``CASES``, the
JAX plan's global recv buffer ``[P, recv_rows, F]`` on the inputs
``repro_torch.testing.dist_cases.parity`` feeds the port's 4 processes:
``_setup_pattern``-style random counts (seed 0, counts below 13, 4 f32 per
row; ``random15``: the same counts with 60-byte rows of 15 f32) and the
banded pattern of ``sparse_lock_elision``; the send buffers too, so the
test can check both sides read the same.

The case list is plain data, so the test module can parametrize over it
without importing JAX.
"""

from __future__ import annotations

import os
import sys

P = 4
# Row shape of each pattern's send buffers.
FEATURES = {"random": (4,), "banded": (4,), "random15": (15,)}

# key -> (pattern, variant, pack_impl, lock_schedule); the port's parity run
# writes the same keys.
CASES = {
    "random-fence-jnp-ring": ("random", "fence", "jnp", "ring"),
    "random-fence-pallas-ring": ("random", "fence", "pallas", "ring"),
    "random-fence-fused-ring": ("random", "fence", "fused", "ring"),
    "random-lock-jnp-ring": ("random", "lock", "jnp", "ring"),
    "random-lock-jnp-pairwise": ("random", "lock", "jnp", "pairwise"),
    "random-lock-pallas-ring": ("random", "lock", "pallas", "ring"),
    "banded-lock-jnp-ring": ("banded", "lock", "jnp", "ring"),
    "banded-lock-jnp-pairwise": ("banded", "lock", "jnp", "pairwise"),
    "random15-lock-jnp-ring": ("random15", "lock", "jnp", "ring"),
}
# start_pipelined: three epochs of the fence plan on x, 2x and 3x, each
# output read before the epoch two starts later; the non-persistent
# baseline (fence, lock) on the random pattern.
PIPELINED = ("pipelined-0", "pipelined-1", "pipelined-2")
BASELINES = ("baseline-fence", "baseline-lock")


def pattern_counts(name: str):
    import numpy as np

    if name in ("random", "random15"):
        return np.random.default_rng(0).integers(0, 13, size=(P, P))
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

    from repro.core import PlanCache, alltoallv_init, metadata as md, reference
    from repro.core.baseline import make_nonpersistent
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh(P)
    shard = NamedSharding(mesh, PS("x"))
    res = {}
    xs = {}
    for name, feature in FEATURES.items():
        counts = pattern_counts(name)
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        bufs = reference.make_testbufs(counts, feature, np.float32, send_rows)
        res[f"{name}/x"] = bufs
        xs[name] = jax.device_put(
            jnp.asarray(bufs.reshape((P * send_rows,) + feature)), shard)

    def init(name, **kw):
        return alltoallv_init(pattern_counts(name), FEATURES[name],
                              jnp.float32, mesh, axis="x", cache=PlanCache(),
                              store=False, **kw)

    for key, (name, variant, impl, sched) in CASES.items():
        plan = init(name, variant=variant, pack_impl=impl, lock_schedule=sched)
        res[key] = np.asarray(plan.wait(plan.start(xs[name]))).reshape(
            (P, plan.recv_rows) + FEATURES[name])
    FEATURE = FEATURES["random"]

    plan = init("random")
    x = xs["random"]
    shape = (P, plan.recv_rows) + FEATURE
    o0 = plan.start_pipelined(x)
    o1 = plan.start_pipelined(x * 2.0)
    res["pipelined-0"] = np.asarray(plan.wait(o0)).reshape(shape)
    o2 = plan.start_pipelined(x * 3.0)
    res["pipelined-1"] = np.asarray(plan.wait(o1)).reshape(shape)
    res["pipelined-2"] = np.asarray(plan.wait(o2)).reshape(shape)

    counts = pattern_counts("random")
    cnts = jax.device_put(jnp.asarray(counts.reshape(-1), jnp.int32), shard)
    for variant in ("fence", "lock"):
        exe = make_nonpersistent(mesh, axis="x", p=P, capacity=plan.capacity,
                                 send_rows=plan.send_rows,
                                 recv_rows=plan.recv_rows,
                                 feature_shape=FEATURE, dtype=jnp.float32,
                                 variant=variant)
        res[f"baseline-{variant}"] = np.asarray(
            jax.block_until_ready(exe(x, cnts))).reshape(shape)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
