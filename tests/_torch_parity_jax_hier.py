"""Reference outputs of the JAX package for the port's hierarchy and
``embed()`` parity tests.

    PYTHONPATH=src python tests/_torch_parity_jax_hier.py OUT.npz

Runs in a process of its own with 8 host devices, like
``tests/_torch_parity_jax.py``, and writes one ``.npz``: for every case in
the lists below, the JAX package's recv buffers and plan metadata, stage 2
(``variants.stage2_leader_ppermute``) on every rank, the embedded epochs of
``embedded_plan_parity`` and the table-free ``hierarchy_exchange``.
``tests/test_torch_hier.py`` runs it once per test run and feeds the same
arrays through the port.

The Pallas stage-2 kernel runs interpreted once, on mesh (4, 2) only: on
mesh (2, 4), where inner ranks 1-3 sit out the only macro-round, the
interpreted kernel gave no result in over 100 s on an 8-device CPU host.

The case lists are plain data, so the test module can parametrize over
them without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

P = 8
FEATURE = (4,)
MESHES = ((2, 4), (4, 2))

# Count patterns: hier_combined_parity's dense, banded and skewed (rng 21),
# hierarchy_local_elision's all-local pattern over groups of 4 and its twin
# with one row crossing the outer boundary (rng 4).
HIER_PATTERNS = ("dense", "banded", "skewed", "local", "local_x")

# (pattern, mesh, pack_impl) of the fence_hierarchy plans.
HIER_CASES = [(pat, mesh, impl) for mesh in MESHES for pat in HIER_PATTERNS
              for impl in ("jnp", "pallas")]

# Non-identity leader permutations, per mesh: each group's row reversed,
# and each group's row rotated by one.
LEADER_PERMS = ("reversed", "rotated")

# The interpreted Pallas K5, once: pack_impl="fused" at (4, 2), dense,
# identity leader permutation.
FUSED_CASE = ("dense", (4, 2), "fused")

# embedded_plan_parity (seed 31, max_count 11): flat plans on axis "x",
# then fence_hierarchy on mesh (2, 4).
EMBED_CASES = (("fence", "jnp"), ("fence", "pallas"), ("fence", "fused"),
               ("lock", "jnp"), ("lock", "pallas"), ("fence_hierarchy", "jnp"))

# Uniform bucketed input of the table-free hierarchy_exchange.
UNIFORM_CAP = 3

SUMMARY_KEYS = ("capacity_rows", "send_rows", "recv_rows", "total_recv_bytes",
                "hierarchy_remote_needed", "cross_group_puts")


def mesh_id(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def case_id(case) -> str:
    return "-".join(mesh_id(c) if isinstance(c, tuple) else str(c) for c in case)


def pattern_counts(name: str):
    """The pattern's count matrix (numpy only, as the dist cases make it)."""
    import numpy as np
    if name in ("dense", "skewed"):
        rng = np.random.default_rng(21)
        dense = rng.integers(1, 13, (P, P))
        if name == "dense":
            return dense
        skewed = rng.integers(0, 4, (P, P))
        skewed[:, P - 1] *= 9
        skewed[0, :] *= 5
        return skewed
    if name == "banded":                   # dist_cases._banded_counts(p, 1)
        rng = np.random.default_rng(3)
        c = np.zeros((P, P), np.int64)
        for i in range(P):
            for d in (-1, 0, 1):
                c[i, (i + d) % P] = rng.integers(1, 11)
        return c
    if name in ("local", "local_x"):
        p_outer, p_inner = 2, P // 2
        rng = np.random.default_rng(4)
        c = np.zeros((P, P), np.int64)
        for g in range(p_outer):
            lo, hi = g * p_inner, (g + 1) * p_inner
            c[lo:hi, lo:hi] = rng.integers(0, 9, (p_inner, p_inner))
        if name == "local_x":
            c[0, p_inner] = 1
        return c
    if name == "embed":                    # dist_cases._setup_pattern(p, 31, 11)
        return np.random.default_rng(31).integers(0, 11, size=(P, P))
    raise KeyError(name)


def leader_perm(name: str, mesh):
    p_outer, p_inner = mesh
    row = list(range(p_inner))
    if name == "reversed":
        row = row[::-1]
    elif name == "rotated":
        row = row[1:] + row[:1]
    return [list(row) for _ in range(p_outer)]


def geometry(counts):
    """send_rows, recv_rows of a plan over ``counts`` (tile 8)."""
    def up(n):
        return max(-(-n // 8) * 8, 8)
    return up(int(counts.sum(axis=1).max())), up(int(counts.sum(axis=0).max()))


def stage2_input(name: str, mesh, s1_rows: int):
    """The stage-1 recv buffers fed to stage 2: ``[P, s1_rows, *FEATURE]``."""
    import numpy as np
    seed = HIER_PATTERNS.index(name) if name in HIER_PATTERNS else 9
    rng = np.random.default_rng(100 + 10 * seed + mesh[0])
    return rng.standard_normal((P, s1_rows) + FEATURE).astype(np.float32)


def uniform_input():
    import numpy as np
    rng = np.random.default_rng(5)
    return rng.standard_normal((P, P * UNIFORM_CAP) + FEATURE).astype(np.float32)


def main(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={P}")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from repro.compat import shard_map
    from repro.core import PlanCache, alltoallv_init, metadata as md, reference, variants
    from repro.launch.mesh import make_host_mesh, make_mesh

    res = {}
    meshes = {m: make_mesh(m, ("o", "i")) for m in MESHES}
    grid = PS(("o", "i"))

    def send_buffer(name):
        counts = pattern_counts(name)
        send_rows, _ = geometry(counts)
        bufs = reference.make_testbufs(counts, FEATURE, np.float32, send_rows)
        res[f"{name}/x"] = bufs.reshape((P * send_rows,) + FEATURE)
        return counts, bufs.reshape((P * send_rows,) + FEATURE)

    def run_plan(key, counts, x, mesh, axis, **kw):
        plan = alltoallv_init(counts, FEATURE, jnp.float32, mesh, axis=axis,
                              cache=PlanCache(), store=False, **kw)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(
            mesh, PS(axis if len(axis) > 1 else axis[0])))
        res[f"{key}/out"] = np.asarray(plan.wait(plan.start(xs)))
        summary = {k: plan.metadata_summary()[k] for k in SUMMARY_KEYS}
        summary["digest"] = plan.signature.digest
        res[f"{key}/summary"] = np.array(json.dumps(summary))
        return plan

    def stage2(key, counts, mesh, lp=None):
        _, recv_rows = geometry(counts)
        sched = md.hier_two_stage_schedule(counts, mesh[0], mesh[1], recv_rows,
                                           leader_perm=lp)
        s1 = stage2_input(key.split("/")[1], mesh, mesh[1] * sched.s1_cap)
        f = jax.jit(shard_map(
            lambda a, src, valid: variants.stage2_leader_ppermute(
                a, src[0], valid[0], sched, ("o", "i")),
            mesh=meshes[mesh], in_specs=(grid,) * 3, out_specs=grid,
            check_vma=False))
        out = f(jnp.asarray(s1.reshape((-1,) + FEATURE)),
                jnp.asarray(sched.s2_src), jnp.asarray(sched.s2_valid))
        res[key] = np.asarray(out).reshape((P, sched.total_s2) + FEATURE)

    xs = {name: send_buffer(name) for name in HIER_PATTERNS}
    for case in HIER_CASES:
        name, mesh, impl = case
        counts, x = xs[name]
        run_plan(case_id(case), counts, x, meshes[mesh], ("o", "i"),
                 variant="fence_hierarchy", pack_impl=impl)
    for name in HIER_PATTERNS:
        # The flat fence plan's valid rows do not depend on the mesh's
        # factorization: one run per pattern.
        counts, x = xs[name]
        run_plan(f"flat/{name}", counts, x, meshes[MESHES[0]], ("o", "i"),
                 variant="fence")
        for mesh in MESHES:
            if name != "local":
                stage2(f"stage2/{name}/{mesh_id(mesh)}", counts, mesh)
    counts, x = xs["dense"]
    for mesh in MESHES:
        for lp_name in LEADER_PERMS:
            lp = leader_perm(lp_name, mesh)
            run_plan(f"perm/{lp_name}/{mesh_id(mesh)}", counts, x, meshes[mesh],
                     ("o", "i"), variant="fence_hierarchy",
                     hier_leader_perm=lp)
            stage2(f"stage2/dense/{mesh_id(mesh)}/{lp_name}", counts, mesh, lp)
    name, mesh, impl = FUSED_CASE
    run_plan(case_id(FUSED_CASE), *xs[name], meshes[mesh], ("o", "i"),
             variant="fence_hierarchy", pack_impl=impl)

    # embedded_plan_parity: plan.embed() inside a foreign shard_map.
    counts, x = send_buffer("embed")
    for variant, impl in EMBED_CASES:
        if variant == "fence_hierarchy":
            mesh, axis, spec = meshes[(2, 4)], ("o", "i"), grid
        else:
            mesh, axis, spec = make_host_mesh(P), ("x",), PS("x")
        plan = alltoallv_init(counts, FEATURE, jnp.float32, mesh,
                              axis=axis if len(axis) > 1 else axis[0],
                              variant=variant, pack_impl=impl,
                              cache=PlanCache(), store=False)
        fn = shard_map(plan.embed(), mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
        xs_ = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        res[f"embed/{variant}/{impl}"] = np.asarray(jax.jit(fn)(xs_))

    # The table-free hierarchy_exchange on a uniform bucketed layout.
    packed = uniform_input()
    for mesh in MESHES:
        for remote in (True, False):
            f = jax.jit(shard_map(
                lambda t, m=mesh, r=remote: variants.hierarchy_exchange(
                    t, "o", "i", m[0], m[1], UNIFORM_CAP, remote_needed=r),
                mesh=meshes[mesh], in_specs=grid, out_specs=grid,
                check_vma=False))
            out = f(jnp.asarray(packed.reshape((-1,) + FEATURE)))
            res[f"uniform/{mesh_id(mesh)}/{remote}"] = np.asarray(out).reshape(
                packed.shape)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1])
