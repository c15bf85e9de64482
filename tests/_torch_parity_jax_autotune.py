"""Reference decisions of the JAX package's ``variant="auto"`` for the
port's autotune parity test.

    PYTHONPATH=src python tests/_torch_parity_jax_autotune.py OUT.json

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes).  For every case in ``CASES`` it runs
``repro.core.api.exchange_init(..., variant="auto")`` twice on one plan
cache, with ``repro.core.breakeven.measure_arms`` replaced by
``fake_measure_arms``: the arm times come from the case's tables, not from
a clock, so both packages see the same times.  It writes, per case, the
decision (variant, codec, times), every ``measure_arms`` call (the arms,
iters, warmup and bursts), the ``INIT_STATS`` change of each INIT, and the
winner's spec and signature digest.  ``tests/test_torch_autotune.py`` reads
it.

The case list and the fake estimator are plain data and code, so the test
module uses them without importing JAX.
"""

from __future__ import annotations

import json
import os
import sys

P = 8
FEATURE = (4,)
TOL_INT8 = 0.5 / 127

# name -> (collective, mesh shape, axis, counts seed, options, time tables).
# A time table maps an arm to seconds; ``tables[0]`` serves the first
# measure_arms call, ``tables[1]`` the refinement round.  Arms the JAX
# package does not build (the port's ragged candidate) are slowest, so the
# winner is the same in both packages.
CASES = {
    "clear": ("alltoallv", (8,), "x", 0, {"pack_impl": "fused"},
              [{"fence": 1.0e-3, "lock": 3.0e-3, "ragged": 9.0e-3}]),
    "refine": ("alltoallv", (8,), "x", 1, {},
               [{"fence": 1.0e-3, "lock": 1.1e-3, "ragged": 9.0e-3},
                {"fence": 1.05e-3, "lock": 0.95e-3}]),
    "codec": ("alltoallv", (8,), "x", 2, {"error_tol": TOL_INT8},
              [{"fence@identity": 2.0e-3, "fence@bf16": 1.6e-3,
                "fence@int8": 1.0e-3, "lock@identity": 2.5e-3,
                "lock@bf16": 2.2e-3, "lock@int8": 1.9e-3,
                "ragged@identity": 9.0e-3}]),
    "embeddable": ("alltoallv", (8,), "x", 3, {"embeddable": True},
                   [{"fence": 1.0e-3, "lock": 2.0e-3}]),
    "hier": ("alltoallv", (4, 2), ("o", "i"), 4, {},
             [{"fence": 3.0e-3, "lock": 4.0e-3, "fence_hierarchy": 1.0e-3}]),
    "allgatherv": ("allgatherv", (4, 2), ("o", "i"), 5, {},
                   [{"fence": 2.0e-3, "lock": 1.0e-3,
                     "fence_hierarchy": 3.0e-3}]),
    "reduce_scatter": ("reduce_scatter", (8,), "x", 6,
                       {"error_tol": TOL_INT8},
                       [{"fence": 1.0e-3, "lock": 1.2e-3},
                        {"fence": 1.1e-3, "lock": 1.3e-3}]),
}


def case_counts(name):
    """The case's counts in its family's natural form ([P, P] or [P])."""
    import numpy as np
    collective, _, _, seed, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    if collective == "alltoallv":
        return rng.integers(0, 7, (P, P))
    return rng.integers(1, 7, P)


def fake_measure_arms(name, calls):
    """A ``measure_arms`` stand-in for case ``name`` that logs each call
    into ``calls`` and returns the times of its tables."""
    tables = CASES[name][5]

    def measure_arms(arms, iters=50, warmup=5, bursts=4):
        calls.append({"arms": sorted(arms), "iters": iters, "warmup": warmup,
                      "bursts": bursts})
        table = tables[min(len(calls) - 1, len(tables) - 1)]
        return {a: table[a] for a in arms}
    return measure_arms


def main(argv):
    out_path = argv[1]
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
    import jax.numpy as jnp

    from repro.core import INIT_STATS, PlanCache, api, breakeven
    from repro.launch.mesh import make_mesh

    out = {}
    for name, (collective, shape, axis, _, opts, _) in CASES.items():
        axes = (axis,) if isinstance(axis, str) else axis
        mesh = make_mesh(shape, axes)
        cache, calls, stats = PlanCache(), [], []
        breakeven.measure_arms = fake_measure_arms(name, calls)
        for _ in range(2):
            before = INIT_STATS.as_dict()
            plan = api.exchange_init(collective, case_counts(name), FEATURE,
                                     jnp.float32, mesh, axis=axis,
                                     variant="auto", cache=cache, store=False,
                                     **opts)
            after = INIT_STATS.as_dict()
            stats.append({k: after[k] - before[k]
                          for k in ("autotune_sweeps", "autotune_bursts")})
        choice = plan.auto_choice
        out[name] = {"variant": choice["variant"], "codec": choice["codec"],
                     "times": choice["times"], "calls": calls,
                     "stats": stats, "digest": plan.signature.digest,
                     "spec": {"variant": plan.spec.variant,
                              "codec": plan.spec.codec,
                              "pack_impl": plan.spec.pack_impl}}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv)
