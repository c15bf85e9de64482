"""The JAX package's side of the plan-store parity test.

    PYTHONPATH=src python tests/_torch_parity_jax_planstore.py \\
        JAX_STORE PORT_STORE OUT.json

Runs in a process of its own with 8 host devices (the device count must be
fixed before JAX initializes).  With INIT capture on, it runs
``repro.core.api.exchange_init`` for every case in ``CASES`` against a
``repro.planstore.PlanStore`` in ``JAX_STORE`` (cold INITs, which publish
their tables and auto decisions), then decodes every entry the port wrote
in ``PORT_STORE`` with the JAX codec and validates it against the JAX
signature of the same pattern.  It writes the captured INIT records, each
plan's signature digest (and an auto plan's decision-signature digest and
winner), the sha256 of every table of the JAX plans, and for each port
file its payload, the sha256 of every decoded table, the JAX validation's
error and whether a JAX store over ``PORT_STORE`` finds it.
``tests/test_torch_planstore_parity.py`` reads it.

The case list is plain data, so the test module uses it without importing
JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

P = 8
FEATURE = (4,)

# name -> (collective, mesh shape, axis names, exchange axis, counts seed,
# INIT options).
CASES = {
    "fence8": ("alltoallv", (8,), ("x",), "x", 0, {"variant": "fence"}),
    "lock8": ("alltoallv", (8,), ("x",), "x", 1,
              {"variant": "lock", "lock_schedule": "pairwise"}),
    "fence24": ("alltoallv", (2, 4), ("o", "i"), ("o", "i"), 2,
                {"variant": "fence"}),
    "hier24": ("alltoallv", (2, 4), ("o", "i"), ("o", "i"), 3,
               {"variant": "fence_hierarchy"}),
    "auto24": ("alltoallv", (2, 4), ("o", "i"), ("o", "i"), 4,
               {"variant": "auto", "autotune_iters": 2}),
    "allgatherv8": ("allgatherv", (8,), ("x",), "x", 5, {"variant": "fence"}),
}


def case_counts(name):
    """The counts of a case: a [P, P] matrix, or a [P] vector for the
    allgatherv family."""
    import numpy as np

    collective, _, _, _, seed, _ = CASES[name]
    rng = np.random.default_rng(seed)
    if collective == "alltoallv":
        return rng.integers(1, 12, (P, P)).astype(np.int64)
    return rng.integers(1, 12, P).astype(np.int64)


def sha(a) -> str:
    import numpy as np

    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def artifact_tables(art) -> dict:
    """Every table of a decoded artifact (or plan), by the codec's segment
    name, as sha256."""
    out = {}
    if getattr(art, "index_tables", None) is not None:
        for n in ("pack_src", "pack_valid", "unpack_src", "unpack_valid"):
            out[n] = sha(getattr(art.index_tables, n))
    if getattr(art, "hier_schedule", None) is not None:
        for n in ("s1_src", "s1_valid", "s2_src", "s2_valid", "s3_src",
                  "s3_valid", "unpack_src", "unpack_valid"):
            out["hier_" + n] = sha(getattr(art.hier_schedule, n))
    return out


def main(jax_store: str, port_store: str, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={P}")
    import jax.numpy as jnp

    from repro.core import PlanCache, capture_init_requests, exchange_init
    from repro.core import autotune
    from repro.launch.mesh import make_mesh
    from repro.planstore import ArtifactError, PlanStore, codec

    store = PlanStore(jax_store)
    cache = PlanCache()          # the cases' patterns differ: no sharing
    sigs, out = {}, {"plans": {}, "jax_tables": {}, "port_files": {}}
    with capture_init_requests() as reqs:
        for name, (coll, shape, names, axis, _, opts) in CASES.items():
            mesh = make_mesh(shape, names)
            plan = exchange_init(coll, case_counts(name), FEATURE,
                                 jnp.float32, mesh, axis=axis, cache=cache,
                                 store=store, **opts)
            row = {"digest": plan.signature.digest,
                   "variant": plan.spec.variant}
            if opts["variant"] == "auto":
                decision = autotune.decision_signature(plan.spec, mesh)
                row["decision_digest"] = decision.digest
                sigs[decision.digest] = decision
            out["plans"][name] = row
    out["requests"] = list(reqs)
    for sig, plan in cache._plans.items():       # the auto candidates too
        sigs[sig.digest] = sig
        out["jax_tables"][sig.digest] = artifact_tables(plan)

    port = PlanStore(port_store)
    for fname in sorted(os.listdir(port_store)):
        if not fname.endswith(".plan"):
            continue
        art = codec.load(os.path.join(port_store, fname))
        rec = {"payload": art.payload_kind, "tables": artifact_tables(art),
               "digest": art.signature.get("digest"),
               "auto_choice": art.auto_choice,
               "jax_version": art.jax_version, "backend": art.backend}
        sig = sigs.get(rec["digest"])
        if sig is not None:
            try:
                art.validate_against(sig)
                rec["jax_validation"] = None
            except ArtifactError as e:
                rec["jax_validation"] = str(e)
            rec["jax_store_hit"] = port.get(sig) is not None
        out["port_files"][fname] = rec
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
