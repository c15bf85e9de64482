"""Deploy-time plan-store prewarm: a fresh replica's first INIT is warm
(port of ``repro.planstore.prewarm``).

The store amortizes INIT across runs, but the *first* run of every pattern
on a fresh deployment still pays the cold sweep + bakes.  This module
closes that gap: it enumerates the INIT requests a deployment will issue —
from dry-run cell records (the port's ``launch/dryrun.py`` captures every
INIT behind each traced cell into the cell JSON, as the JAX package's
captures those behind each compiled cell; the records are the same in
both packages, so either's replay here) or by building a serve profile's
bundles under capture — replays them against a store, and publishes the artifacts.
Point serving replicas at that store (directly, or as the remote tier of
a ``tiered:local=…,remote=…`` URL) and their very first INIT performs zero
autotune bursts and zero table bakes.

The replay runs real INITs (autotune sweeps measure on *this* device), so
a prewarm process must run on the fleet's device kind — the store key
enforces it: artifacts prewarmed on the CPU are invisible to card
processes and vice versa.  Every request replays on the caller's device:
a ``VirtualMesh`` holds all P ranks of any request on one device, so none
is skipped for want of devices (the JAX replay skips requests needing more
devices than the host has).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.planstore prewarm \\
        --store fsremote://.planstore-fleet --from-dryrun experiments/dryrun-torch
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Iterable

#: Record field order is irrelevant; this canonical form keys deduplication.
#: ``collective`` is absent from older captures; ``request_key``'s
#: ``req.get`` treats that as None, distinct from explicit "alltoallv" only
#: in the dedup key (harmless: both replay identically).
_REQ_FIELDS = ("collective", "send_counts", "feature_shape", "dtype", "axis",
               "axis_sizes", "variant", "lock_schedule", "tile_rows",
               "pack_impl", "baked_metadata", "embeddable", "codec",
               "error_tol", "hier_leader_perm")


def request_key(req: dict) -> str:
    """Canonical dedup key of one captured INIT request (everything that
    changes the stored artifact; ``autotune_iters`` only shapes the cold
    sweep, so two requests differing there are one prewarm)."""
    return json.dumps([req.get(f) for f in _REQ_FIELDS], sort_keys=True)


def dedupe_requests(requests: Iterable[dict]) -> list[dict]:
    seen: dict[str, dict] = {}
    for r in requests:
        seen.setdefault(request_key(r), r)
    return list(seen.values())


def requests_from_dryrun(path: str) -> list[dict]:
    """Collect captured INIT requests from dryrun artifacts: ``path`` is a
    cell-record JSON file or a directory of them (``plan_inits`` field,
    as the port's ``launch/dryrun.py`` and the JAX package's write it)."""
    files = ([path] if os.path.isfile(path)
             else sorted(glob.glob(os.path.join(path, "*.json"))))
    out: list[dict] = []
    for f in files:
        try:
            with open(f) as fh:
                rec = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            # A truncated cell record means that cell's patterns won't be
            # prewarmed — say so instead of silently cold-starting them.
            print(f"prewarm: skipping unreadable dryrun record {f}: {e}",
                  file=sys.stderr)
            continue
        out.extend(rec.get("plan_inits") or [])
    return dedupe_requests(out)


def requests_from_profile(arch: str, shape_name: str, mesh_dims,
                          reduced: bool = True,
                          seq_len: int | None = None,
                          global_batch: int | None = None,
                          device=None) -> list[dict]:
    """Capture the INIT requests behind one launch profile by building its
    step bundle (``launch.steps.make_bundle``: the train bundle for a train
    shape, the prefill or decode bundle as ``ServeEngine`` builds it) on a
    ``VirtualMesh`` of ``mesh_dims`` on ``device`` (default the card)."""
    from ..configs import SHAPES, ShapeConfig, get, get_reduced
    from ..core import capture_init_requests
    from ..launch import steps as steps_mod
    from ..launch.mesh import make_mesh

    base = SHAPES[shape_name]
    cfg = get_reduced(arch) if reduced else get(arch)
    shape = ShapeConfig(shape_name, base.kind,
                        seq_len or (256 if reduced else base.seq_len),
                        global_batch or (8 if reduced else base.global_batch))
    dims = tuple(int(d) for d in mesh_dims)
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = make_mesh(dims, axes, device=device)
    with capture_init_requests() as reqs:
        steps_mod.make_bundle(cfg, shape, mesh)
    return dedupe_requests(reqs)


def init_from_request(req: dict, store, cache=None,
                      autotune_iters: int | None = None, device=None):
    """Run one captured INIT against ``store`` on a ``VirtualMesh`` of the
    request's axes on ``device`` (default the card) and return the plan
    (cold builds publish, warm hits load)."""
    import numpy as np

    from ..core import PlanCache, exchange_init
    from ..launch.mesh import VirtualMesh

    sizes = tuple(int(s) for s in req["axis_sizes"])
    mesh = VirtualMesh(sizes, tuple(req["axis"]), device=device)
    return exchange_init(
        req.get("collective", "alltoallv"),    # older captures
        np.asarray(req["send_counts"], np.int64),
        tuple(req["feature_shape"]),
        req["dtype"],
        mesh,
        axis=tuple(req["axis"]),
        variant=req["variant"],
        lock_schedule=req.get("lock_schedule", "ring"),
        tile_rows=req.get("tile_rows"),
        pack_impl=req.get("pack_impl", "jnp"),
        baked_metadata=req.get("baked_metadata", True),
        cache=cache if cache is not None else PlanCache(),
        store=store,
        autotune_iters=(autotune_iters if autotune_iters is not None
                        else req.get("autotune_iters", 8)),
        embeddable=req.get("embeddable", False),
        codec=req.get("codec", "identity"),
        error_tol=req.get("error_tol"),
        hier_leader_perm=req.get("hier_leader_perm"),
    )


def replay_request(req: dict, store, cache=None,
                   autotune_iters: int | None = None, device=None) -> dict:
    """Run one captured INIT against ``store`` (``init_from_request``).
    Returns a per-request report row."""
    sizes = [int(s) for s in req["axis_sizes"]]
    plan = init_from_request(req, store, cache=cache,
                             autotune_iters=autotune_iters, device=device)
    row = {"digest": plan.signature.digest,
           "collective": plan.spec.collective,
           "variant": plan.spec.variant,
           "codec": plan.spec.codec,
           "requested_variant": req["variant"],
           "p": plan.p, "axis_sizes": sizes,
           "device": str(plan.mesh.device),
           "warm": bool(plan.warm_loaded)}
    if req.get("resharded_from"):
        # Elastic-resume replays stamp the geometry the pattern was
        # projected from; surface it so a prewarm report distinguishes
        # resharded plans from native captures.
        row["resharded_from"] = req["resharded_from"]
    return row


def prewarm(requests: Iterable[dict], store,
            autotune_iters: int | None = None, device=None) -> dict:
    """Replay every request against ``store`` on ``device`` through one
    shared ``PlanCache`` (duplicate patterns across cells bake once) and
    return a publish report.  ``skipped`` stays empty: every request
    replays on the one device (see the module docstring); the key is kept
    for the JAX report's shape."""
    from ..core import PlanCache, init_stats

    cache = PlanCache()
    rows = [replay_request(req, store, cache=cache,
                           autotune_iters=autotune_iters, device=device)
            for req in dedupe_requests(requests)]
    return {"prewarmed": rows, "skipped": [],
            "init_stats": init_stats(), "store": store.stats}
