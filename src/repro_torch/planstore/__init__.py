"""Persistent plan store: cross-process warm-start for INIT artifacts
(port of ``repro.planstore``).

The paper's INIT/EXECUTE split amortizes metadata cost over the iterations
of one run; this package extends the amortization across *runs* and across
*hosts*.  A content-addressed store holds everything INIT computes that is
expensive and pattern-frozen — baked pack/unpack index tables, two-stage
hierarchy schedules, ``variant="auto"`` decisions, break-even fits — keyed
on the ``PatternSignature`` digest plus schema/torch/repro versions, the
device kind of the INIT (the card's name or "cpu") and the mesh
``axis_sizes``.  A warm hit makes a second process's INIT skip the
table bakes and the autotune measurement sweep entirely.

Storage is pluggable (``backend.StoreBackend``): a local directory (memmap
warm loads), a remote object store (``fsremote://`` is the in-repo
emulated double), or both tiered (``TieredPlanStore``: local cache
read-through, write-back publish) for fleet-shared deployments:

    from repro_torch.planstore import PlanStore, parse_store_url
    store = PlanStore("~/.cache/repro_torch/planstore")    # local dir
    store = parse_store_url("tiered:local=.planstore,"
                            "remote=fsremote:///shared/planstore")
    plan = alltoallv_init(counts, (256,), torch.float32, mesh,
                          axis=("o", "i"), variant="auto", store=store)

or process-globally (what ``--plan-store`` launcher flags do — they accept
the same URL schemes):

    from repro_torch import planstore
    planstore.configure("~/.cache/repro_torch/planstore")

Deploy-time prewarm (``prewarm`` module): enumerate INIT requests from
dryrun cell records or serve profiles, replay them on the caller's device
against a store, and publish — a fresh replica's very first INIT is then
warm.

CLI:  ``python -m repro_torch.planstore {inspect,purge,warm-check,prewarm}``
"""

from .backend import (ABSENT, FsRemoteBackend, GenerationConflict,
                      LocalDirBackend, RemoteBackend, RemoteUnavailable,
                      StoreBackend)
from .schema import (ArtifactError, PlanArtifact, REPRO_VERSION,
                     SCHEMA_VERSION, device_kind, signature_meta, store_key)
from .store import (ENV_VAR, PlanStore, TieredPlanStore, configure,
                    default_store, parse_store_url)
from . import backend, codec, schema, store

__all__ = [
    "ABSENT", "ArtifactError", "FsRemoteBackend", "GenerationConflict",
    "LocalDirBackend", "PlanArtifact", "PlanStore", "RemoteBackend",
    "RemoteUnavailable", "REPRO_VERSION", "SCHEMA_VERSION", "ENV_VAR",
    "StoreBackend", "TieredPlanStore",
    "backend", "codec", "configure", "default_store", "device_kind",
    "parse_store_url", "schema", "signature_meta", "store", "store_key",
]
