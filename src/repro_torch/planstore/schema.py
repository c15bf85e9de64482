"""Versioned schema for persisted INIT artifacts (port of
``repro.planstore.schema``).

One store entry = one ``PatternSignature`` worth of INIT output:

  * the host-baked pack/unpack index tables (``metadata.BakedIndexTables``)
    for the fence/lock variants,
  * the leader-combined two-stage schedule (``metadata.HierSchedule``) for
    ``fence_hierarchy`` — scalars, round permutations, and all eight gather
    tables,
  * a ``variant="auto"`` decision (winner + per-candidate timings),
  * an optional break-even fit (Eq. 1-3 terms measured for the pattern).

Entries are content-addressed: the store key hashes the signature digest
(which already covers the counts matrix and every spec field that changes
the compiled program) together with every environment component that could
silently invalidate baked tables or measured decisions — ``SCHEMA_VERSION``,
the torch version, the repro package version, the **device kind** and the
mesh ``axis_sizes``.  Any of those changing yields a different key, so a
stale artifact is simply never found; the loader additionally re-validates
the same fields from the entry's own metadata (defense against hand-copied
or corrupted files) and treats any mismatch as a miss.

Where the JAX package keys on the jax version and the process's XLA
backend, the port keys on the torch version and the device kind of the
INIT being served: ``torch.cuda.get_device_name(device)`` on a card,
``"cpu"`` otherwise.  One process holds CPU and card plans side by side
(``VirtualMesh(..., device=...)``), so the kind comes from the mesh's
device, never from a process default: timings measured on the CPU's plain
versions must never pin a variant for the card, or the reverse.  The
container format is the JAX package's, but the environment keys are named
``torch_version`` and ``device_kind``: either package decodes the other's
files and its validation rejects them (the absent keys read as
``"<missing>"``), so a file never warms across packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from .._version import __version__ as REPRO_VERSION
from ..core import metadata as md

# The JAX package's schema generations (v2: the wire codec in
# signature_meta; v3: the leader permutation in signature_meta and the
# hierarchy payload; additive in v3: the collective family, absent keys
# normalized to "alltoallv" on read).
SCHEMA_VERSION = 3


class ArtifactError(Exception):
    """An on-disk entry cannot be trusted: corrupt, truncated, or written
    under a different schema/torch/repro version, device kind or mesh
    factorization.  The store converts this into a cache miss — a cold INIT
    — never a crash."""


def torch_version() -> str:
    import torch

    return torch.__version__


def device_kind(device=None) -> str:
    """The kind of ``device`` a plan lives on: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    CPU or None.  Part of the store key: tables and decisions of one kind
    are never served to an INIT on another."""
    import torch

    if device is None:
        return "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def store_key(
    sig: "md.PatternSignature",
    *,
    torch_ver: str | None = None,
    repro_ver: str | None = None,
    kind: str | None = None,
) -> str:
    """Content address of one signature under the current environment
    (``kind`` defaults to the CPU's)."""
    h = hashlib.sha256()
    h.update(sig.digest.encode())
    h.update(str((
        SCHEMA_VERSION,
        torch_ver if torch_ver is not None else torch_version(),
        repro_ver if repro_ver is not None else REPRO_VERSION,
        kind if kind is not None else device_kind(),
        tuple(int(s) for s in sig.axis_sizes),
        sig.variant,
        sig.p,
    )).encode())
    # The digest prefix keeps filenames greppable by pattern; the sha256
    # suffix carries the environment key components.
    return f"{sig.digest}-{h.hexdigest()[:24]}"


def signature_meta(sig: "md.PatternSignature") -> dict:
    """JSON-serializable echo of the signature, stored for validation."""
    return {
        "digest": sig.digest,
        "p": sig.p,
        "feature_shape": list(sig.feature_shape),
        "dtype": sig.dtype,
        "variant": sig.variant,
        "axis": list(sig.axis),
        "total_recv_bytes": sig.total_recv_bytes,
        "axis_sizes": [int(s) for s in sig.axis_sizes],
        "codec": sig.codec,
        "hier_leader_perm": [list(row) for row in sig.hier_leader_perm],
        "collective": sig.collective,
    }


@dataclasses.dataclass
class PlanArtifact:
    """Decoded store entry (see module docstring for the payload kinds)."""

    signature: dict                                   # signature_meta() echo
    schema_version: int = SCHEMA_VERSION
    torch_version: str = ""
    repro_version: str = REPRO_VERSION
    device_kind: str = "cpu"
    created_at: float = 0.0
    index_tables: "md.BakedIndexTables | None" = None
    hier_schedule: "md.HierSchedule | None" = None
    auto_choice: dict | None = None                   # {"variant", "times"}
    breakeven: dict | None = None                     # Eq. 1-3 fit terms

    def __post_init__(self):
        if not self.torch_version:
            self.torch_version = torch_version()
        if not self.created_at:
            self.created_at = time.time()

    @property
    def payload_kind(self) -> str:
        if self.hier_schedule is not None:
            return "hier_schedule"
        if self.index_tables is not None:
            return "baked_tables"
        return "meta_only"

    def validate_against(
        self,
        sig: "md.PatternSignature",
        *,
        torch_ver: str | None = None,
        repro_ver: str | None = None,
        kind: str | None = None,
    ) -> None:
        """Raise ArtifactError on any key-component mismatch.

        The content address normally makes a mismatch unreachable; this
        check catches entries copied between store directories, partial
        writes that survived, files of the JAX package, and deliberate
        tampering in tests.
        """
        want_torch = torch_ver if torch_ver is not None else torch_version()
        want_repro = repro_ver if repro_ver is not None else REPRO_VERSION
        want_kind = kind if kind is not None else device_kind()
        if self.schema_version != SCHEMA_VERSION:
            raise ArtifactError(
                f"schema_version {self.schema_version} != {SCHEMA_VERSION}")
        if self.torch_version != want_torch:
            raise ArtifactError(
                f"torch version {self.torch_version!r} != {want_torch!r}")
        if self.repro_version != want_repro:
            raise ArtifactError(
                f"repro version {self.repro_version!r} != {want_repro!r}")
        if self.device_kind != want_kind:
            raise ArtifactError(
                f"device kind {self.device_kind!r} != {want_kind!r}")
        want = signature_meta(sig)
        got = dict(self.signature)
        # Entries written before the collective field existed are all
        # alltoallv by construction — normalize instead of invalidating.
        got.setdefault("collective", "alltoallv")
        if got != want:
            raise ArtifactError(f"signature mismatch: {got} != {want}")

    def summary(self) -> dict:
        return {
            "digest": self.signature.get("digest"),
            "collective": self.signature.get("collective", "alltoallv"),
            "variant": self.signature.get("variant"),
            "p": self.signature.get("p"),
            "axis_sizes": self.signature.get("axis_sizes"),
            "payload": self.payload_kind,
            "codec": self.signature.get("codec", "identity"),
            "auto_choice": (self.auto_choice or {}).get("variant"),
            "auto_codec": (self.auto_choice or {}).get("codec"),
            "has_breakeven": self.breakeven is not None,
            "torch_version": self.torch_version,
            "repro_version": self.repro_version,
            "device_kind": self.device_kind,
            "schema_version": self.schema_version,
            "created_at": self.created_at,
        }


def tables_nbytes(art: PlanArtifact) -> int:
    n = 0
    if art.index_tables is not None:
        t = art.index_tables
        n += sum(np.asarray(a).nbytes for a in
                 (t.pack_src, t.pack_valid, t.unpack_src, t.unpack_valid))
    if art.hier_schedule is not None:
        n += sum(t.nbytes for t in art.hier_schedule.tables)
    return n
