"""Plan stores: the persistent tiers behind the in-memory ``PlanCache``
(port of ``repro.planstore.store``).

Design constraints (the serving deployment this exists for):

  * **Concurrent multi-process safety.**  Publishes are atomic at the
    backend (tmp + ``os.replace`` for directories) — readers either see the
    old complete entry, the new complete entry, or nothing; never a torn
    write.  Readers keep working on an entry that eviction unlinks
    underneath them (POSIX fd semantics).  Read-modify-write merges
    (``attach_breakeven``, ``put_auto``) use backend conditional puts
    (generation tokens) with a bounded retry loop, so a concurrent publish
    is merged with, never silently overwritten.
  * **Corruption is a miss, never a crash.**  Any load failure — truncated
    entry, garbage bytes, schema/torch/repro/device-kind or signature
    mismatch — increments ``store_invalid``, removes the bad entry (best
    effort), and returns ``None`` so INIT falls back to the cold bake path.  An entry
    that simply vanished between the existence check and the load (another
    process's eviction) counts as a plain miss, and a transiently
    unreachable remote counts as a miss too (``errors`` tracks them).
  * **Bounded size.**  LRU by entry mtime: reads touch the entry, puts
    evict the oldest entries beyond ``max_entries`` / ``max_bytes``.

Storage is pluggable (``backend.StoreBackend``): ``PlanStore`` over a
``LocalDirBackend`` is the classic single-host directory with ``np.memmap``
warm loads; over a ``RemoteBackend`` it speaks generic object-store
key/value bytes; ``TieredPlanStore`` composes both — a local directory
cache read-through in front of a fleet-shared remote, with write-back
publish — so the memmap fast path survives fleet sharing.

The default store is process-global and opt-in: ``configure(url)`` (wired
to the ``--plan-store`` launcher flags) or the ``REPRO_TORCH_PLANSTORE_DIR``
environment variable; both accept plain directory paths and store URLs
(``fsremote://…``, ``tiered:local=…,remote=…`` — see ``parse_store_url``).
When neither is set, ``default_store()`` is None and every INIT is cold —
exactly the pre-planstore behavior.

Every key carries the device kind of the INIT it serves
(``schema.device_kind``): each read and write takes the ``device`` of the
plan's mesh (``PlanCache.get`` and ``autotune_variant`` pass it), so one
store directory keeps a process's CPU and card artifacts apart.  A store
built with ``device_kind=`` pins every key to that kind instead (a store
written on another device, in tests).
"""

from __future__ import annotations

import os
import random
import time
import urllib.parse
from typing import Any, Callable

from ..core import metadata as md
from ..core._init_stats import INIT_STATS
from ..obs.spans import TRACER

from . import codec
from .backend import (ABSENT, FsRemoteBackend, GenerationConflict,
                      LocalDirBackend, RemoteBackend, RemoteUnavailable,
                      StoreBackend)
from .schema import (REPRO_VERSION, ArtifactError, PlanArtifact, device_kind,
                     signature_meta, store_key, torch_version)


class PlanStore:
    """Content-addressed store of INIT artifacts (one codec flat-container
    entry per ``PatternSignature``) over a pluggable ``StoreBackend``."""

    def __init__(
        self,
        root: "str | os.PathLike | StoreBackend",
        max_entries: int = 256,
        max_bytes: int = 1 << 30,
        torch_ver: str | None = None,
        repro_ver: str | None = None,
        device_kind: str | None = None,
    ):
        """``root`` is a directory path (→ ``LocalDirBackend``, today's
        on-disk semantics) or any ``StoreBackend`` instance.
        ``device_kind`` None keys each call on the kind of its ``device``;
        a string pins every key to that kind."""
        if isinstance(root, StoreBackend):
            self.store_backend = root
        else:
            self.store_backend = LocalDirBackend(root)
        self.root = self.store_backend.describe()
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        # Overridable for tests (simulate a store written by another
        # torch/repro build or on another device); production code leaves
        # these at the live values.
        self.torch_ver = torch_ver if torch_ver is not None else torch_version()
        self.repro_ver = repro_ver if repro_ver is not None else REPRO_VERSION
        self.device_kind = device_kind
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.invalid = 0
        self.evictions = 0
        self.errors = 0          # transient backend faults degraded to misses

    # -- addressing ---------------------------------------------------------
    def kind_for(self, device=None) -> str:
        """The device kind keys and entries carry for an INIT on
        ``device`` (the pinned kind, if the store has one)."""
        return (self.device_kind if self.device_kind is not None
                else device_kind(device))

    def key_for(self, sig: "md.PatternSignature", device=None) -> str:
        return store_key(sig, torch_ver=self.torch_ver,
                         repro_ver=self.repro_ver, kind=self.kind_for(device))

    def path_for(self, sig: "md.PatternSignature", device=None) -> str | None:
        """Entry file path when the backend exposes one (local dirs), else
        None (remote object stores have no filesystem view)."""
        return self.store_backend.local_path(self.key_for(sig, device))

    def _validate(self, art: PlanArtifact, sig: "md.PatternSignature",
                  device=None) -> None:
        art.validate_against(sig, torch_ver=self.torch_ver,
                             repro_ver=self.repro_ver,
                             kind=self.kind_for(device))

    # -- read side ----------------------------------------------------------
    def _load_key(self, key: str) -> PlanArtifact:
        """Decode one entry by key: memmap through the backend's local path
        when it has one, else the ``codec.loads`` bytes path.  Raises
        ArtifactError on any defect, FileNotFoundError on absence."""
        path = self.store_backend.local_path(key)
        if path is not None:
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            return codec.load(path)
        data = self.store_backend.get_bytes(key)
        if data is None:
            raise FileNotFoundError(key)
        return codec.loads(data)

    def get(self, sig: "md.PatternSignature", device=None) -> PlanArtifact | None:
        """Load + validate the entry for ``sig`` on ``device``; None on miss
        or any defect."""
        with TRACER.span("store_get", "store", backend=self.root) as sp:
            art = self._get(sig, sp, device)
            if "result" not in sp.args:
                sp.args["result"] = "hit" if art is not None else "miss"
            return art

    def _get(self, sig: "md.PatternSignature", sp,
             device=None) -> PlanArtifact | None:
        key = self.key_for(sig, device)
        try:
            art = self._load_key(key)
        except FileNotFoundError:
            self.misses += 1
            INIT_STATS.bump("store_misses")
            return None
        except RemoteUnavailable:
            self.errors += 1
            self.misses += 1
            INIT_STATS.bump("store_misses")
            sp.args["result"] = "error"
            return None
        except ArtifactError:
            art = None
        if art is not None:
            try:
                self._validate(art, sig, device)
            except ArtifactError:
                art = None
        if art is None:
            path = self.store_backend.local_path(key)
            if path is not None and not os.path.exists(path):
                # Vanished underneath us (another process's eviction): a
                # plain miss, not corruption.
                self.misses += 1
                INIT_STATS.bump("store_misses")
                return None
            self.invalid += 1
            INIT_STATS.bump("store_invalid")
            sp.args["result"] = "invalid"
            try:
                self.store_backend.delete(key)
            except OSError:
                pass
            return None
        try:
            self.store_backend.touch(key)     # LRU touch
        except OSError:
            pass
        self.hits += 1
        INIT_STATS.bump("store_hits")
        return art

    def get_auto(self, sig: "md.PatternSignature", device=None) -> dict | None:
        art = self.get(sig, device)
        return art.auto_choice if art is not None else None

    # -- write side ---------------------------------------------------------
    def _stamp(self, art: PlanArtifact, device=None) -> PlanArtifact:
        # Stamp the store's environment notion so key and metadata always
        # agree (matters when torch_ver/repro_ver/device_kind are
        # overridden in tests).
        art.torch_version = self.torch_ver
        art.repro_version = self.repro_ver
        art.device_kind = self.kind_for(device)
        return art

    def put_artifact(self, sig: "md.PatternSignature",
                     art: PlanArtifact, device=None) -> str:
        """Atomically publish ``art`` under ``sig``'s key on ``device``;
        returns the entry path (local backends) or key."""
        key = self.key_for(sig, device)
        with TRACER.span("store_put", "store", backend=self.root):
            self.store_backend.put_bytes(
                key, codec.dumps(self._stamp(art, device)))
        self.puts += 1
        INIT_STATS.bump("store_puts")
        self._evict()
        return self.store_backend.local_path(key) or key

    def put_plan(self, sig: "md.PatternSignature", plan: Any,
                 device=None) -> str | None:
        """Persist a cold-built plan's baked artifacts (no-op when the plan
        carries nothing reusable, e.g. ragged or in-graph A/B mode), keyed
        on ``device`` (default: the plan's mesh's).

        Runs through the conditional-put merge: a break-even fit attached
        to this entry before the tables existed (``attach_breakeven``
        creates meta-only entries) survives the table publish."""
        tables = getattr(plan, "index_tables", None)
        sched = getattr(plan, "hier_schedule", None)
        if tables is None and sched is None:
            return None
        if device is None:
            device = getattr(getattr(plan, "mesh", None), "device", None)

        def mutate(art: PlanArtifact) -> None:
            art.index_tables = tables
            art.hier_schedule = sched
        return self._merge_publish(sig, mutate, device=device)

    def _merge_publish(self, sig: "md.PatternSignature",
                       mutate: Callable[[PlanArtifact], None],
                       retries: int = 25, device=None) -> str:
        """Read-modify-write under the backend's conditional put: load the
        current entry (or start fresh), apply ``mutate``, publish only if
        the entry has not changed since the read — retrying a bounded
        number of times on conflict (with a short randomized backoff, so
        spinning writers desynchronize instead of starving one another) so
        a concurrent publish is merged with instead of dropped.  Raises
        ``GenerationConflict`` when the key is still churning after
        ``retries`` attempts."""
        key = self.key_for(sig, device)
        last_conflict: GenerationConflict | None = None
        with TRACER.span("store_merge", "store", backend=self.root) as sp:
            for attempt in range(max(1, int(retries))):
                data, gen = self.store_backend.get_with_generation(key)
                art = None
                if data is not None:
                    try:
                        art = codec.loads(data)
                        self._validate(art, sig, device)
                    except ArtifactError:
                        art = None   # corrupt/foreign entry: replace wholesale
                if art is None:
                    art = PlanArtifact(signature=signature_meta(sig))
                mutate(art)
                try:
                    self.store_backend.put_bytes(
                        key, codec.dumps(self._stamp(art, device)),
                        if_generation=gen)
                except GenerationConflict as e:
                    last_conflict = e
                    time.sleep(random.random()
                               * min(0.002 * (attempt + 1), 0.05))
                    continue
                self.puts += 1
                INIT_STATS.bump("store_puts")
                self._evict()
                sp.args["attempts"] = attempt + 1
                return self.store_backend.local_path(key) or key
            sp.args["attempts"] = max(1, int(retries))
            sp.args["result"] = "conflict"
        raise last_conflict if last_conflict is not None else GenerationConflict(
            f"merge of {key} never converged")

    def put_auto(self, sig: "md.PatternSignature", choice: dict,
                 device=None) -> str:
        """Publish a ``variant="auto"`` decision measured on ``device``,
        merging into the existing entry (a concurrently attached break-even
        fit survives)."""
        def mutate(art: PlanArtifact) -> None:
            art.auto_choice = dict(choice)
        return self._merge_publish(sig, mutate, device=device)

    def attach_breakeven(self, sig: "md.PatternSignature", fit: dict,
                         retries: int = 10, device=None) -> str:
        """Merge an Eq. 1-3 fit into the pattern's entry; creates a
        metadata-only entry when none exists.

        The merge runs under the backend's conditional put with a bounded
        retry loop, so an auto decision (or tables) published concurrently
        by another process is re-read and preserved — the pre-backend
        implementation was last-writer-wins and could silently drop it,
        which a fleet-shared store makes likely rather than rare."""
        def mutate(art: PlanArtifact) -> None:
            art.breakeven = {k: float(v) for k, v in fit.items()}
        return self._merge_publish(sig, mutate, retries=retries,
                                   device=device)

    # -- maintenance --------------------------------------------------------
    def entries(self) -> list[dict]:
        out = []
        try:
            keys = self.store_backend.keys()
        except RemoteUnavailable:
            self.errors += 1
            return []
        for key in keys:
            try:
                st = self.store_backend.stat(key)
            except RemoteUnavailable:
                self.errors += 1
                continue
            if st is None:
                continue
            out.append({"key": key, "path": self.store_backend.local_path(key),
                        "bytes": st["bytes"], "mtime": st["mtime"]})
        return out

    def purge(self) -> int:
        n = 0
        for e in self.entries():
            try:
                self.store_backend.delete(e["key"])
                n += 1
            except OSError:
                pass
        return n

    def _evict(self) -> None:
        if isinstance(self.store_backend, RemoteBackend):
            # A fleet-shared remote must not be LRU-trimmed to any single
            # client's local limits (one replica's default max_entries would
            # silently evict artifacts the rest of the fleet still needs),
            # and the list+stat sweep would cost N+1 remote round trips per
            # publish.  Remote lifecycle belongs to the object store's own
            # retention policy; ``purge`` stays available for operators.
            return
        sweep = getattr(self.store_backend, "sweep_stale_tmp", None)
        if sweep is not None:
            sweep()
        ents = sorted(self.entries(), key=lambda e: e["mtime"])
        total = sum(e["bytes"] for e in ents)
        while ents and (len(ents) > self.max_entries or total > self.max_bytes):
            victim = ents.pop(0)
            try:
                self.store_backend.delete(victim["key"])
                self.evictions += 1
            except OSError:
                pass
            total -= victim["bytes"]

    @property
    def stats(self) -> dict:
        return {"root": self.root, "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "invalid": self.invalid,
                "evictions": self.evictions, "errors": self.errors,
                "entries": len(self.entries())}


class TieredPlanStore:
    """Local directory cache read-through in front of a remote store, with
    write-back publish — the fleet-shared deployment shape.

    * ``get`` consults the local tier first (memmap warm loads, exactly the
      single-host fast path).  On a local miss the remote tier is read at
      the *bytes* level; a validated hit is promoted — the raw entry bytes
      are copied into the local directory — and the artifact is re-loaded
      from the local file so its tables are ``np.memmap`` views, not
      heap-resident copies of a network payload.  Subsequent gets are pure
      local hits.
    * ``put`` publishes to both tiers: the local cache immediately (the
      building process re-reads its own artifacts), the remote best-effort
      (``remote_errors`` counts faults; a flaky remote never fails INIT).
    * merges (``attach_breakeven``, ``put_auto``) run the conditional-put
      retry loop against the authoritative remote tier, then refresh the
      local copy.

    Duck-types ``PlanStore`` for every consumer (``PlanCache.get``,
    ``autotune_variant``, benchmarks, the CLI)."""

    def __init__(self, local: "PlanStore | str | os.PathLike | StoreBackend",
                 remote: "PlanStore | str | os.PathLike | StoreBackend",
                 **kw):
        self.local = local if isinstance(local, PlanStore) else PlanStore(local, **kw)
        self.remote = remote if isinstance(remote, PlanStore) else PlanStore(remote, **kw)
        if (self.local.torch_ver, self.local.repro_ver,
                self.local.device_kind) != (
                self.remote.torch_ver, self.remote.repro_ver,
                self.remote.device_kind):
            raise ValueError("tiered store needs identical key environments "
                             "(torch/repro/device kind) in both tiers")
        self.root = f"tiered:local={self.local.root},remote={self.remote.root}"
        self.promotions = 0
        self.remote_errors = 0

    # -- addressing ---------------------------------------------------------
    def kind_for(self, device=None) -> str:
        return self.local.kind_for(device)

    def key_for(self, sig: "md.PatternSignature", device=None) -> str:
        return self.local.key_for(sig, device)

    def path_for(self, sig: "md.PatternSignature", device=None) -> str | None:
        return self.local.path_for(sig, device)

    # -- read side ----------------------------------------------------------
    def get(self, sig: "md.PatternSignature", device=None) -> PlanArtifact | None:
        art = self.local.get(sig, device)
        if art is not None:
            return art
        with TRACER.span("store_get_remote", "store",
                         backend=self.remote.root) as sp:
            art = self._get_remote(sig, sp, device)
            if "result" not in sp.args:
                sp.args["result"] = "hit" if art is not None else "miss"
            return art

    def _get_remote(self, sig: "md.PatternSignature", sp,
                    device=None) -> PlanArtifact | None:
        key = self.remote.key_for(sig, device)
        try:
            data = self.remote.store_backend.get_bytes(key)
        except RemoteUnavailable:
            self.remote_errors += 1
            self.remote.errors += 1
            sp.args["result"] = "error"
            return None
        if data is None:
            # The logical miss was already counted by local.get above;
            # bumping INIT_STATS again would double-count one lookup.
            self.remote.misses += 1
            return None
        try:
            art = codec.loads(data)
            self.remote._validate(art, sig, device)
        except ArtifactError:
            self.remote.invalid += 1
            INIT_STATS.bump("store_invalid")
            sp.args["result"] = "invalid"
            try:
                self.remote.store_backend.delete(key)
            except OSError:
                pass
            return None
        self.remote.hits += 1
        INIT_STATS.bump("store_hits")
        try:
            self.remote.store_backend.touch(key)
        except OSError:
            pass
        # Promote: raw bytes into the local tier, then re-load off the local
        # file so the returned tables are memmaps (stat counters untouched —
        # this is one logical hit, not three).
        try:
            local_key = self.local.key_for(sig, device)
            self.local.store_backend.put_bytes(local_key, data)
            self.local._evict()
            self.promotions += 1
            path = self.local.store_backend.local_path(local_key)
            if path is None:
                return art        # bytes-only local tier: no memmap to gain
            promoted = codec.load(path)
            self.local._validate(promoted, sig, device)
            return promoted
        except (OSError, ArtifactError):
            return art            # promotion is an optimization, never a gate

    def get_auto(self, sig: "md.PatternSignature", device=None) -> dict | None:
        art = self.get(sig, device)
        return art.auto_choice if art is not None else None

    # -- write side ---------------------------------------------------------
    def put_artifact(self, sig: "md.PatternSignature",
                     art: PlanArtifact, device=None) -> str:
        out = self.local.put_artifact(sig, art, device)
        try:
            self.remote.put_artifact(sig, art, device)
        except OSError:
            self.remote_errors += 1
        return out

    def put_plan(self, sig: "md.PatternSignature", plan: Any,
                 device=None) -> str | None:
        out = self.local.put_plan(sig, plan, device)
        if out is None:
            return None
        try:
            self.remote.put_plan(sig, plan, device)
        except OSError:
            self.remote_errors += 1
        return out

    def _refresh_local(self, sig: "md.PatternSignature",
                       device=None) -> str | None:
        """Mirror the remote's current entry into the local tier (raw
        bytes), so a merge that ran against the authoritative remote leaves
        the local cache carrying the *merged* entry — an independent local
        merge could otherwise create a poorer (e.g. meta-only) local entry
        that shadows the richer remote one on every later get."""
        key = self.remote.key_for(sig, device)
        data = self.remote.store_backend.get_bytes(key)
        if data is None:
            return None
        local_key = self.local.key_for(sig, device)
        self.local.store_backend.put_bytes(local_key, data)
        self.local._evict()
        return self.local.store_backend.local_path(local_key) or local_key

    def put_auto(self, sig: "md.PatternSignature", choice: dict,
                 device=None) -> str:
        try:
            out = self.remote.put_auto(sig, choice, device)
        except OSError:
            self.remote_errors += 1
            # remote down: local only
            return self.local.put_auto(sig, choice, device)
        try:
            return self._refresh_local(sig, device) or out
        except OSError:
            return out

    def attach_breakeven(self, sig: "md.PatternSignature", fit: dict,
                         retries: int = 25, device=None) -> str:
        try:
            out = self.remote.attach_breakeven(sig, fit, retries=retries,
                                               device=device)
        except OSError:
            self.remote_errors += 1
            return self.local.attach_breakeven(sig, fit, retries=retries,
                                               device=device)
        try:
            return self._refresh_local(sig, device) or out
        except OSError:
            return out

    # -- maintenance --------------------------------------------------------
    def entries(self) -> list[dict]:
        seen = {e["key"]: e for e in self.remote.entries()}
        for e in self.local.entries():
            seen[e["key"]] = e
        return sorted(seen.values(), key=lambda e: e["key"])

    def purge(self) -> int:
        return self.local.purge() + self.remote.purge()

    @property
    def stats(self) -> dict:
        return {"root": self.root, "promotions": self.promotions,
                "remote_errors": self.remote_errors,
                "local": self.local.stats, "remote": self.remote.stats,
                # aggregate view so existing consumers keep reading the
                # usual counters off a tiered store
                "hits": self.local.hits + self.remote.hits,
                "misses": self.local.misses + self.remote.misses,
                "puts": self.local.puts + self.remote.puts,
                "invalid": self.local.invalid + self.remote.invalid,
                "errors": self.local.errors + self.remote.errors,
                "entries": len(self.entries())}


# --- URL-scheme store construction ------------------------------------------

def parse_store_url(url: "str | os.PathLike | PlanStore | TieredPlanStore",
                    **kw) -> "PlanStore | TieredPlanStore":
    """Build a store from a locator string:

    * a plain directory path (or ``file://PATH``) → local ``PlanStore``
      (today's semantics, unchanged);
    * ``fsremote://PATH[?latency_ms=F&fail_rate=F&seed=N]`` → ``PlanStore``
      over the filesystem-emulated remote object store (bytes path only,
      injectable latency/faults);
    * ``tiered:local=PATH,remote=URL`` → ``TieredPlanStore`` (local cache
      read-through in front of the remote, write-back publish).

    Extra keyword arguments (``max_entries``, ``torch_ver``, …) apply to
    every store the URL constructs.  Existing store instances pass through
    untouched.
    """
    if isinstance(url, (PlanStore, TieredPlanStore)):
        return url
    s = os.fspath(url)
    if s.startswith("tiered:"):
        body = s[len("tiered:"):]
        if not body.startswith("local="):
            raise ValueError(
                f"tiered store URL must be tiered:local=PATH,remote=URL, got {s!r}")
        local_part, sep, remote_part = body[len("local="):].partition(",remote=")
        if not sep or not local_part or not remote_part:
            raise ValueError(
                f"tiered store URL must be tiered:local=PATH,remote=URL, got {s!r}")
        return TieredPlanStore(parse_store_url(local_part, **kw),
                               parse_store_url(remote_part, **kw))
    if s.startswith("fsremote://"):
        rest = s[len("fsremote://"):]
        path, _, query = rest.partition("?")
        if not path:
            raise ValueError(f"fsremote URL needs a path, got {s!r}")
        opts = {k: v[-1] for k, v in urllib.parse.parse_qs(query).items()}
        be = FsRemoteBackend(path,
                             latency_ms=float(opts.pop("latency_ms", 0.0)),
                             fail_rate=float(opts.pop("fail_rate", 0.0)),
                             seed=int(opts.pop("seed", 0)))
        if opts:
            raise ValueError(f"unknown fsremote option(s) {sorted(opts)}")
        return PlanStore(be, **kw)
    if s.startswith("file://"):
        s = s[len("file://"):]
    return PlanStore(s, **kw)


# --- process-global default store (opt-in) ---------------------------------

# The port's own variable: a store configured for the JAX package does not
# switch the port's on, or the reverse.
ENV_VAR = "REPRO_TORCH_PLANSTORE_DIR"

_default: "PlanStore | TieredPlanStore | None" = None
_configured = False


def configure(root: "str | os.PathLike | PlanStore | TieredPlanStore | None",
              **kw) -> "PlanStore | TieredPlanStore | None":
    """Set the process default store (None disables).  Accepts a directory
    path, a store URL (see ``parse_store_url``), or an existing store.
    Launcher ``--plan-store`` flags and ``ServeEngine(plan_store=...)``
    land here."""
    global _default, _configured
    _configured = True
    if root is None:
        _default = None
    else:
        _default = parse_store_url(root, **kw)
    return _default


def default_store() -> "PlanStore | TieredPlanStore | None":
    """The configured default store, else one bootstrapped from
    ``REPRO_TORCH_PLANSTORE_DIR`` (a path or store URL), else None (warm-start
    disabled)."""
    global _default, _configured
    if not _configured:
        _configured = True
        root = os.environ.get(ENV_VAR)
        _default = parse_store_url(root) if root else None
    return _default
