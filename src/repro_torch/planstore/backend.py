"""Pluggable storage backends behind ``PlanStore`` (a copy of
``repro.planstore.backend``: plain Python, no JAX).

``PlanStore`` owns *policy* — content addressing, artifact validation,
corruption-is-a-miss, LRU eviction, stat counters — and delegates all byte
movement to a ``StoreBackend``:

  * ``LocalDirBackend``: today's on-disk semantics, unchanged — entries are
    ``<key>.plan`` files, writers stage in a uniquely named temp file and
    publish with ``os.replace`` (readers see old, new, or nothing; never a
    torn write), reads touch mtime for LRU, and ``local_path`` exposes the
    entry file so warm loads stay one-header-read ``np.memmap``s.
  * ``RemoteBackend``: generic object-store key/value semantics — no local
    paths, every load goes through the codec bytes path (``codec.loads``).
    Transient faults raise ``RemoteUnavailable`` (an ``OSError``): reads
    degrade to misses, writes stay best-effort.
  * ``FsRemoteBackend`` (URL scheme ``fsremote://``): the in-repo
    filesystem-emulated double of a remote object store, with injectable
    per-op latency and deterministic failure rates so remote behavior is
    testable without a network.

Every backend supports **conditional puts** via opaque generation tokens:
``get_with_generation`` returns the entry's current generation (or
``ABSENT``), and ``put_bytes(..., if_generation=token)`` publishes only if
the entry has not changed since — otherwise ``GenerationConflict``.  That
is the primitive ``PlanStore.attach_breakeven`` (and every other
read-modify-write merge) builds its bounded retry loop on, replacing the
old last-writer-wins behavior that could silently drop a concurrently
published auto decision.

For the directory-backed backends the generation token is the entry file's
``(inode, mtime_ns, size)`` fingerprint — ``os.replace`` always installs a
fresh inode, so any publish changes the token even under coarse mtime
granularity — and conditional puts serialize on an ``flock`` over a
per-store lock file (unconditional puts stay lock-free).
"""

from __future__ import annotations

import os
import random
import time
import uuid

_ENTRY_SUFFIX = ".plan"
_TMP_PREFIX = "tmp-"
_LOCK_NAME = ".lock"

#: Generation token meaning "the entry must not exist yet" (create-only put).
ABSENT = "absent"

#: Sentinel for ``put_bytes(if_generation=...)``: publish unconditionally.
UNCONDITIONAL = object()


class GenerationConflict(OSError):
    """A conditional put lost the race: the entry's generation no longer
    matches the token the caller read.  Retry from a fresh
    ``get_with_generation``."""


class RemoteUnavailable(OSError):
    """A remote backend operation failed transiently (network fault, object
    store hiccup, injected test failure).  ``PlanStore`` degrades reads to
    misses and keeps writes best-effort — never a crash in INIT."""


class StoreBackend:
    """Byte-level key/value contract ``PlanStore`` runs on.

    Keys are the store's content addresses (``schema.store_key`` output);
    values are whole codec-encoded entries.  Implementations must make
    ``put_bytes`` atomic (readers never observe a torn entry) and should
    treat ``delete``/``touch`` of a missing key as a no-op.
    """

    def describe(self) -> str:
        """Human-readable locator (shown in ``stats['root']`` and the CLI)."""
        raise NotImplementedError

    def keys(self) -> list[str]:
        raise NotImplementedError

    def stat(self, key: str) -> dict | None:
        """``{"bytes", "mtime"}`` for LRU accounting, or None when absent."""
        raise NotImplementedError

    def local_path(self, key: str) -> str | None:
        """Filesystem path of the entry when this backend can expose one
        (the ``np.memmap`` warm-load fast path), else None — the caller
        falls back to ``get_bytes`` + ``codec.loads``."""
        return None

    def get_bytes(self, key: str) -> bytes | None:
        raise NotImplementedError

    def generation(self, key: str) -> str:
        """Opaque generation token of the current entry (``ABSENT`` when
        the key does not exist)."""
        raise NotImplementedError

    def get_with_generation(self, key: str) -> tuple[bytes | None, str]:
        """Read entry bytes together with a generation token consistent
        with those bytes — the read half of a compare-and-swap."""
        raise NotImplementedError

    def put_bytes(self, key: str, data: bytes, *,
                  if_generation=UNCONDITIONAL) -> None:
        """Atomically publish ``data`` under ``key``.  With
        ``if_generation``, publish only if the entry's generation still
        matches the token (``ABSENT`` = create-only); raise
        ``GenerationConflict`` otherwise."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def touch(self, key: str) -> None:
        """Mark the entry recently used (LRU); best-effort."""
        raise NotImplementedError


# --- shared directory plumbing ----------------------------------------------

def _fingerprint(st: os.stat_result) -> str:
    return f"{st.st_ino}:{st.st_mtime_ns}:{st.st_size}"


def _dir_generation(path: str) -> str:
    try:
        return _fingerprint(os.stat(path))
    except OSError:
        return ABSENT


def _dir_get_with_generation(path: str) -> tuple[bytes | None, str]:
    # Token first, bytes second, token re-check third: if the entry was
    # replaced mid-read we loop, so the returned token is never *newer*
    # than the bytes (which would let a stale merge win a CAS).
    for _ in range(8):
        gen = _dir_generation(path)
        if gen == ABSENT:
            return None, ABSENT
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None, ABSENT
        if _dir_generation(path) == gen:
            return data, gen
    # Pathological churn: surface the last read with its PRE-read token.
    # The bytes may be newer than the token, never older — so a conditional
    # put against it can only conflict-and-retry, not overwrite a publish
    # that landed after the read (a post-read token could be newer than the
    # bytes and let a stale merge win the CAS).
    return data, gen


class _FlockGuard:
    """``flock``-scoped critical section over ``<root>/.lock`` (POSIX);
    degrades to lockless on platforms without fcntl — conditional puts are
    then only as atomic as the generation re-check."""

    def __init__(self, root: str):
        self._path = os.path.join(root, _LOCK_NAME)
        self._fd = None

    def __enter__(self):
        try:
            import fcntl
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            if self._fd is not None:
                os.close(self._fd)
            self._fd = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            try:
                import fcntl
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            except (ImportError, OSError):
                pass
            os.close(self._fd)
            self._fd = None
        return False


class _DirStorage:
    """Entry-file mechanics shared by the local backend and the fsremote
    double: atomic tmp+replace publish, fingerprint generations, stale-tmp
    sweeping."""

    def __init__(self, root: str | os.PathLike):
        self.root = os.path.abspath(os.path.expanduser(os.fspath(root)))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _ENTRY_SUFFIX)

    def keys(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(_ENTRY_SUFFIX) and not name.startswith(_TMP_PREFIX):
                out.append(name[:-len(_ENTRY_SUFFIX)])
        return out

    def stat(self, key: str) -> dict | None:
        try:
            st = os.stat(self._path(key))
        except OSError:
            return None
        return {"bytes": st.st_size, "mtime": st.st_mtime}

    def get_bytes(self, key: str) -> bytes | None:
        return _dir_get_with_generation(self._path(key))[0]

    def generation(self, key: str) -> str:
        return _dir_generation(self._path(key))

    def get_with_generation(self, key: str) -> tuple[bytes | None, str]:
        return _dir_get_with_generation(self._path(key))

    def _replace(self, key: str, data: bytes) -> None:
        tmp = os.path.join(
            self.root,
            f"{_TMP_PREFIX}{os.getpid()}-{uuid.uuid4().hex}{_ENTRY_SUFFIX}")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(key))
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def put_bytes(self, key: str, data: bytes, *,
                  if_generation=UNCONDITIONAL) -> None:
        if if_generation is UNCONDITIONAL:
            self._replace(key, data)
            return
        with _FlockGuard(self.root):
            current = _dir_generation(self._path(key))
            if current != if_generation:
                raise GenerationConflict(
                    f"{key}: generation {current} != expected {if_generation}")
            self._replace(key, data)

    def delete(self, key: str) -> None:
        # Missing keys are a no-op; real failures (permissions, read-only
        # filesystem) propagate so callers' accounting stays honest —
        # every caller already guards with ``except OSError``.
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def touch(self, key: str) -> None:
        try:
            os.utime(self._path(key))
        except OSError:
            pass

    def sweep_stale_tmp(self, max_age_seconds: float = 600.0) -> None:
        """Remove staging files left by writers that died between open and
        publish (SIGKILL/OOM skips the publish cleanup).  Age-gated so a
        live writer's in-flight tmp file is never yanked away."""
        cutoff = time.time() - max_age_seconds
        for name in os.listdir(self.root):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.root, name)
            try:
                if os.stat(path).st_mtime < cutoff:
                    os.remove(path)
            except OSError:
                pass


class LocalDirBackend(_DirStorage, StoreBackend):
    """A directory of ``<key>.plan`` entry files — the classic single-host
    store tier.  ``local_path`` exposes the entry file so ``PlanStore``
    keeps its read-only ``np.memmap`` warm loads."""

    def describe(self) -> str:
        return self.root

    def local_path(self, key: str) -> str:
        return self._path(key)


class RemoteBackend(StoreBackend):
    """Generic object-store semantics: keys map to whole-entry byte blobs,
    there is no local filesystem view (``local_path`` is None, so every
    load goes through ``codec.loads``), and any operation may raise
    ``RemoteUnavailable``.  Concrete fleets subclass this with their object
    store of choice; ``FsRemoteBackend`` is the in-repo emulated double."""

    def local_path(self, key: str) -> None:
        return None


class FsRemoteBackend(_DirStorage, RemoteBackend):
    """Filesystem-emulated remote object store (URL ``fsremote://PATH``).

    Behaves exactly like a remote KV store from ``PlanStore``'s point of
    view: bytes-only access, no memmap path, plus injectable per-operation
    latency (``latency_ms``) and a deterministic failure rate
    (``fail_rate`` with ``seed``) so tests can exercise degraded-remote
    behavior — reads become misses, writes stay best-effort — without a
    network."""

    def __init__(self, root, latency_ms: float = 0.0, fail_rate: float = 0.0,
                 seed: int = 0):
        _DirStorage.__init__(self, root)
        self.latency_ms = float(latency_ms)
        self.fail_rate = float(fail_rate)
        self._rng = random.Random(int(seed))
        self.ops = 0
        self.faults = 0

    def describe(self) -> str:
        extra = ""
        if self.latency_ms or self.fail_rate:
            extra = f"?latency_ms={self.latency_ms:g}&fail_rate={self.fail_rate:g}"
        return f"fsremote://{self.root}{extra}"

    def local_path(self, key: str) -> None:
        return None                       # remote semantics: bytes only

    def _op(self, what: str) -> None:
        self.ops += 1
        if self.latency_ms:
            time.sleep(self.latency_ms / 1e3)
        if self.fail_rate and self._rng.random() < self.fail_rate:
            self.faults += 1
            raise RemoteUnavailable(f"injected fault during {what}")

    def keys(self) -> list[str]:
        self._op("list")
        return _DirStorage.keys(self)

    def stat(self, key: str) -> dict | None:
        self._op("stat")
        return _DirStorage.stat(self, key)

    def get_bytes(self, key: str) -> bytes | None:
        self._op("get")
        return _DirStorage.get_bytes(self, key)

    def generation(self, key: str) -> str:
        self._op("head")
        return _DirStorage.generation(self, key)

    def get_with_generation(self, key: str) -> tuple[bytes | None, str]:
        self._op("get")
        return _DirStorage.get_with_generation(self, key)

    def put_bytes(self, key: str, data: bytes, *,
                  if_generation=UNCONDITIONAL) -> None:
        self._op("put")
        _DirStorage.put_bytes(self, key, data, if_generation=if_generation)

    def delete(self, key: str) -> None:
        self._op("delete")
        _DirStorage.delete(self, key)

    def touch(self, key: str) -> None:
        self._op("touch")
        _DirStorage.touch(self, key)
