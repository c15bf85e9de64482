"""Artifact <-> file codec (port of ``repro.planstore.codec``): one flat
binary container per entry, no pickle, byte for byte the JAX package's
container.

Layout of an entry file::

    magic "RPRPLAN1"  (8 bytes)
    meta_len          (u32 little-endian)
    meta              (UTF-8 JSON: versions, signature echo, payload kind,
                       hierarchy scalars, auto decision, break-even fit, and
                       the array directory: name/dtype/shape/offset/nbytes)
    array segments    (raw C-order bytes, 64-byte aligned)

Rationale vs ``np.savez``: hierarchy tables for large skewed patterns reach
tens of MB, and the zipfile container pays a full decompress-and-CRC pass on
every load — which is precisely the warm path this store exists to make
cheap.  The flat layout memory-maps each table (``np.memmap``, read-only) so
a warm INIT's load cost is one header read; table bytes stream from page
cache during the device upload that INIT performs anyway.

Safety: array payloads are raw numpy buffers reconstructed from explicit
dtype/shape directory entries — decoding can at worst fail, never execute
code.  Truncation is detected against the directory (file shorter than the
last segment -> ``ArtifactError``); garbage fails the magic/JSON parse.  A
CRC of the *metadata* block guards the directory itself; table payloads are
deliberately not checksummed (a streaming CRC would re-read every byte and
forfeit the mmap win — bit-rot inside a table is outside the threat model,
and any *structural* damage lands in the checked header).  Every decode
error of any kind is normalized to ``ArtifactError``.

The environment keys of the metadata are the port's (``torch_version``,
``device_kind``; the JAX package writes ``jax_version``, ``backend``): a
file of either package decodes in the other, its tables bit-equal, and
fails the other's validation, because a missing key decodes as
``"<missing>"``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import IO

import numpy as np

from ..core import metadata as md

from .schema import ArtifactError, PlanArtifact

MAGIC = b"RPRPLAN1"
_ALIGN = 64
_BAKED_FIELDS = ("pack_src", "pack_valid", "unpack_src", "unpack_valid")
_HIER_ARRAY_FIELDS = ("s1_src", "s1_valid", "s2_src", "s2_valid",
                      "s3_src", "s3_valid", "unpack_src", "unpack_valid")
# dtypes an array segment may declare; anything else is rejected outright.
_ALLOWED_DTYPES = {"int32", "int64", "bool", "uint8"}


def _collect_arrays(art: PlanArtifact) -> dict[str, np.ndarray]:
    arrays: dict[str, np.ndarray] = {}
    if art.index_tables is not None:
        for name in _BAKED_FIELDS:
            arrays[name] = np.ascontiguousarray(
                getattr(art.index_tables, name))
    if art.hier_schedule is not None:
        for name in _HIER_ARRAY_FIELDS:
            arrays[f"hier_{name}"] = np.ascontiguousarray(
                getattr(art.hier_schedule, name))
    return arrays


def dump(art: PlanArtifact, f: IO[bytes]) -> None:
    meta: dict = {
        "schema_version": art.schema_version,
        "torch_version": art.torch_version,
        "repro_version": art.repro_version,
        "device_kind": art.device_kind,
        "created_at": art.created_at,
        "signature": art.signature,
        "payload": art.payload_kind,
        "auto_choice": art.auto_choice,
        "breakeven": art.breakeven,
    }
    if art.hier_schedule is not None:
        sched = art.hier_schedule
        meta["hier"] = {
            "p_outer": sched.p_outer, "p_inner": sched.p_inner,
            "n_macro": sched.n_macro, "remote_needed": bool(sched.remote_needed),
            "s1_cap": sched.s1_cap, "s2_caps": list(sched.s2_caps),
            "s2_offs": list(sched.s2_offs), "total_s2": sched.total_s2,
            "s3_cap": sched.s3_cap,
            "round_perms": [[list(pair) for pair in pm]
                            for pm in sched.round_perms],
            "cross_group_puts": sched.cross_group_puts,
            "leader_perm": [list(row) for row in sched.leader_perm],
        }
    arrays = _collect_arrays(art)

    # Two-pass header: directory offsets depend on the header length, which
    # depends on the directory text — fix offsets relative to a header size
    # computed with final-width numbers, padding the JSON to that size.
    directory = [{"name": n, "dtype": str(a.dtype), "shape": list(a.shape),
                  "nbytes": int(a.nbytes), "offset": 0}
                 for n, a in arrays.items()]
    meta["arrays"] = directory

    def render(m) -> bytes:
        return json.dumps(m, separators=(",", ":")).encode("utf-8")

    # Upper-bound the header: offsets rendered as 12-digit placeholders.
    for d in directory:
        d["offset"] = 10 ** 11            # 12 digits, > any real offset
    header_cap = len(MAGIC) + 8 + len(render(meta))
    header_cap = -(-header_cap // _ALIGN) * _ALIGN
    off = header_cap
    for d, a in zip(directory, arrays.values()):
        d["offset"] = off
        off = -(-(off + a.nbytes) // _ALIGN) * _ALIGN
    body = render(meta)
    pad = header_cap - len(MAGIC) - 8 - len(body)
    assert pad >= 0, "offset rendering shrank the header"
    body += b" " * pad

    f.write(MAGIC)
    f.write(struct.pack("<II", len(body), zlib.crc32(body)))
    f.write(body)
    pos = header_cap
    for d, a in zip(directory, arrays.values()):
        if d["offset"] != pos:
            f.write(b"\0" * (d["offset"] - pos))
            pos = d["offset"]
        f.write(a.tobytes())
        pos += a.nbytes
    if pos % _ALIGN:
        f.write(b"\0" * (_ALIGN - pos % _ALIGN))


def dumps(art: PlanArtifact) -> bytes:
    buf = io.BytesIO()
    dump(art, buf)
    return buf.getvalue()


def _read_meta(read) -> tuple[dict, int]:
    head = read(len(MAGIC) + 8)
    if len(head) != len(MAGIC) + 8 or head[:len(MAGIC)] != MAGIC:
        raise ArtifactError("bad magic / truncated header")
    meta_len, crc = struct.unpack("<II", head[len(MAGIC):])
    if meta_len > (1 << 26):
        raise ArtifactError(f"implausible metadata length {meta_len}")
    body = read(meta_len)
    if len(body) != meta_len:
        raise ArtifactError("truncated metadata block")
    if zlib.crc32(body) != crc:
        raise ArtifactError("metadata CRC mismatch")
    try:
        meta = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactError(f"undecodable metadata: {e}") from e
    return meta, len(MAGIC) + 8 + meta_len


def _segment_specs(meta: dict, total_size: int) -> dict[str, dict]:
    specs = {}
    for d in meta.get("arrays") or []:
        try:
            name, dtype = str(d["name"]), str(d["dtype"])
            shape = tuple(int(s) for s in d["shape"])
            offset, nbytes = int(d["offset"]), int(d["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(f"bad array directory entry: {e}") from e
        if dtype not in _ALLOWED_DTYPES:
            raise ArtifactError(f"disallowed dtype {dtype!r} for {name!r}")
        if any(s < 0 for s in shape) or offset < 0:
            raise ArtifactError(f"negative geometry for {name!r}")
        if int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize != nbytes:
            raise ArtifactError(f"shape/nbytes mismatch for {name!r}")
        if offset + nbytes > total_size:
            raise ArtifactError(
                f"truncated entry: segment {name!r} ends at "
                f"{offset + nbytes} but file has {total_size} bytes")
        specs[name] = {"dtype": dtype, "shape": shape, "offset": offset,
                       "nbytes": nbytes}
    return specs


def load(path_or_file: "str | os.PathLike | IO[bytes]") -> PlanArtifact:
    """Decode one entry; raises ArtifactError on *any* defect.

    Given a path, table segments come back as read-only ``np.memmap`` views
    — the warm-start fast path.  Given a file object, the whole stream is
    read and segments are zero-copy ``np.frombuffer`` views.
    """
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        meta, _ = _read_meta(io.BytesIO(data).read)
        specs = _segment_specs(meta, len(data))

        def segment(name):
            s = specs[name]
            a = np.frombuffer(data, dtype=s["dtype"],
                              count=int(np.prod(s["shape"], dtype=np.int64)),
                              offset=s["offset"])
            return a.reshape(s["shape"])
    else:
        path = os.fspath(path_or_file)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                meta, _ = _read_meta(f.read)
        except OSError as e:
            raise ArtifactError(f"unreadable entry: {e}") from e
        specs = _segment_specs(meta, size)

        def segment(name):
            s = specs[name]
            if s["nbytes"] == 0:          # mmap rejects empty segments
                return np.zeros(s["shape"], dtype=s["dtype"])
            try:
                return np.memmap(path, dtype=s["dtype"], mode="r",
                                 offset=s["offset"], shape=s["shape"])
            except (OSError, ValueError) as e:
                raise ArtifactError(f"unmappable segment {name!r}: {e}") from e

    try:
        payload = meta.get("payload", "meta_only")
        tables = None
        sched = None
        if payload == "baked_tables":
            tables = _load_baked(segment, specs)
        elif payload == "hier_schedule":
            sched = _load_hier(segment, specs, meta.get("hier") or {})
        elif payload != "meta_only":
            raise ArtifactError(f"unknown payload kind {payload!r}")
        return PlanArtifact(
            signature=meta.get("signature") or {},
            schema_version=int(meta.get("schema_version", -1)),
            # "<missing>" (not ""): an absent version must FAIL validation,
            # and PlanArtifact.__post_init__ back-fills an empty
            # torch_version with the live one.
            torch_version=str(meta.get("torch_version") or "<missing>"),
            repro_version=str(meta.get("repro_version") or "<missing>"),
            device_kind=str(meta.get("device_kind") or "<missing>"),
            created_at=float(meta.get("created_at", 0.0)),
            index_tables=tables,
            hier_schedule=sched,
            auto_choice=meta.get("auto_choice"),
            breakeven=meta.get("breakeven"),
        )
    except ArtifactError:
        raise
    except Exception as e:      # tampered meta values of the wrong type etc.
        raise ArtifactError(
            f"undecodable entry: {type(e).__name__}: {e}") from e


def loads(data: bytes) -> PlanArtifact:
    return load(io.BytesIO(data))


def _need(segment, specs, name: str, dtype) -> np.ndarray:
    if name not in specs:
        raise ArtifactError(f"missing array segment {name!r}")
    a = segment(name)
    if a.dtype != np.dtype(dtype) or a.ndim != 2:
        raise ArtifactError(
            f"segment {name!r} has dtype {a.dtype}/ndim {a.ndim}, "
            f"expected 2-D {np.dtype(dtype)}")
    return a


def _load_baked(segment, specs) -> "md.BakedIndexTables":
    pack_src = _need(segment, specs, "pack_src", np.int32)
    pack_valid = _need(segment, specs, "pack_valid", bool)
    unpack_src = _need(segment, specs, "unpack_src", np.int32)
    unpack_valid = _need(segment, specs, "unpack_valid", bool)
    if pack_src.shape != pack_valid.shape or unpack_src.shape != unpack_valid.shape:
        raise ArtifactError("pack/unpack table shape mismatch")
    return md.BakedIndexTables(pack_src, pack_valid, unpack_src, unpack_valid)


def _load_hier(segment, specs, h: dict) -> "md.HierSchedule":
    try:
        kwargs = {
            "p_outer": int(h["p_outer"]), "p_inner": int(h["p_inner"]),
            "n_macro": int(h["n_macro"]),
            "remote_needed": bool(h["remote_needed"]),
            "s1_cap": int(h["s1_cap"]),
            "s2_caps": tuple(int(x) for x in h["s2_caps"]),
            "s2_offs": tuple(int(x) for x in h["s2_offs"]),
            "total_s2": int(h["total_s2"]), "s3_cap": int(h["s3_cap"]),
            "round_perms": tuple(
                tuple((int(a), int(b)) for a, b in pm)
                for pm in h["round_perms"]),
            "cross_group_puts": int(h["cross_group_puts"]),
            "leader_perm": md.normalize_leader_perm(
                h.get("leader_perm"), int(h["p_outer"]), int(h["p_inner"])),
        }
    except (KeyError, TypeError, ValueError) as e:
        raise ArtifactError(f"bad hierarchy scalars: {e}") from e
    for name in _HIER_ARRAY_FIELDS:
        dtype = bool if name.endswith("_valid") else np.int32
        kwargs[name] = _need(segment, specs, f"hier_{name}", dtype)
    return md.HierSchedule(**kwargs)
