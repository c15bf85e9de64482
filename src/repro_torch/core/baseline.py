"""Non-persistent alltoallv baseline (the ``MPI_Alltoallv`` stand-in).

Port of ``repro.core.baseline``.  A non-persistent collective takes
counts as a *runtime argument* and must therefore redo, on every
invocation, all the work a persistent plan performs once at INIT:

  * the count matrix exchange (a transpose over the virtual ranks),
  * displacement computation and pack/unpack index-map construction, on
    the device, every call,
  * conservative capacity: the call is generic over patterns, so every
    bucket is padded to the declared worst case (a persistent lock plan, by
    contrast, shrinks every round to its measured diagonal and elides the
    empty ones),
  * a fresh output buffer each call (no window reuse).

With one process per rank (``launch.mesh.ProcessMesh``) the call takes this
rank's send shard and its own row of send counts, exchanges the counts
through a small window (one peer fence epoch of one int64 per pair),
re-derives this rank's tables from them on the device, and moves the data
through a scratch window: the library's internal buffers, as under
``MPI_Alltoallv``, which the mesh registers once (``mesh.scratch``) and
again only for a larger geometry.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from . import variants
from .window import SharedRegion


def nonpersistent_alltoallv(
    x: torch.Tensor,
    send_counts: torch.Tensor,
    *,
    p: int,
    capacity: int,
    recv_rows: int,
    variant: str = "fence",
    lock_schedule: str = "ring",
) -> torch.Tensor:
    """Non-persistent alltoallv over P virtual ranks.

    ``x`` is the global send buffer ``[P * send_rows, *F]``; ``send_counts``
    the flattened ``[P * P]`` int32 count matrix on the device, read anew
    every call.  Returns the global recv buffer ``[P * recv_rows, *F]``.
    """
    feat = tuple(x.shape[1:])
    sc = send_counts.reshape(p, p)
    # -- per-call metadata processing (what persistence eliminates) --
    rc = variants.exchange_counts_in_graph(sc)
    sd = variants.displacements_in_graph(sc)
    rd = variants.displacements_in_graph(rc)
    src, valid = variants.pack_index_map_in_graph(sc, sd, p, capacity)
    packed = variants.pack_rows(x.reshape((p, -1) + feat), src, valid)

    # -- data movement --
    if variant == "fence":
        buckets = variants.fence_exchange(packed, p, capacity)
    elif variant == "lock":
        # No pattern knowledge -> every round padded to the global capacity.
        buckets = variants.lock_exchange(packed, p, capacity, None,
                                         lock_schedule)
    else:
        raise ValueError(f"non-persistent baseline supports fence|lock, got {variant}")

    rsrc, rvalid = variants.unpack_index_map_in_graph(rc, rd, p, capacity,
                                                      recv_rows)
    out = variants.unpack_rows(buckets, rsrc, rvalid)
    return out.reshape((p * recv_rows,) + feat)


def scratch_window(mesh, name: str, nbytes: int):
    """The process mesh's scratch window ``name`` with at least ``nbytes``
    per rank (``rma_signal.PeerWindow``), registered (collectively) at its
    first use and again only when a call needs more."""
    region = mesh.scratch.get(name)
    if region is None or region.win.nbytes < nbytes:
        if region is not None:
            region.free()
        region = mesh.scratch[name] = SharedRegion(mesh, nbytes)
    return region.win


def make_nonpersistent(mesh, *, axis: str, p: int, capacity: int, send_rows: int,
                       recv_rows: int, feature_shape, dtype,
                       variant: str = "fence", lock_schedule: str = "ring"):
    """The generic call for one geometry: ``exe(x, counts)`` serves every
    pattern whose buckets fit ``capacity`` (counts as runtime arguments).
    On a ``ProcessMesh`` ``exe`` takes this rank's ``[send_rows, *F]`` and
    its ``[P]`` send counts and returns its ``[recv_rows, *F]``."""
    if variant not in ("fence", "lock"):
        raise ValueError(f"non-persistent baseline supports fence|lock, got {variant}")
    if mesh.shape[axis] != p:
        raise ValueError(f"axis {axis!r} has size {mesh.shape[axis]}, not {p}")
    if getattr(mesh, "is_process_mesh", False):
        return _process_nonpersistent(mesh, p, capacity, send_rows, recv_rows,
                                      tuple(feature_shape), dtype, variant,
                                      lock_schedule)
    want = (p * send_rows,) + tuple(feature_shape)
    fn = partial(nonpersistent_alltoallv, p=p, capacity=capacity,
                 recv_rows=recv_rows, variant=variant,
                 lock_schedule=lock_schedule)

    def exe(x: torch.Tensor, send_counts: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != want or x.dtype != dtype or x.device != mesh.device:
            raise ValueError(f"expected {want} {dtype} on {mesh.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        return fn(x, send_counts)

    return exe


def _process_nonpersistent(mesh, p, capacity, send_rows, recv_rows, feat,
                           dtype, variant, lock_schedule):
    row_bytes = math.prod(feat) * dtype.itemsize
    counts_win = scratch_window(mesh, "counts", p * 8)
    data_win = scratch_window(mesh, "data", p * capacity * row_bytes)
    want = (send_rows,) + feat

    def exe(x: torch.Tensor, send_counts: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != want or x.dtype != dtype or x.device != mesh.device:
            raise ValueError(f"rank {mesh.rank}: expected {want} {dtype} on "
                             f"{mesh.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
        # -- per-call metadata: the counts exchange, then this rank's maps --
        sc = send_counts.reshape(1, p).to(torch.int64)
        variants.fence_exchange(sc.reshape(p, 1), p, 1, window=counts_win)
        rc = counts_win.view(p, (), torch.int64).reshape(1, p)
        sd = variants.displacements_in_graph(sc)
        rd = variants.displacements_in_graph(rc)
        src, valid = variants.pack_index_map_in_graph(sc, sd, p, capacity)
        packed = variants.pack_rows(x.unsqueeze(0), src, valid)[0]
        # -- data movement, every lock round at the global capacity --
        if variant == "fence":
            variants.fence_exchange(packed, p, capacity, window=data_win)
        else:
            variants.lock_exchange(packed, p, capacity, None, lock_schedule,
                                   window=data_win)
        rsrc, rvalid = variants.unpack_index_map_in_graph(rc, rd, p, capacity,
                                                          recv_rows)
        buckets = data_win.view(p * capacity, feat, dtype).unsqueeze(0)
        return variants.unpack_rows(buckets, rsrc, rvalid)[0]

    return exe
