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
"""

from __future__ import annotations

from functools import partial

import torch

from . import variants


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


def make_nonpersistent(mesh, *, axis: str, p: int, capacity: int, send_rows: int,
                       recv_rows: int, feature_shape, dtype,
                       variant: str = "fence", lock_schedule: str = "ring"):
    """The generic call for one geometry: ``exe(x, counts)`` serves every
    pattern whose buckets fit ``capacity`` (counts as runtime arguments)."""
    if variant not in ("fence", "lock"):
        raise ValueError(f"non-persistent baseline supports fence|lock, got {variant}")
    if mesh.shape[axis] != p:
        raise ValueError(f"axis {axis!r} has size {mesh.shape[axis]}, not {p}")
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
