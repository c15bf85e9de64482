"""K2 and K3: the fence-synchronised alltoallv epoch over P virtual ranks.

Port of the Pallas kernels ``repro.kernels.a2a_fence.rma_alltoallv_fence``
(the paper's Algorithm 1) and ``rma_alltoallv_fence_fused`` (the same epoch
with the pack gather fused in).  The CUDA kernels are in
``csrc/a2a_fence.cu``; its note says how the epoch's open and close
barriers become launch boundaries on one device.

Layout, global view: rank ``i`` owns ``packed[i]`` (bucket ``j`` holds its
rows for rank ``j``) and ``out[i]`` (bucket ``j`` holds rank ``j``'s rows
for it):

    out[tgt][src*C + k] = packed[src][tgt*C + k]

K2 also exchanges ``groups`` independent groups of ``p`` ranks in one
launch (``packed [groups*p, p*C, *F]``, group ``g`` owning ranks
``g*p .. g*p+p-1``): the inner all-to-alls of the leader-combined hierarchy.

Which K2 kernel a call takes (``fence_kernel_for``), by a rule on the
inputs alone:

- CPU tensors: the plain version below;
- ``meta`` tensors: an empty output of the right shape, nothing computed
  or counted as a launch (the dry run traces a step this way);
- CUDA tensors whose buckets (``capacity`` rows) are a multiple of 16 bytes
  on 16-byte aligned bases: ``fence_bulk_kernel``, each bucket one
  contiguous copy cut into chunks of at most 8 KiB, one chunk per block
  (counter ``FENCE_BULK``).  Every plan's capacity is a multiple of 8, so
  every plan with rows of even width takes it;
- other CUDA tensors: ``fence_kernel``, one warp per row (counter
  ``FENCE``).

Which K3 kernel a call takes (``fused_kernel_for``), by a rule on the
inputs alone:

- CPU tensors: the plain version below;
- ``meta`` tensors: an empty output of the right shape, nothing computed
  or counted as a launch (the dry run traces a step this way);
- CUDA tensors whose row width is a multiple of 16 bytes up to 32 KiB on a
  16-byte aligned ``x``: ``fence_fused_bulk_kernel``, one output tile of
  about 8 KiB per block, each tile's runs of consecutive source rows moved
  with 1-D TMA bulk copies and all-invalid tiles stored as zeros (counter
  ``FUSED_BULK``);
- other CUDA tensors: ``fence_fused_kernel``, one warp per output row
  (counter ``FUSED``).

The peer forms (``rma_alltoallv_fence_peer``, ``rma_alltoallv_fence_fused_peer``)
run one rank's share of the epoch with one process per rank
(``launch.mesh.ProcessMesh``): this rank's send buckets go into rows
``[me*C, (me+1)*C)`` of every rank's window (``rma_signal.PeerWindow``),
between an OPEN and a CLOSE of the window's flags.  CPU windows
(shared-memory files) take the plain versions.  On a card the peer K2 is
``fence_peer_kernel`` (counter ``FENCE_PEER``): the whole epoch in ONE
launch, the OPEN by the block that takes the first ticket, the bucket
kernel's chunked copies through the peer pointers (16-byte accesses where
the buckets allow, bytes otherwise) on a grid of at most the window's
``fence_ctas``, and the CLOSE by the last block to arrive.  The peer K3 is
``fence_fused_peer_bulk_kernel`` (counter ``FUSED_PEER``: the tile kernel
whose bulk store writes through the peer pointer; rows of 16-byte
multiples up to 32 KiB on an aligned ``x``) or
``fence_fused_peer_warp_kernel`` (counter ``FUSED_PEER_WARP``: other
rows), with the signal kernel (``rma_signal.SIGNAL``) before and after.

No kernel is a fallback for another: a build or launch error raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .gather_rows import row_bytes
from .ref import gather_rows_ref
from .rma_signal import CLOSE, OPEN, PeerWindow, rma_signal, rma_signal_plain

FENCE = _build.register(_build.CudaKernel(
    "a2a_fence", "a2a_fence", "repro_a2a_fence",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 4 + [_build.VOIDP],
    kid="K2"))
FENCE_BULK = _build.register(_build.CudaKernel(
    "a2a_fence_bulk", "a2a_fence", "repro_a2a_fence_bulk",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 5 + [_build.VOIDP],
    kid="K2"))
FUSED = _build.register(_build.CudaKernel(
    "a2a_fence_fused", "a2a_fence", "repro_a2a_fence_fused",
    [_build.VOIDP] * 4 + [_build.I64] * 4 + [_build.VOIDP], kid="K3"))
FUSED_BULK = _build.register(_build.CudaKernel(
    "a2a_fence_fused_bulk", "a2a_fence", "repro_a2a_fence_fused_bulk",
    [_build.VOIDP] * 4 + [_build.I64] * 5 + [_build.VOIDP], kid="K3"))
FENCE_PEER = _build.register(_build.CudaKernel(
    "a2a_fence_peer", "a2a_fence", "repro_a2a_fence_peer",
    [_build.VOIDP] * 3 + [_build.INT] * 3 + [_build.I64] * 3
    + [_build.INT] * 3 + [_build.I64] * 2 + [_build.VOIDP] * 3, kid="K2"))
_FUSED_PEER_ARGS = [_build.VOIDP] * 4 + [_build.I64] * 5 + [_build.VOIDP]
FUSED_PEER = _build.register(_build.CudaKernel(
    "a2a_fence_fused_peer", "a2a_fence", "repro_a2a_fence_fused_peer",
    _FUSED_PEER_ARGS, kid="K3"))
FUSED_PEER_WARP = _build.register(_build.CudaKernel(
    "a2a_fence_fused_peer_warp", "a2a_fence", "repro_a2a_fence_fused_peer",
    _FUSED_PEER_ARGS, kid="K3"))

# The bulk kernel's tiles (csrc/a2a_fence.cu): about 8 KiB of rows, at
# most 32 rows (one table word per lane), rows of at most 32 KiB; bulk
# copies move 16-byte multiples.
TILE_BYTES = 8192
MAX_TILE_ROWS = 32
MAX_ROW_BYTES = 32768
BULK_ALIGN = 16


# K2's bulk kernel cuts every bucket into chunks of at most this many bytes,
# one per block (csrc/a2a_fence.cu).  8 KiB measured 0.3-0.8 % faster than
# 16 KiB on an H100 at A, B, the training exchange and the gradient sync,
# and equal on 4-byte rows (chip_smoke.py's chunk sweep).
FENCE_CHUNK_BYTES = 8192


def fence_kernel_choice(device_type: str, bucket_bytes: int, packed_addr: int,
                        out_addr: int) -> str:
    """The rule of ``fence_kernel_for`` on plain values: "plain", "bulk" or
    "warp"."""
    if device_type == "cpu":
        return "plain"
    if (bucket_bytes % BULK_ALIGN == 0 and packed_addr % BULK_ALIGN == 0
            and out_addr % BULK_ALIGN == 0):
        return "bulk"
    return "warp"


def fence_kernel_for(packed: torch.Tensor, capacity: int) -> str:
    """Which kernel ``rma_alltoallv_fence(packed, p, capacity)`` takes
    (its output is a fresh allocation, so aligned)."""
    return fence_kernel_choice(packed.device.type,
                               capacity * row_bytes(packed),
                               packed.data_ptr(), 0)


def fence_cuda_kernel(row_width: int, capacity: int) -> _build.CudaKernel:
    """The K2 kernel a CUDA call with rows of ``row_width`` bytes at
    ``capacity`` on an aligned buffer launches: what a plan names."""
    return (FENCE_BULK if fence_kernel_choice(
        "cuda", capacity * row_width, 0, 0) == "bulk" else FENCE)


def fence_chunks(groups: int, p: int, capacity: int, row_width: int,
                 chunk_bytes: int = FENCE_CHUNK_BYTES) -> np.ndarray:
    """The copies ``fence_bulk_kernel`` makes, in its order: int64
    ``[chunks, 3]`` of (source byte offset, output byte offset, bytes),
    computed as the kernel computes them."""
    bucket = capacity * row_width
    per_bucket = -(-bucket // chunk_bytes)
    if per_bucket == 0:
        return np.zeros((0, 3), np.int64)
    o, k = np.divmod(np.arange(groups * p * p * per_bucket, dtype=np.int64),
                     per_bucket)
    gt, src = np.divmod(o, p)
    g, tgt = np.divmod(gt, p)
    start = k * chunk_bytes
    return np.stack([((g * p + src) * p + tgt) * bucket + start,
                     o * bucket + start,
                     np.minimum(chunk_bytes, bucket - start)], axis=1)


def fused_kernel_choice(device_type: str, row_width: int, x_addr: int) -> str:
    """The rule of ``fused_kernel_for`` on plain values: "plain", "bulk" or
    "warp"."""
    if device_type == "cpu":
        return "plain"
    if (0 < row_width <= MAX_ROW_BYTES and row_width % BULK_ALIGN == 0
            and x_addr % BULK_ALIGN == 0):
        return "bulk"
    return "warp"


def fused_kernel_for(x: torch.Tensor) -> str:
    """Which kernel ``rma_alltoallv_fence_fused(x, ...)`` takes."""
    return fused_kernel_choice(x.device.type, row_bytes(x), x.data_ptr())


def fused_cuda_kernel(row_width: int) -> _build.CudaKernel:
    """The K3 kernel a CUDA call with rows of ``row_width`` bytes on an
    aligned ``x`` (any fresh torch allocation) launches: what a plan names."""
    return (FUSED_BULK if fused_kernel_choice("cuda", row_width, 0) == "bulk"
            else FUSED)


def fused_tile_rows(row_width: int) -> int:
    """Rows of one tile (one block's stage) of the bulk kernel."""
    return max(1, min(MAX_TILE_ROWS, TILE_BYTES // row_width))


def _check_packed(packed: torch.Tensor, p: int, capacity: int,
                  groups: int = 1) -> None:
    want = (groups * p, p * capacity)
    if packed.dim() < 2 or tuple(packed.shape[:2]) != want:
        raise ValueError(f"packed must be [G*P={want[0]}, P*C={want[1]}, *F], "
                         f"got {tuple(packed.shape)}")


def _transpose_buckets(packed: torch.Tensor, p: int, capacity: int,
                       groups: int = 1) -> torch.Tensor:
    feat = tuple(packed.shape[2:])
    return (packed.reshape((groups, p, p, capacity) + feat).transpose(1, 2)
            .contiguous().view((groups * p, p * capacity) + feat))


@_build.counted(FENCE, lambda out, packed, *a, **k:
                (0, _build.tensor_bytes(packed, out)))
def rma_alltoallv_fence(packed: torch.Tensor, p: int, capacity: int,
                        groups: int = 1) -> torch.Tensor:
    """[G*P, P*C, *F] -> [G*P, P*C, *F]: the whole fence epoch of every
    group in one launch.  On CUDA the kernel ``fence_kernel_for`` names;
    on ``meta`` the output's shape alone."""
    _check_packed(packed, p, capacity, groups)
    if packed.device.type == "meta":
        _build.check_meta(packed)
        return torch.empty_like(packed)
    if packed.device.type == "cpu":
        return rma_alltoallv_fence_plain(packed, p, capacity, groups)
    if fence_kernel_for(packed, capacity) == "bulk":
        return fence_bulk_kernel(packed, p, capacity, groups)
    return fence_warp_kernel(packed, p, capacity, groups)


def _fence_out(packed, p, capacity, groups) -> torch.Tensor:
    _check_packed(packed, p, capacity, groups)
    _build.check_cuda(packed)
    return torch.empty_like(packed)


def fence_bulk_kernel(packed: torch.Tensor, p: int, capacity: int,
                      groups: int = 1,
                      chunk_bytes: int = FENCE_CHUNK_BYTES) -> torch.Tensor:
    """K2 by ``fence_bulk_kernel``, bucket chunks of ``chunk_bytes`` (CUDA
    only; the launcher refuses buckets or bases it cannot take)."""
    out = _fence_out(packed, p, capacity, groups)
    FENCE_BULK.launch(packed.data_ptr(), out.data_ptr(), groups, p, capacity,
                      row_bytes(packed), chunk_bytes,
                      _build.stream_handle(packed))
    return out


def fence_warp_kernel(packed: torch.Tensor, p: int, capacity: int,
                      groups: int = 1) -> torch.Tensor:
    """K2 by ``fence_kernel``, one warp per row (CUDA only; any row width
    and base)."""
    out = _fence_out(packed, p, capacity, groups)
    FENCE.launch(packed.data_ptr(), out.data_ptr(), groups, p, capacity,
                 row_bytes(packed), _build.stream_handle(packed))
    return out


def rma_alltoallv_fence_plain(packed: torch.Tensor, p: int, capacity: int,
                              groups: int = 1) -> torch.Tensor:
    _check_packed(packed, p, capacity, groups)
    FENCE.plain_calls += 1
    return _transpose_buckets(packed, p, capacity, groups)


def _check_fused(x, src_idx, valid, p, capacity) -> None:
    if x.dim() < 2 or x.shape[0] != p:
        raise ValueError(f"x must be [P={p}, S, *F], got {tuple(x.shape)}")
    if tuple(src_idx.shape) != (p, p * capacity) or valid.shape != src_idx.shape:
        raise ValueError(f"src_idx/valid must be [{p}, {p * capacity}], got "
                         f"{tuple(src_idx.shape)}/{tuple(valid.shape)}")
    if src_idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"src_idx must be int32 and valid bool, got "
                         f"{src_idx.dtype}/{valid.dtype}")


@_build.counted(FUSED, lambda out, x, src_idx, valid, *a, **k:
                (0, _build.tensor_bytes(x, src_idx, valid, out)))
def rma_alltoallv_fence_fused(x: torch.Tensor, src_idx: torch.Tensor,
                              valid: torch.Tensor, p: int,
                              capacity: int) -> torch.Tensor:
    """Fused pack + fence epoch: ragged ``x [P, S, *F]`` and the baked pack
    tables ``[P, P*C]`` -> the bucketed recv layout ``[P, P*C, *F]``; the
    padded send layout is never written.  On CUDA the kernel
    ``fused_kernel_for`` names; on ``meta`` the output's shape alone."""
    _check_fused(x, src_idx, valid, p, capacity)
    if x.device.type == "meta":
        _build.check_meta(x, src_idx, valid)
        return x.new_empty((p, p * capacity) + tuple(x.shape[2:]))
    if x.device.type == "cpu":
        return rma_alltoallv_fence_fused_plain(x, src_idx, valid, p, capacity)
    if fused_kernel_for(x) == "bulk":
        return fence_fused_bulk_kernel(x, src_idx, valid, p, capacity)
    return fence_fused_warp_kernel(x, src_idx, valid, p, capacity)


def _fused_out(x, src_idx, valid, p, capacity) -> torch.Tensor:
    _check_fused(x, src_idx, valid, p, capacity)
    _build.check_cuda(x, src_idx, valid)
    return torch.empty((p, p * capacity) + tuple(x.shape[2:]), dtype=x.dtype,
                       device=x.device)


def fence_fused_bulk_kernel(x: torch.Tensor, src_idx: torch.Tensor,
                            valid: torch.Tensor, p: int,
                            capacity: int) -> torch.Tensor:
    """K3 by ``fence_fused_bulk_kernel`` (CUDA only; the launcher refuses
    rows or bases it cannot take)."""
    out = _fused_out(x, src_idx, valid, p, capacity)
    rb = row_bytes(x)
    FUSED_BULK.launch(x.data_ptr(), src_idx.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), p, x.shape[1], capacity, rb,
                      fused_tile_rows(rb) if rb else 1,
                      _build.stream_handle(x))
    return out


def fence_fused_warp_kernel(x: torch.Tensor, src_idx: torch.Tensor,
                            valid: torch.Tensor, p: int,
                            capacity: int) -> torch.Tensor:
    """K3 by ``fence_fused_kernel``, one warp per row (CUDA only; any row
    width and base)."""
    out = _fused_out(x, src_idx, valid, p, capacity)
    FUSED.launch(x.data_ptr(), src_idx.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), p, x.shape[1], capacity, row_bytes(x),
                 _build.stream_handle(x))
    return out


def rma_alltoallv_fence_fused_plain(x: torch.Tensor, src_idx: torch.Tensor,
                                    valid: torch.Tensor, p: int,
                                    capacity: int) -> torch.Tensor:
    _check_fused(x, src_idx, valid, p, capacity)
    FUSED.plain_calls += 1
    return _transpose_buckets(gather_rows_ref(x, src_idx, valid), p, capacity)


# -- the peer forms: one process per rank --------------------------------------

def _local_row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row of ``t [N, *F]``."""
    return torch.Size(t.shape[1:]).numel() * t.element_size()


def _check_peer(packed: torch.Tensor, win: PeerWindow, capacity: int) -> int:
    """Bucket bytes of ``packed [P*C, *F]``; raise unless it is one rank's
    send buckets and fits the window."""
    p = win.p
    if packed.dim() < 1 or packed.shape[0] != p * capacity:
        raise ValueError(f"packed must be [P*C={p * capacity}, *F], got "
                         f"{tuple(packed.shape)}")
    bucket = capacity * _local_row_bytes(packed)
    if p * bucket > win.nbytes:
        raise ValueError(f"a window of {win.nbytes} bytes cannot take "
                         f"{p} buckets of {bucket} bytes")
    return bucket


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@_build.counted(FENCE_PEER, lambda out, packed, *a, **k:
                (0, 2 * _build.tensor_bytes(packed)))
def rma_alltoallv_fence_peer(packed: torch.Tensor, win: PeerWindow,
                             capacity: int, epoch: int | None = None) -> None:
    """This rank's fence epoch: ``packed [P*C, *F]`` (bucket t for rank t)
    into rows ``[me*C, (me+1)*C)`` of every rank's window, between the
    OPEN (signal every peer, wait for every peer) and the CLOSE of
    ``epoch`` (default: the window's next).  On a card one launch of
    ``fence_peer_kernel`` on the current stream; the caller unpacks this
    rank's window after it."""
    bucket = _check_peer(packed, win, capacity)
    epoch = win.next_epoch() if epoch is None else epoch
    if packed.device.type == "cpu":
        rma_alltoallv_fence_peer_plain(packed, win, capacity, epoch)
        return
    fence_peer_kernel(packed, win, capacity, epoch, bucket=bucket)


@functools.lru_cache(maxsize=None)
def peer_info(device_index: int, vec16: bool) -> dict:
    """What the card says of K2 peer's kernel (16-byte or byte form)
    (``_build.kernel_info``)."""
    return _build.kernel_info(FENCE_PEER, "repro_a2a_fence_peer_info",
                              int(vec16), device_index)


def peer_resident_ctas(device_index: int) -> int:
    """Blocks of K2 peer's kernel the card holds at once (the smaller of
    its two forms)."""
    return min(i["blocks_per_sm"] * i["sms"] for i in
               (peer_info(device_index, v) for v in (True, False)))


def fence_peer_kernel(packed: torch.Tensor, win: PeerWindow, capacity: int,
                      epoch: int, ctas: int | None = None,
                      bucket: int | None = None) -> None:
    """The whole peer fence epoch in one launch of ``fence_peer_kernel``
    (CUDA only) on ``ctas`` blocks (default: the window's ``fence_ctas``;
    the launcher takes at most one block per chunk)."""
    _build.check_cuda(packed, win.local)
    if bucket is None:
        bucket = _check_peer(packed, win, capacity)
    vec16 = int(bucket % BULK_ALIGN == 0 and packed.data_ptr() % BULK_ALIGN == 0)
    FENCE_PEER.launch(packed.data_ptr(), win.peer_ptrs.data_ptr(),
                      win.pad_ptrs.data_ptr(), win.rank, win.p, win.lock_ctas,
                      capacity, _local_row_bytes(packed), FENCE_CHUNK_BYTES,
                      vec16, win.fence_ctas if ctas is None else ctas,
                      int(win.sys_scope), epoch, win.timeout_ns,
                      win.sync.data_ptr(),
                      win.error.data_ptr(), _build.stream_handle(packed))


def fence_peer_grid(win: PeerWindow, capacity: int, row_width: int,
                    ctas: int | None = None) -> int:
    """Blocks of one launch of ``fence_peer_kernel``: ``ctas`` (default:
    the window's ``fence_ctas``), at most one per chunk, at least one."""
    chunks = win.p * -(-capacity * row_width // FENCE_CHUNK_BYTES)
    return max(1, min(win.fence_ctas if ctas is None else ctas, chunks))


def fence_peer_puts_plain(packed: torch.Tensor, win: PeerWindow,
                          capacity: int) -> None:
    """The puts of K2's peer form as tensor copies through the peers'
    mapped windows."""
    bucket = _check_peer(packed, win, capacity)
    src, me = _as_bytes(packed), win.rank
    for t in range(win.p):
        win.peers[t][me * bucket:(me + 1) * bucket].copy_(
            src[t * bucket:(t + 1) * bucket])


def rma_alltoallv_fence_peer_plain(packed: torch.Tensor, win: PeerWindow,
                                   capacity: int, epoch: int) -> None:
    """The plain version of the whole peer fence epoch."""
    FENCE_PEER.plain_calls += 1
    rma_signal_plain(win, OPEN, epoch)
    fence_peer_puts_plain(packed, win, capacity)
    rma_signal_plain(win, CLOSE, epoch)


def _check_fused_peer(x, src_idx, valid, win, capacity) -> None:
    n = win.p * capacity
    if x.dim() < 1 or tuple(src_idx.shape) != (n,) or valid.shape != src_idx.shape:
        raise ValueError(f"x must be [S, *F] and src_idx/valid [P*C={n}], got "
                         f"{tuple(x.shape)}, {tuple(src_idx.shape)}/"
                         f"{tuple(valid.shape)}")
    if src_idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"src_idx must be int32 and valid bool, got "
                         f"{src_idx.dtype}/{valid.dtype}")
    if n * _local_row_bytes(x) > win.nbytes:
        raise ValueError(f"a window of {win.nbytes} bytes cannot take {n} "
                         f"rows of {_local_row_bytes(x)} bytes")


def fused_peer_kernel_for(x: torch.Tensor) -> _build.CudaKernel:
    """The K3 peer kernel a CUDA call on ``x [S, *F]`` launches (window
    bases are 256-byte aligned)."""
    return (FUSED_PEER if fused_kernel_choice("cuda", _local_row_bytes(x),
                                              x.data_ptr()) == "bulk"
            else FUSED_PEER_WARP)


@_build.counted(FUSED_PEER, lambda out, x, src_idx, valid, *a, **k:
                (0, _build.tensor_bytes(x, src_idx, valid)
                 + src_idx.numel() * _local_row_bytes(x)))
def rma_alltoallv_fence_fused_peer(x: torch.Tensor, src_idx: torch.Tensor,
                                   valid: torch.Tensor, win: PeerWindow,
                                   capacity: int,
                                   epoch: int | None = None) -> None:
    """This rank's fused fence epoch: its ragged send rows ``x [S, *F]``
    gathered through its row of the baked pack tables (``src_idx`` /
    ``valid [P*C]``) straight into rows ``[me*C, (me+1)*C)`` of every
    rank's window, between the OPEN and the CLOSE of ``epoch``."""
    _check_fused_peer(x, src_idx, valid, win, capacity)
    epoch = win.next_epoch() if epoch is None else epoch
    if x.device.type == "cpu":
        rma_alltoallv_fence_fused_peer_plain(x, src_idx, valid, win, capacity,
                                             epoch)
        return
    _build.check_cuda(x, src_idx, valid, win.local)
    rma_signal(win, OPEN, epoch)
    fence_fused_peer_kernel(x, src_idx, valid, win, capacity)
    rma_signal(win, CLOSE, epoch)


def fence_fused_peer_kernel(x: torch.Tensor, src_idx: torch.Tensor,
                            valid: torch.Tensor, win: PeerWindow,
                            capacity: int) -> None:
    """The gathers and puts of K3's peer form alone (CUDA only; no flag),
    by ``fused_peer_kernel_for``."""
    rb = _local_row_bytes(x)
    kernel = fused_peer_kernel_for(x)
    tile = fused_tile_rows(rb) if kernel is FUSED_PEER else 0
    kernel.launch(x.data_ptr(), src_idx.data_ptr(), valid.data_ptr(),
                  win.peer_ptrs.data_ptr(), win.rank, win.p, capacity, rb,
                  tile, _build.stream_handle(x))


def fence_fused_peer_puts_plain(x: torch.Tensor, src_idx: torch.Tensor,
                                valid: torch.Tensor, win: PeerWindow,
                                capacity: int) -> None:
    """The gathers and puts of K3's peer form as tensor ops."""
    rows = gather_rows_ref(x.unsqueeze(0), src_idx.unsqueeze(0),
                           valid.unsqueeze(0))[0]
    fence_peer_puts_plain(rows, win, capacity)


def rma_alltoallv_fence_fused_peer_plain(x, src_idx, valid, win, capacity,
                                         epoch) -> None:
    """The plain version of the whole peer fused epoch."""
    FUSED_PEER.plain_calls += 1
    rma_signal_plain(win, OPEN, epoch)
    fence_fused_peer_puts_plain(x, src_idx, valid, win, capacity)
    rma_signal_plain(win, CLOSE, epoch)
