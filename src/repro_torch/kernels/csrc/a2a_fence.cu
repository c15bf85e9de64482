// K2 and K3: the fence-synchronised alltoallv epoch over P virtual ranks on
// one device.
//
// K2 replaces the Pallas TPU kernel `rma_alltoallv_fence` (`_fence_kernel`)
// in src/repro/kernels/a2a_fence.py, the paper's Algorithm 1:
//
//   out[tgt][src*C + k] = packed[src][tgt*C + k]      (src, tgt < P; k < C)
//
// K2 also takes G independent groups of P ranks in the same launch,
// out[g][tgt][src*C + k] = packed[g][src][tgt*C + k]: the inner all-to-alls
// of the leader-combined hierarchy (stages 1 and 3 of
// `hierarchy_exchange_combined` in src/repro/core/variants.py, which the JAX
// package runs as `lax.all_to_all` over the inner mesh axis) are one K2
// launch over all P_outer groups.
//
// K3 replaces `rma_alltoallv_fence_fused` (`_fused_fence_kernel`) in the same
// file: the same epoch with the pack gather fused in, so the padded
// [P*C, F] send layout is never written:
//
//   t = src*P*C + tgt*C + k
//   out[tgt][src*C + k] = pack_valid[t] ? x[src][pack_src[t]] : 0
//
// Bound: bytes.  K2 reads every bucket row once and writes it once; K3 reads
// each valid source row once (plus 5 bytes of index and mask per row) and
// writes every bucket row once.  On an H100 SXM the least time is those
// bytes over 3.35 TB/s of HBM bandwidth.
//
// Design: the ranks are virtual, so "rank tgt's window" is the slice
// out[tgt] of one allocation and each put is a store into it.  The TPU
// kernel's epoch OPEN (a semaphore barrier with every peer) and CLOSE (wait
// for sends to drain and P-1 blocks to arrive) become the launch boundaries
// on the stream: everything before the launch is visible to it, and
// everything after it sees all of its stores.  No block spins on a flag set
// by another block: blocks are not guaranteed to be resident together, so a
// barrier across them can deadlock.  All P*P bucket copies, the local bucket
// (src == tgt) included, are in flight in the one launch, which is the
// fence's advantage over the lock.
//
// K2 has two kernels; the wrapper (kernels/a2a_fence.py, `fence_kernel_for`)
// picks one by a rule on the inputs alone.
//
// fence_bulk_kernel (buckets of C*row_bytes bytes that are a 16-byte
// multiple, on 16-byte aligned bases: every plan's rows of even width,
// since every plan's capacity is a multiple of 8).  The TPU kernel never
// worked row by row: it puts each bucket as one contiguous remote DMA.  In
// the global view bucket (g, src -> tgt) is one contiguous run of
// L = C*row_bytes bytes in both buffers: it is read at ((g*P + src)*P +
// tgt)*L and written at ((g*P + tgt)*P + src)*L.  So the epoch is G*P*P
// copies of L bytes, whatever the row width: a 4-byte row costs no more
// instructions per byte than a 1 KiB one.  Each bucket is cut into chunks
// of at most `chunk_bytes` (8 KiB; the wrapper's FENCE_CHUNK_BYTES), the
// same number in every bucket; the last chunk of a bucket may be shorter.
// Block b takes chunk b in output order (grid-stride past 2^24 chunks) and
// finds its bucket and offset with one 64-bit division per chunk (and two
// 32-bit ones for the bucket's ranks), never per row; no table, so INIT is
// unchanged.  A chunk moves by rowcopy.cuh's `copy_chunk`, K1's run loop:
// 256 threads issuing up to 4 independent 16-byte loads each before their
// stores (K1's redesign found a TMA bulk mover no faster at any chunk
// size); an 8 KiB chunk is two loads per thread, and more, shorter blocks
// measured 0.3-0.8 % faster than 16 KiB chunks on an H100 at 1 KiB to 4 KiB
// rows and at the gradient sync (chip_smoke.py's chunk sweep), equal on
// 4-byte rows.  Cutting buckets into chunks is what fills the card when
// buckets are few and large: the gradient sync's epoch is P=2, four
// buckets of about 545 MB, which one block per bucket would move on four
// SMs.  Blocks are short-lived and handed out in output order, so the
// stores stream.
//
// fence_kernel (every other call: buckets that are not a 16-byte multiple,
// bases that are not 16-byte aligned) and fence_fused_kernel: one warp
// moves one destination row (rowcopy.cuh); warps walk the output in order,
// so stores stream and each load is a whole source row.  K3 drops the TPU
// kernel's two VMEM staging tiles: each row goes from the ragged send
// buffer straight into its destination bucket.
//
// K3 has a second kernel, fence_fused_bulk_kernel, which the wrapper
// (kernels/a2a_fence.py, `fused_kernel_for`) picks for row widths that are
// multiples of 16 bytes up to 32 KiB on 16-byte aligned bases; other rows
// keep fence_fused_kernel.  It uses two facts the warp-per-row kernel does
// not: the output of one bucket (tgt, src) is C contiguous rows, and its
// valid source rows come in runs of consecutive indices (at P=8 with 1 MiB
// messages each bucket is one run).  The output is cut into tiles of T rows
// inside one bucket, T = 8 KiB / row_bytes (1..32 rows; the wrapper's
// `fused_tile_rows`), so a tile's output is one contiguous range; block b
// takes tile b (grid-stride past 2^24 tiles).  Every warp reads the tile's
// valid bytes, one row per lane, in one load.  A tile with no valid row is
// stored as zeros from registers by the whole block and nothing is loaded.
// In a tile with data, warp 0 reads the source indices of its valid rows,
// writes the invalid rows as zero bytes into the block's one 8 KiB stage
// of shared memory (then `fence.proxy.async`), and finds the runs of
// consecutive source rows with one shuffle and one ballot: the lane that
// starts a run issues one 1-D TMA bulk load for the whole run, completing
// on an mbarrier (bulkcopy.cuh); one bulk store then writes the tile.  The
// blocks on an SM (up to 16) are the ring: one block's loads overlap
// another's stores, and the hardware hands out tiles in output order.
// Invalid rows are +0.0 by selection (zero bytes), never a multiply.  The
// mbarrier wait traps after ~10 s.
#include "bulkcopy.cuh"
#include "rma_flags.cuh"
#include "rowcopy.cuh"

namespace {

__global__ void __launch_bounds__(rowcopy::kThreads)
fence_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ out,
             long long G, long long P, long long C, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long bucket_rows = P * C;
  const long long group_rows = P * bucket_rows;
  const long long total = G * group_rows;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    const long long g = w / group_rows;
    const long long in_group = w - g * group_rows;
    const long long tgt = in_group / bucket_rows;
    const long long rem = in_group - tgt * bucket_rows;
    const long long src = rem / C;
    const long long k = rem - src * C;
    rowcopy::copy_row(
        out + w * row_bytes,
        packed + (g * group_rows + src * bucket_rows + tgt * C + k) * row_bytes,
        row_bytes, lane);
  }
}

constexpr long long kMaxChunkGrid = 1LL << 24;  // more chunks: blocks loop

// Chunk c of buckets of `bucket_vecs` vectors, each cut into
// `chunks_per_bucket` chunks of at most `chunk_vecs`: its bucket, its first
// vector in the bucket and its length.  K2's bucket kernel.
struct Chunk {
  long long bucket, v0, n;
};

__device__ __forceinline__ Chunk chunk_of(long long c, long long bucket_vecs,
                                          long long chunk_vecs,
                                          long long chunks_per_bucket) {
  const long long b = c / chunks_per_bucket;
  const long long v0 = (c - b * chunks_per_bucket) * chunk_vecs;
  const long long rest = bucket_vecs - v0;
  return {b, v0, rest < chunk_vecs ? rest : chunk_vecs};
}

// The calling block moves one chunk of `n` elements of width V: 16-byte
// vectors by rowcopy.cuh's `copy_chunk`, anything else one per thread.
// K2's bucket kernel and K2 peer.
template <typename V>
__device__ __forceinline__ void move_chunk(V* __restrict__ dst,
                                           const V* __restrict__ src,
                                           long long n) {
  if constexpr (sizeof(V) == 16) {
    rowcopy::copy_chunk(dst, src, n);
  } else {
    for (long long v = threadIdx.x; v < n; v += rowcopy::kChunkThreads)
      dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(rowcopy::kChunkThreads)
fence_bulk_kernel(const uint4* __restrict__ packed, uint4* __restrict__ out,
                  unsigned P, long long bucket_vecs, long long chunk_vecs,
                  long long chunks_per_bucket, long long n_chunks) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // Output bucket o = (g*P + tgt)*P + src, and the chunk's place in it.
    const Chunk k = chunk_of(c, bucket_vecs, chunk_vecs, chunks_per_bucket);
    const unsigned o = static_cast<unsigned>(k.bucket);
    const unsigned gt = o / P;  // g*P + tgt
    const unsigned src = o - gt * P;
    const unsigned g = gt / P, tgt = gt - g * P;
    const long long in = (static_cast<long long>(g) * P + src) * P + tgt;
    move_chunk(out + k.bucket * bucket_vecs + k.v0,
               packed + in * bucket_vecs + k.v0, k.n);
  }
}

// The calling warp writes one row of K3's output at `dst`: table entry t
// of the origin (`pack_src`/`pack_valid`), its source row in the origin's
// send rows `xs`, or zero bytes.  K3's one-process and peer warp kernels.
__device__ __forceinline__ void fused_row(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ xs,
                                          const int32_t* __restrict__ pack_src,
                                          const uint8_t* __restrict__ pack_valid,
                                          long long t, long long row_bytes,
                                          int lane) {
  if (pack_valid[t]) {
    rowcopy::copy_row(dst, xs + static_cast<long long>(pack_src[t]) * row_bytes,
                      row_bytes, lane);
  } else {
    rowcopy::zero_row(dst, row_bytes, lane);
  }
}

__global__ void __launch_bounds__(rowcopy::kThreads)
fence_fused_kernel(const uint8_t* __restrict__ x,
                   const int32_t* __restrict__ pack_src,
                   const uint8_t* __restrict__ pack_valid,
                   uint8_t* __restrict__ out, long long P, long long S,
                   long long C, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long bucket_rows = P * C;
  const long long total = P * bucket_rows;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    const long long tgt = w / bucket_rows;
    const long long rem = w - tgt * bucket_rows;
    const long long src = rem / C;
    const long long k = rem - src * C;
    fused_row(out + w * row_bytes, x + src * S * row_bytes, pack_src,
              pack_valid, src * bucket_rows + tgt * C + k, row_bytes, lane);
  }
}


// ---------------------------------------------------------------------------
// fence_fused_bulk_kernel: one output tile per block, bulk copies of runs
// ---------------------------------------------------------------------------

constexpr int kBulkThreads = 128;          // warp 0 gathers; all store zeros
constexpr long long kTileBytes = 8192;     // target bytes of a tile
constexpr int kMaxTileRows = 32;           // one table word per lane
constexpr long long kMaxRowBytes = 32768;  // a tile holds at least one row
constexpr long long kMaxGrid = 1LL << 24;  // more tiles: blocks loop

// Rows of one tile for `row_bytes` (the wrapper's `fused_tile_rows`).
__host__ __device__ inline long long tile_rows_for(long long row_bytes) {
  const long long t = kTileBytes / row_bytes;
  return t < 1 ? 1 : (t > kMaxTileRows ? kMaxTileRows : t);
}

// The block's stage for one tile (128-byte aligned in dynamic shared
// memory) and its mbarrier, initialised; every thread of the block calls it.
__device__ __forceinline__ uint8_t* tile_stage(uint8_t* smem_raw,
                                              uint64_t* full) {
  if (threadIdx.x == 0) {
    bulk::mbar_init(full, 1);
    bulk::fence_mbar_init();
  }
  __syncthreads();
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
}

// The calling block writes one tile of K3's output: `rows` (at most 32)
// rows at `out`, from table entries t0.. of the origin (`pack_src`/
// `pack_valid`) over its send rows `xs`.  Every warp reads the tile's valid
// bytes; a tile with no valid row is stored as zeros by the whole block,
// else warp 0 stages it (zero rows, one bulk load per run of consecutive
// source rows) and bulk-stores it.  `parity` is the mbarrier's phase, which
// warp 0 flips for each tile it stages.  K3's one-process and peer tile
// kernels.
__device__ __forceinline__ void fused_tile(const uint8_t* __restrict__ xs,
                                           const int32_t* __restrict__ pack_src,
                                           const uint8_t* __restrict__ pack_valid,
                                           uint8_t* out, long long t0,
                                           long long rows, long long row_bytes,
                                           uint8_t* stage, uint64_t* full,
                                           uint32_t& parity) {
  constexpr unsigned kAll = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long vecs = row_bytes / 16;
  const bool ok = lane < rows && pack_valid[t0 + lane] != 0;
  const unsigned valid_rows = __ballot_sync(kAll, ok);
  if (valid_rows == 0) {
    // No valid row: the block stores the tile's zeros from registers.
    uint4* dz = reinterpret_cast<uint4*>(out);
    const long long n = rows * vecs;
#pragma unroll 4
    for (long long q = threadIdx.x; q < n; q += kBulkThreads)
      dz[q] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  if (warp != 0) return;
  // Warp 0 gathers: the invalid rows as zero bytes in the stage, the valid
  // ones by one bulk load per run of consecutive source rows.
  const int32_t si = ok ? pack_src[t0 + lane] : 0;
  const unsigned tile_mask = rows >= 32 ? kAll : (1u << rows) - 1u;
  const unsigned invalid = tile_mask & ~valid_rows;
  for (unsigned m = invalid; m; m &= m - 1) {
    uint4* dz = reinterpret_cast<uint4*>(stage + (__ffs(m) - 1) * row_bytes);
    for (long long q = lane; q < vecs; q += 32)
      dz[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (invalid) bulk::fence_proxy_async();
  __syncwarp();
  if (lane == 0)
    bulk::mbar_arrive_expect_tx(
        full, static_cast<uint32_t>(__popc(valid_rows) * row_bytes));
  __syncwarp();
  // A valid row starts a run unless it continues the row before it; the
  // lane that starts a run loads it, up to the run's last row.
  const int32_t prev = __shfl_up_sync(kAll, si, 1);
  const bool cont = lane > 0 && ok && (valid_rows >> (lane - 1) & 1u) &&
                    prev + 1 == si;
  const unsigned conts = __ballot_sync(kAll, cont);
  if (ok && !cont) {
    const unsigned rest = lane == 31 ? 0u : conts >> (lane + 1);
    const int len = __ffs(~rest);
    bulk::load(stage + lane * row_bytes,
               xs + static_cast<long long>(si) * row_bytes,
               static_cast<uint32_t>(len * row_bytes), full);
  }
  if (lane == 0) {
    bulk::mbar_wait(full, parity);
    bulk::store(out, stage, static_cast<uint32_t>(rows * row_bytes));
    bulk::commit();
    bulk::wait_read<0>();  // the stage is free again
  }
  parity ^= 1u;
  __syncwarp();
}

__global__ void __launch_bounds__(kBulkThreads)
fence_fused_bulk_kernel(const uint8_t* __restrict__ x,
                        const int32_t* __restrict__ pack_src,
                        const uint8_t* __restrict__ pack_valid,
                        uint8_t* __restrict__ out, long long P, long long S,
                        long long C, long long row_bytes, long long T) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full;
  uint8_t* stage = tile_stage(smem_raw, &full);
  const long long kt = (C + T - 1) / T;  // tiles per bucket
  const long long n_tiles = P * P * kt;
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long tgt = tile / (P * kt), rem = tile - tgt * P * kt;
    const long long src = rem / kt, k0 = (rem - src * kt) * T;
    const long long rows = C - k0 < T ? C - k0 : T;
    const long long first = (tgt * P + src) * C + k0;  // output row
    fused_tile(x + src * S * row_bytes, pack_src, pack_valid,
               out + first * row_bytes, src * P * C + tgt * C + k0, rows,
               row_bytes, stage, &full, parity);
  }
}

// ---------------------------------------------------------------------------
// The peer forms: one process per rank, puts through peer window pointers
// ---------------------------------------------------------------------------
//
// With one process per rank, this process is origin `me` and every other
// rank's window is another process's allocation that it maps (CUDA IPC,
// rma_signal.cu).  `peers[t]` is rank t's window base as this process sees
// it (its own at `me`); bucket t of the local send layout goes to rows
// [me*C, (me+1)*C) of rank t's window, the put-displacement rule of the
// bucketed layout:
//
//   window_t[me*C + k] = packed[t*C + k]                       (K2)
//   window_t[me*C + k] = pack_valid[t*C + k] ? x[pack_src[t*C + k]] : 0  (K3)
//
// K2 peer runs the whole fence epoch, OPEN and CLOSE included, in one
// launch (below).  K3 peer's epoch is the signal kernel (rma_signal.cu), its
// puts and the signal kernel again on the same stream: those kernels only
// move bytes, and no block waits on anything.

// K2 peer: the fence epoch of origin `me` in ONE launch, as the TPU kernel
// (`_fence_kernel`, src/repro/kernels/a2a_fence.py:41-86) does its barrier,
// its puts and its closing waits in one `pallas_call`.  Each block takes a
// ticket from an atomic counter in this rank's SyncWords.
//
//   - OPEN: the block with ticket 0 signals `open[me]` on every peer (my
//     window is free: stream order put my last unpack before this launch),
//     waits for every peer's `open` in my pad, then sets the go word to the
//     epoch.  That block is running, so every other block may wait on the
//     go word, whether or not the whole grid is resident.
//   - The puts: every bucket is one contiguous run of C*row_bytes bytes,
//     cut into chunks of at most `chunk_vecs` vectors (fence_bulk_kernel's
//     chunks, with a peer base), the blocks taking chunks ticket,
//     ticket + grid, ... by rowcopy.cuh's `copy_chunk` (16-byte vectors
//     where buckets and bases allow, else bytes).  Chunk indices fit in 32
//     bits, so a chunk's bucket is one 32-bit division.
//   - Each block publishes its puts (a fence at the flags' scope) and
//     arrives on a counter; the last block to arrive signals
//     `close[me]` on every peer, waits for every peer's `close`, and resets
//     the ticket and arrival counters for the next launch.
//
// The grid is the wrapper's: at most the window's `fence_ctas` (the card's
// resident blocks of this kernel split over the ranks that share the card)
// and at most the chunk count.  The flags take system scope, or GPU scope
// where every rank shares this card (`sys`, rma_flags.cuh).  Every wait is
// bounded.
// Bound: bytes, every bucket read once and written once; the flags are
// latency: P-1 remote stores and P-1 polled loads for each of OPEN and
// CLOSE.
template <typename V>
__global__ void __launch_bounds__(rowcopy::kChunkThreads)
fence_peer_kernel(const V* __restrict__ packed,
                  const unsigned long long* __restrict__ peers,
                  const unsigned long long* __restrict__ pads, int me, int P,
                  int slots, long long bucket_vecs, unsigned chunk_vecs,
                  unsigned chunks_per_bucket, unsigned n_chunks, int sys,
                  long long epoch, long long timeout_ns, rma::SyncWords* sync,
                  long long* err) {
  __shared__ unsigned ticket_s, last_s;
  long long* mine = reinterpret_cast<long long*>(pads[me]);
  if (threadIdx.x == 0) ticket_s = atomicAdd(&sync->ticket, 1u);
  __syncthreads();
  const unsigned ticket = ticket_s;
  if (ticket == 0) {
    rma::fence(sys);
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      if (j != me)
        rma::signal(rma::flag(reinterpret_cast<long long*>(pads[j]), P, slots,
                              rma::kOpen, me, 0),
                    epoch, sys);
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      if (j != me)
        rma::wait(rma::flag(mine, P, slots, rma::kOpen, j, 0), P, rma::kOpen,
                  j, me, epoch, timeout_ns, err, sys);
    __syncthreads();
    if (threadIdx.x == 0) rma::store_release(&sync->go, epoch, false);
  } else {
    if (threadIdx.x == 0)
      rma::wait_local(&sync->go, P, me, epoch, timeout_ns, err);
    __syncthreads();
  }
  const long long own = static_cast<long long>(me) * bucket_vecs;
  for (unsigned c = ticket; c < n_chunks; c += gridDim.x) {
    const unsigned t = c / chunks_per_bucket;
    const long long v0 =
        static_cast<long long>(c - t * chunks_per_bucket) * chunk_vecs;
    const long long rest = bucket_vecs - v0;
    move_chunk(reinterpret_cast<V*>(peers[t]) + own + v0,
               packed + t * bucket_vecs + v0,
               rest < chunk_vecs ? rest : static_cast<long long>(chunk_vecs));
  }
  rma::fence(sys);
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = rma::add_acq_rel_gpu(&sync->arrive, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  // Every block's puts are published: CLOSE.
  rma::fence(sys);
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    if (j != me)
      rma::signal(rma::flag(reinterpret_cast<long long*>(pads[j]), P, slots,
                            rma::kClose, me, 0),
                  epoch, sys);
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    if (j != me)
      rma::wait(rma::flag(mine, P, slots, rma::kClose, j, 0), P, rma::kClose,
                j, me, epoch, timeout_ns, err, sys);
  __syncthreads();
  if (threadIdx.x == 0) {
    sync->ticket = 0u;
    sync->arrive = 0u;
  }
}

// K3 peer, one warp per destination row (any row width and base).
__global__ void __launch_bounds__(rowcopy::kThreads)
fence_fused_peer_warp_kernel(const uint8_t* __restrict__ x,
                             const int32_t* __restrict__ pack_src,
                             const uint8_t* __restrict__ pack_valid,
                             const unsigned long long* __restrict__ peers,
                             long long me, long long P, long long C,
                             long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long total = P * C;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    const long long t = w / C;
    const long long k = w - t * C;
    fused_row(reinterpret_cast<uint8_t*>(peers[t]) + (me * C + k) * row_bytes,
              x, pack_src, pack_valid, w, row_bytes, lane);
  }
}

// K3 peer, the tile kernel (fence_fused_bulk_kernel's tiles for one origin,
// with peer bases): tile b is rows [k0, k0 + T) of bucket t; its valid rows
// come in by TMA bulk loads of runs into shared memory, and one bulk store
// writes the tile into rank t's window through the mapped pointer.
__global__ void __launch_bounds__(kBulkThreads)
fence_fused_peer_bulk_kernel(const uint8_t* __restrict__ x,
                             const int32_t* __restrict__ pack_src,
                             const uint8_t* __restrict__ pack_valid,
                             const unsigned long long* __restrict__ peers,
                             long long me, long long P, long long C,
                             long long row_bytes, long long T) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full;
  uint8_t* stage = tile_stage(smem_raw, &full);
  const long long kt = (C + T - 1) / T;  // tiles per bucket
  const long long n_tiles = P * kt;
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long t = tile / kt, k0 = (tile - t * kt) * T;
    const long long rows = C - k0 < T ? C - k0 : T;
    fused_tile(x, pack_src, pack_valid,
               reinterpret_cast<uint8_t*>(peers[t]) + (me * C + k0) * row_bytes,
               t * C + k0, rows, row_bytes, stage, &full, parity);
  }
  // Every bulk store of this block has written before the block ends (the
  // CLOSE signal after this launch orders them for the peers).
  if (threadIdx.x == 0) bulk::wait_all();
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// K2 peer: the fence epoch `epoch` of origin `me`: packed [P*C, row_bytes]
// (this rank's send buckets) -> rows [me*C, (me+1)*C) of every rank t's
// window, `peers` (device, P addresses), with the flags of the signal pads
// `pads` (device, P addresses; `slots` round slots per origin) and this
// rank's `sync` words; the flags at system scope if `sys`, else GPU scope
// (every rank on this card).  16-byte accesses where C*row_bytes is a
// 16-byte multiple and packed and every window base are 16-byte aligned
// (`vec16`, which the wrapper checks for the bases), byte accesses
// otherwise.  The grid is min(`ctas`, chunks), at least one block.
extern "C" int repro_a2a_fence_peer(const void* packed, const void* peers,
                                    const void* pads, int me, int P, int slots,
                                    long long C, long long row_bytes,
                                    long long chunk_bytes, int vec16, int ctas,
                                    int sys, long long epoch,
                                    long long timeout_ns, void* sync,
                                    void* err, void* stream) {
  const long long bucket_bytes = C * row_bytes;
  if (me < 0 || me >= P || slots < 1 || C < 0 || row_bytes < 0 ||
      chunk_bytes <= 0 || chunk_bytes % 16 != 0 || ctas < 1 ||
      (vec16 && (bucket_bytes % 16 != 0 ||
                 (reinterpret_cast<uintptr_t>(packed) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_bucket = (bucket_bytes + chunk_bytes - 1) / chunk_bytes;
  const long long n_chunks = P * per_bucket;
  if (n_chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(
      n_chunks < ctas ? (n_chunks > 0 ? n_chunks : 1) : ctas);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* table = static_cast<const unsigned long long*>(peers);
  const auto* pad_table = static_cast<const unsigned long long*>(pads);
  auto* words = static_cast<rma::SyncWords*>(sync);
  auto* rec = static_cast<long long*>(err);
  const long long div = vec16 ? 16 : 1;
  if (vec16) {
    fence_peer_kernel<uint4><<<grid, rowcopy::kChunkThreads, 0, s>>>(
        static_cast<const uint4*>(packed), table, pad_table, me, P, slots,
        bucket_bytes / div, static_cast<unsigned>(chunk_bytes / div),
        static_cast<unsigned>(per_bucket), static_cast<unsigned>(n_chunks),
        sys, epoch, timeout_ns, words, rec);
  } else {
    fence_peer_kernel<uint8_t><<<grid, rowcopy::kChunkThreads, 0, s>>>(
        static_cast<const uint8_t*>(packed), table, pad_table, me, P, slots,
        bucket_bytes, static_cast<unsigned>(chunk_bytes),
        static_cast<unsigned>(per_bucket), static_cast<unsigned>(n_chunks),
        sys, epoch, timeout_ns, words, rec);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the card says of K2 peer's kernel (16-byte form if `vec16`, else the
// byte form) on the current device: out = [resident blocks per SM, SMs,
// registers per thread, local memory bytes per thread (spills)].
extern "C" int repro_a2a_fence_peer_info(int vec16, int* out) {
  const void* fn =
      vec16 ? reinterpret_cast<const void*>(fence_peer_kernel<uint4>)
            : reinterpret_cast<const void*>(fence_peer_kernel<uint8_t>);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], fn, rowcopy::kChunkThreads, 0);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, fn);
  if (rc == cudaSuccess) {
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(rc);
}

// K3 peer: x [S, row_bytes] (this rank's send rows), pack_src / pack_valid
// [P*C] (this rank's row of the baked pack tables) -> rows [me*C, (me+1)*C)
// of every rank t's window.  `tile_rows` > 0 takes the tile kernel (the
// wrapper's `fused_tile_rows(row_bytes)`; row_bytes a 16-byte multiple of at
// most 32 KiB, x and the window bases 16-byte aligned), 0 the warp-per-row
// kernel.
extern "C" int repro_a2a_fence_fused_peer(const void* x, const void* pack_src,
                                          const void* pack_valid,
                                          const void* peers, long long me,
                                          long long P, long long C,
                                          long long row_bytes,
                                          long long tile_rows, void* stream) {
  if (me < 0 || me >= P || C < 0 || row_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* table = static_cast<const unsigned long long*>(peers);
  if (tile_rows == 0) {
    const long long total = P * C;
    if (total > 0 && row_bytes > 0)
      fence_fused_peer_warp_kernel<<<rowcopy::blocks_for(total),
                                     rowcopy::kThreads, 0, s>>>(
          static_cast<const uint8_t*>(x), static_cast<const int32_t*>(pack_src),
          static_cast<const uint8_t*>(pack_valid), table, me, P, C, row_bytes);
    return static_cast<int>(cudaGetLastError());
  }
  if (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > kMaxRowBytes ||
      tile_rows != tile_rows_for(row_bytes) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = P * ((C + tile_rows - 1) / tile_rows);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int smem = static_cast<int>(tile_rows * row_bytes + 128);
  fence_fused_peer_bulk_kernel<<<static_cast<unsigned>(
                                     n_tiles < kMaxGrid ? n_tiles : kMaxGrid),
                                 kBulkThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(pack_src),
      static_cast<const uint8_t*>(pack_valid), table, me, P, C, row_bytes,
      tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// packed [G*P, P*C, row_bytes] -> out [G*P, P*C, row_bytes].
extern "C" int repro_a2a_fence(const void* packed, void* out, long long G,
                               long long P, long long C, long long row_bytes,
                               void* stream) {
  const long long total = G * P * P * C;
  if (total > 0 && row_bytes > 0) {
    fence_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), G, P,
        C, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function as repro_a2a_fence with fence_bulk_kernel, in chunks
// of `chunk_bytes` (a positive 16-byte multiple).  C*row_bytes must be a
// 16-byte multiple and packed and out 16-byte aligned, and G*P*P must fit
// in 32 bits, or the call is refused with cudaErrorInvalidValue.
extern "C" int repro_a2a_fence_bulk(const void* packed, void* out, long long G,
                                    long long P, long long C,
                                    long long row_bytes, long long chunk_bytes,
                                    void* stream) {
  const long long bucket_bytes = C * row_bytes;
  if (G < 0 || P < 0 || C < 0 || row_bytes < 0 || bucket_bytes % 16 != 0 ||
      chunk_bytes <= 0 || chunk_bytes % 16 != 0 || G * P * P > 0xffffffffLL ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_bucket = (bucket_bytes + chunk_bytes - 1) / chunk_bytes;
  const long long n_chunks = G * P * P * per_bucket;
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  fence_bulk_kernel<<<static_cast<unsigned>(
                          n_chunks < kMaxChunkGrid ? n_chunks : kMaxChunkGrid),
                      rowcopy::kChunkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(packed), static_cast<uint4*>(out),
      static_cast<unsigned>(P), bucket_bytes / 16, chunk_bytes / 16,
      per_bucket, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// x [P, S, row_bytes], pack_src [P, P*C] int32, pack_valid [P, P*C] bool
// -> out [P, P*C, row_bytes].
extern "C" int repro_a2a_fence_fused(const void* x, const void* pack_src,
                                     const void* pack_valid, void* out,
                                     long long P, long long S, long long C,
                                     long long row_bytes, void* stream) {
  const long long total = P * P * C;
  if (total > 0 && row_bytes > 0) {
    fence_fused_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(pack_src),
        static_cast<const uint8_t*>(pack_valid), static_cast<uint8_t*>(out),
        P, S, C, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function as repro_a2a_fence_fused with fence_fused_bulk_kernel.
// `tile_rows` is the wrapper's `fused_tile_rows(row_bytes)`; row_bytes must
// be a 16-byte multiple of at most 32 KiB and x and out 16-byte aligned, or
// the call is refused with cudaErrorInvalidValue.
extern "C" int repro_a2a_fence_fused_bulk(const void* x, const void* pack_src,
                                          const void* pack_valid, void* out,
                                          long long P, long long S, long long C,
                                          long long row_bytes,
                                          long long tile_rows, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > kMaxRowBytes ||
      tile_rows != tile_rows_for(row_bytes) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = P * P * ((C + tile_rows - 1) / tile_rows);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  // One tile of at most 32 KiB, aligned: under the 48 KiB a block may take
  // without opting in.
  const int smem = static_cast<int>(tile_rows * row_bytes + 128);
  fence_fused_bulk_kernel<<<static_cast<unsigned>(
                                n_tiles < kMaxGrid ? n_tiles : kMaxGrid),
                            kBulkThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(pack_src),
      static_cast<const uint8_t*>(pack_valid), static_cast<uint8_t*>(out), P,
      S, C, row_bytes, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
