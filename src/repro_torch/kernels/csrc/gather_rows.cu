// K1: masked row gather, batched over virtual ranks.
//
// Replaces the Pallas TPU kernel `gather_rows` (`_gather_kernel`) in
// src/repro/kernels/gather_rows.py, reached through `ops.pack` / `ops.unpack`.
//
//   out[p, t] = valid[p, t] ? src(p, idx[p, t]) : 0        (p < P, t < N)
//
// src(p, i) is row i of x[p] for i < S, else row i - S of x2[p]: the two
// sources read as if concatenated along the row axis (the hierarchy's
// stage-3 pack reads the stage-2 rows and the send buffer so, without the
// concatenation).  With `skip_invalid` set, invalid rows of `out` are left as
// they are: the unpack of a standalone epoch stores straight into the plan's
// window and keeps its stale padding bytes, as the reference's write-through
// does.
//
// Bound: bytes.  Each valid row is read once and each written row is
// written once, plus the tables; on an H100 SXM the least time is those
// bytes over 3.35 TB/s of HBM bandwidth.
//
// The TPU kernel stages a tile of rows in VMEM through per-row DMAs whose
// addresses come from a scalar-prefetched index map.  Two kernels here; the
// wrapper (kernels/gather_rows.py, `kernel_for`) picks one by a rule:
//
// gather_runs_kernel (calls that carry a run table, rows a multiple of 16
// bytes on 16-byte aligned bases): under a persistent plan the index map
// never changes, so INIT (`gather_runs`) cuts the output into chunks, in
// output order, of consecutive source rows landing on consecutive output
// rows, or of zero rows, each at most 16 KiB (RUN_CHUNK_BYTES); one chunk
// is one contiguous source range and one contiguous output range.  Each
// block takes one chunk (grid-stride past 2^24 chunks) and reads its five
// table words: one table read per chunk, where the per-row design reads an
// index and a mask per row and serialises them before the row's loads.  A
// chunk with data moves by 16-byte register copies, each of the block's 256
// threads issuing 4 independent loads before its 4 stores (16 KiB in flight
// per block: rowcopy.cuh's `copy_chunk`); a 1-D TMA bulk mover through
// shared memory measured no faster at any chunk size on an H100.  A zero
// chunk is stored from registers, or skipped in write-through mode.  Blocks are short-lived and
// handed out in output order, so the stores stream, and the blocks on an SM
// overlap one chunk's loads with another's stores.
//
// gather_rows_kernel (any other call): one warp moves one output row
// straight from its source row with 16-byte loads and stores (see
// rowcopy.cuh), each block holds 8 warps, and a grid-stride loop covers any
// row count; the warp reads the row's mask and index first.
//
// Invalid rows are +0.0 by selection (zero bytes), never a multiply.
#include "rowcopy.cuh"

namespace {

__global__ void __launch_bounds__(rowcopy::kThreads)
gather_rows_kernel(const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ x2,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ out, long long S, long long S2,
                   long long N, long long total, long long row_bytes,
                   int skip_invalid) {
  const int lane = threadIdx.x & 31;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    uint8_t* dst = out + w * row_bytes;
    if (valid[w]) {
      const long long p = w / N;
      const long long i = idx[w];
      const uint8_t* src = i < S ? x + (p * S + i) * row_bytes
                                 : x2 + (p * S2 + i - S) * row_bytes;
      rowcopy::copy_row(dst, src, row_bytes, lane);
    } else if (!skip_invalid) {
      rowcopy::zero_row(dst, row_bytes, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// gather_runs_kernel: one chunk of the INIT-baked run table per block
// ---------------------------------------------------------------------------

constexpr int kRunThreads = rowcopy::kChunkThreads;
constexpr long long kMaxRunGrid = 1LL << 24;
constexpr int kRunFields = 5;               // rank, out row, source, src row, rows
constexpr int kFromX = 0, kZeros = 2;       // source; 1 is x2

__global__ void __launch_bounds__(kRunThreads)
gather_runs_kernel(const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ x2,
                   const int32_t* __restrict__ runs, long long n_chunks,
                   uint8_t* __restrict__ out, long long S, long long S2,
                   long long N, long long row_bytes, int skip_invalid) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int32_t* ch = runs + c * kRunFields;
    const long long rank = ch[0], t0 = ch[1], s0 = ch[3];
    const int source = ch[2];
    const long long nvec = ch[4] * row_bytes / 16;
    uint4* __restrict__ dst =
        reinterpret_cast<uint4*>(out + (rank * N + t0) * row_bytes);
    if (source == kZeros) {
      if (skip_invalid) continue;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (long long v = threadIdx.x; v < nvec; v += kRunThreads) dst[v] = z;
      continue;
    }
    const uint4* __restrict__ src = reinterpret_cast<const uint4*>(
        source == kFromX ? x + (rank * S + s0) * row_bytes
                         : x2 + (rank * S2 + s0) * row_bytes);
    rowcopy::copy_chunk(dst, src, nvec);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// x [P, S, row_bytes], x2 [P, S2, row_bytes] (or null), idx [P, N] int32,
// valid [P, N] bool -> out [P, N, row_bytes].
extern "C" int repro_gather_rows(const void* x, const void* x2, const void* idx,
                                 const void* valid, void* out, long long P,
                                 long long S, long long S2, long long N,
                                 long long row_bytes, int skip_invalid,
                                 void* stream) {
  const long long total = P * N;
  if (total > 0 && row_bytes > 0) {
    gather_rows_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(x2),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(out), S, S2, N, total, row_bytes, skip_invalid);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function from the run table `runs` (device, int32 [n_chunks, 5]:
// rank, first output row, source 0 = x / 1 = x2 / 2 = zeros, first source
// row, rows) with gather_runs_kernel.  row_bytes must be a 16-byte multiple
// and x, x2 (if given) and out 16-byte aligned, or the call is refused with
// cudaErrorInvalidValue.
extern "C" int repro_gather_rows_runs(const void* x, const void* x2,
                                      const void* runs, long long n_chunks,
                                      void* out, long long S, long long S2,
                                      long long N, long long row_bytes,
                                      int skip_invalid, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || n_chunks < 0 || !aligned16(x) ||
      (x2 != nullptr && !aligned16(x2)) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid =
      static_cast<unsigned>(n_chunks < kMaxRunGrid ? n_chunks : kMaxRunGrid);
  gather_runs_kernel<<<grid, kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(x2),
      static_cast<const int32_t*>(runs), n_chunks, static_cast<uint8_t*>(out),
      S, S2, N, row_bytes, skip_invalid);
  return static_cast<int>(cudaGetLastError());
}
