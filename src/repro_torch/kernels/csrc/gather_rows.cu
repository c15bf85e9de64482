// K1: masked row gather, batched over virtual ranks.
//
// Replaces the Pallas TPU kernel `gather_rows` (`_gather_kernel`) in
// src/repro/kernels/gather_rows.py, reached through `ops.pack` / `ops.unpack`.
//
//   out[p, t] = valid[p, t] ? x[p, idx[p, t]] : 0        (p < P, t < N)
//
// With `skip_invalid` set, invalid rows of `out` are left as they are: the
// unpack of a standalone epoch stores straight into the plan's window and
// keeps its stale padding bytes, as the reference's write-through does.
//
// Bound: bytes.  Each valid row is read once and each written row is
// written once, plus 5 bytes of index and mask per row; on an H100 SXM the
// least time is those bytes over 3.35 TB/s of HBM bandwidth.
//
// Design: the TPU kernel stages a tile of rows in VMEM through per-row DMAs
// whose addresses come from a scalar-prefetched index map.  On Hopper no
// staging is needed: one warp moves one output row straight from the source
// row with 16-byte loads and stores (see rowcopy.cuh), each block holds 8
// warps, and a grid-stride loop covers any row count.  Consecutive warps
// write consecutive output rows, so the stores stream; the loads are whole
// rows, so each is a run of full 32-byte sectors.
#include "rowcopy.cuh"

namespace {

__global__ void __launch_bounds__(rowcopy::kThreads)
gather_rows_kernel(const uint8_t* __restrict__ x,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ out, long long S, long long N,
                   long long total, long long row_bytes, int skip_invalid) {
  const int lane = threadIdx.x & 31;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    uint8_t* dst = out + w * row_bytes;
    if (valid[w]) {
      const long long p = w / N;
      const uint8_t* src = x + (p * S + idx[w]) * row_bytes;
      rowcopy::copy_row(dst, src, row_bytes, lane);
    } else if (!skip_invalid) {
      rowcopy::zero_row(dst, row_bytes, lane);
    }
  }
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// x [P, S, row_bytes], idx [P, N] int32, valid [P, N] bool -> out [P, N, row_bytes].
extern "C" int repro_gather_rows(const void* x, const void* idx,
                                 const void* valid, void* out, long long P,
                                 long long S, long long N, long long row_bytes,
                                 int skip_invalid, void* stream) {
  const long long total = P * N;
  if (total > 0 && row_bytes > 0) {
    gather_rows_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(out), S, N,
        total, row_bytes, skip_invalid);
  }
  return static_cast<int>(cudaGetLastError());
}
