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
// fence's advantage over the lock.  One warp moves one destination row
// (rowcopy.cuh); warps walk the output in order, so stores stream and each
// load is a whole source row.  K3 drops the TPU kernel's two VMEM staging
// tiles: each row goes from the ragged send buffer straight into its
// destination bucket.
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
    const long long t = src * bucket_rows + tgt * C + k;
    uint8_t* dst = out + w * row_bytes;
    if (pack_valid[t]) {
      rowcopy::copy_row(dst, x + (src * S + pack_src[t]) * row_bytes,
                        row_bytes, lane);
    } else {
      rowcopy::zero_row(dst, row_bytes, lane);
    }
  }
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

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
