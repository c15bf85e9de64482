// K5: stage 2 of the leader-combined hierarchy (the inter-group leader
// exchange) over P virtual ranks on one device.
//
// Replaces the Pallas TPU kernel `rma_hier_leader_exchange`
// (`_hier_leader_kernel`) in src/repro/kernels/a2a_hier.py, reached through
// `ops.fused_hier_leader_exchange`.  It computes what
// `variants.stage2_leader_ppermute` computes (the JAX package's semantic
// definition): every active macro-round m moves one combined slab per
// (source group, target group) pair, from the leader named by the schedule's
// `round_perms[m]` to its partner leader.  For destination rank dst and slab
// row r of round m (s2_offs[m] <= r < s2_offs[m] + s2_caps[m]):
//
//   src = s2_from[dst][m]                  (-1: dst receives nothing in m)
//   out[dst][r] = (src >= 0 && s2_valid[src][r]) ? s1_recv[src][s2_src[src][r]]
//                                                : +0
//
// `round_perms` pairs leaders by ROLE (`leader_perm[o][role]`), so the
// result is right under any `hier_leader_perm`.  The Pallas kernel instead
// picks its ring partner from the physical inner index (it puts to the same
// inner rank q of the group at offset m*P_inner + q + 1), which agrees with
// the schedule only for the identity leader permutation.
//
// Bound: bytes.  Each valid slab row is read once from the stage-1 recv
// buffer and every one of the P * total_s2 output rows is written once, plus
// 5 bytes of index and mask per read row and the small round tables; on an
// H100 SXM the least time is those bytes over 3.35 TB/s of HBM bandwidth.
//
// Design: the ranks are virtual, so a put to the partner leader's window is
// a store into out[dst].  The TPU kernel opens the epoch with a semaphore
// barrier among the round's leaders and stages each slab in two alternating
// VMEM tiles so the gather of round m overlaps the put of round m-1.  On one
// card neither is needed: the epoch's open and close are the launch
// boundaries on the stream, no block spins on a flag, and every round's
// rows are in flight in the one launch.  The kernel walks the OUTPUT: one
// warp per destination row, which it gathers straight from the source
// leader's stage-1 recv row (rowcopy.cuh: 16-byte accesses where aligned),
// so the packed slab buffer of the unfused path is never written.  A row's
// round comes from a [total_s2] int16 table, its source leader from the
// [P, n_macro] table baked from `round_perms`.  Rows of a leader that sits a
// round out are written as zero bytes, as `ppermute` leaves them.
#include "rowcopy.cuh"

namespace {

__global__ void __launch_bounds__(rowcopy::kThreads)
hier_leader_kernel(const uint8_t* __restrict__ s1_recv,
                   const int32_t* __restrict__ s2_src,
                   const uint8_t* __restrict__ s2_valid,
                   const int32_t* __restrict__ s2_from,
                   const int16_t* __restrict__ row_round,
                   uint8_t* __restrict__ out, long long P, long long S1,
                   long long T2, long long n_macro, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long total = P * T2;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    const long long dst = w / T2;
    const long long r = w - dst * T2;
    const long long src = s2_from[dst * n_macro + row_round[r]];
    uint8_t* d = out + w * row_bytes;
    const long long t = src * T2 + r;
    if (src >= 0 && s2_valid[t]) {
      rowcopy::copy_row(d, s1_recv + (src * S1 + s2_src[t]) * row_bytes,
                        row_bytes, lane);
    } else {
      rowcopy::zero_row(d, row_bytes, lane);
    }
  }
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// s1_recv [P, S1, row_bytes], s2_src [P, T2] int32, s2_valid [P, T2] bool,
// s2_from [P, n_macro] int32, row_round [T2] int16 -> out [P, T2, row_bytes].
extern "C" int repro_hier_leader_exchange(
    const void* s1_recv, const void* s2_src, const void* s2_valid,
    const void* s2_from, const void* row_round, void* out, long long P,
    long long S1, long long T2, long long n_macro, long long row_bytes,
    void* stream) {
  const long long total = P * T2;
  if (total > 0 && row_bytes > 0) {
    hier_leader_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(s1_recv),
        static_cast<const int32_t*>(s2_src),
        static_cast<const uint8_t*>(s2_valid),
        static_cast<const int32_t*>(s2_from),
        static_cast<const int16_t*>(row_round), static_cast<uint8_t*>(out), P,
        S1, T2, n_macro, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
