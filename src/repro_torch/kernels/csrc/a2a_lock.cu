// K4: one step of the lock-synchronised (passive-target) alltoallv epoch
// over P virtual ranks on one device.
//
// Replaces the Pallas TPU kernel `rma_alltoallv_lock` (`_lock_kernel`) in
// src/repro/kernels/a2a_lock.py, the paper's Algorithm 3, and the per-round
// capacities and round elision of `variants.lock_exchange`
// (src/repro/core/variants.py).  Round r sends rank i's bucket for
// tgt = (i + r) % P (ring) or tgt = i ^ r (pairwise, P a power of two):
//
//   out[tgt][i*C + k] = k < cap_r ? packed[i][tgt*C + k] : 0
//
// Round 0 is the local bucket (tgt = i, cap = C).  A round whose capacity is
// 0 carries no data anywhere: its received buckets are all zero.
//
// Bound: bytes.  Each step reads the rows below cap_r of its buckets once and
// writes every row of its buckets once; on an H100 SXM the least time for a
// whole epoch is its bytes over 3.35 TB/s of HBM bandwidth.
//
// Design: the TPU kernel runs P-1 serialised rounds, each remote put waited
// for before the next one starts: the lock/unlock pair around each target's
// epoch.  Here one launch carries one active round, and the launches follow
// each other on one stream: stream order is the per-target lock, so a round
// starts only when the previous one has completed.  Elided rounds launch
// nothing.  The first launch of an epoch also carries the local bucket and
// writes the zero buckets of every elided round, so each epoch launches once
// per active round (once in all when every round is elided).  A launch's
// rounds are passed by value in the kernel's parameters.  One warp moves one
// destination row (rowcopy.cuh).
#include "rowcopy.cuh"

namespace {

constexpr int kMaxStepRounds = 256;

struct LockStep {
  int n;                         // rounds carried by this launch
  int pairwise;                  // 0: ring schedule, 1: pairwise (XOR)
  int rounds[kMaxStepRounds];    // round index r (0 = local bucket)
  int caps[kMaxStepRounds];      // rows of each bucket that carry data
};

__global__ void __launch_bounds__(rowcopy::kThreads)
lock_step_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ out,
                 long long P, long long C, long long row_bytes,
                 const LockStep step) {
  const int lane = threadIdx.x & 31;
  const long long bucket_rows = P * C;
  const long long total = step.n * bucket_rows;
  for (long long w = rowcopy::first_warp_row(); w < total;
       w += rowcopy::warp_row_stride()) {
    const long long j = w / bucket_rows;
    const long long rem = w - j * bucket_rows;
    const long long i = rem / C;
    const long long k = rem - i * C;
    const long long r = step.rounds[j];
    const long long tgt = step.pairwise ? (i ^ r) : (i + r) % P;
    uint8_t* dst = out + (tgt * bucket_rows + i * C + k) * row_bytes;
    if (k < step.caps[j]) {
      rowcopy::copy_row(dst, packed + (i * bucket_rows + tgt * C + k) * row_bytes,
                        row_bytes, lane);
    } else {
      rowcopy::zero_row(dst, row_bytes, lane);
    }
  }
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// packed [P, P*C, row_bytes] -> out [P, P*C, row_bytes], for the `n` rounds
// listed in `rounds` (host array) with capacities `caps` (host array).
extern "C" int repro_a2a_lock_step(const void* packed, void* out, long long P,
                                   long long C, long long row_bytes,
                                   const int* rounds, const int* caps, int n,
                                   int pairwise, void* stream) {
  if (n < 0 || n > kMaxStepRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LockStep step;
  step.n = n;
  step.pairwise = pairwise;
  for (int j = 0; j < n; ++j) {
    step.rounds[j] = rounds[j];
    step.caps[j] = caps[j];
  }
  const long long total = static_cast<long long>(n) * P * C;
  if (total > 0 && row_bytes > 0) {
    lock_step_kernel<<<rowcopy::blocks_for(total), rowcopy::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), P, C,
        row_bytes, step);
  }
  return static_cast<int>(cudaGetLastError());
}
