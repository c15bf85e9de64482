// Row movers shared by the port's byte-moving kernels (gather_rows.cu,
// a2a_fence.cu, a2a_lock.cu, a2a_hier.cu).
//
// Two movers.  `copy_row` / `zero_row`: one warp per row, for any width and
// base.  `copy_chunk`: one block per contiguous chunk of 16-byte vectors
// (K1's run kernel and K2's bucket kernel), each of the block's 256 threads
// issuing 4 independent 16-byte loads before its 4 stores, so 16 KiB are in
// flight per block.
//
// Every kernel of the persistent alltoallv path only moves rows: it never
// looks at the values, so a row is `row_bytes` raw bytes whatever its dtype.
// One warp moves one row.  Its 32 lanes copy the row with 16-byte vector
// accesses when both row addresses are 16-byte aligned (row widths that are
// multiples of 16 bytes on a 16-byte aligned base), with 4-byte words when
// they are 4-byte aligned (for example 60-byte rows of (3, 5) float32), and
// byte by byte for the rest.  Padding rows are written as zero bytes, so a
// float row reads +0.0 whatever the source holds (no multiply by a mask,
// which could give -0.0 or NaN).
//
// All offsets are 64-bit: at 64 virtual ranks the padded buffers approach
// 2 GiB.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rowcopy {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
// Grid-stride loops cover any row count; the cap only bounds the grid.
constexpr long long kMaxBlocks = 1LL << 22;

__device__ __forceinline__ void copy_row(uint8_t* __restrict__ dst,
                                         const uint8_t* __restrict__ src,
                                         long long nbytes, int lane) {
  long long done = 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) |
                          reinterpret_cast<uintptr_t>(src);
  if ((align & 15) == 0) {
    const long long nvec = nbytes >> 4;
    const uint4* __restrict__ s = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d = reinterpret_cast<uint4*>(dst);
    for (long long v = lane; v < nvec; v += 32) d[v] = s[v];
    done = nvec << 4;
  } else if ((align & 3) == 0) {
    const long long nw = nbytes >> 2;
    const uint32_t* __restrict__ s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* __restrict__ d = reinterpret_cast<uint32_t*>(dst);
    for (long long v = lane; v < nw; v += 32) d[v] = s[v];
    done = nw << 2;
  }
  for (long long b = done + lane; b < nbytes; b += 32) dst[b] = src[b];
}

__device__ __forceinline__ void zero_row(uint8_t* __restrict__ dst,
                                         long long nbytes, int lane) {
  long long done = 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst);
  if ((align & 15) == 0) {
    const long long nvec = nbytes >> 4;
    uint4* __restrict__ d = reinterpret_cast<uint4*>(dst);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long v = lane; v < nvec; v += 32) d[v] = z;
    done = nvec << 4;
  } else if ((align & 3) == 0) {
    const long long nw = nbytes >> 2;
    uint32_t* __restrict__ d = reinterpret_cast<uint32_t*>(dst);
    for (long long v = lane; v < nw; v += 32) d[v] = 0u;
    done = nw << 2;
  }
  for (long long b = done + lane; b < nbytes; b += 32) dst[b] = 0;
}

constexpr int kChunkThreads = 256;   // block size of copy_chunk's callers
constexpr int kLoadsAhead = 4;       // loads per thread before its stores

// The calling block (kChunkThreads threads) copies `nvec` 16-byte vectors
// from src to dst; both 16-byte aligned.
__device__ __forceinline__ void copy_chunk(uint4* __restrict__ dst,
                                           const uint4* __restrict__ src,
                                           long long nvec) {
  for (long long v0 = threadIdx.x; v0 < nvec;
       v0 += kChunkThreads * kLoadsAhead) {
    uint4 r[kLoadsAhead];
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u) {
      const long long v = v0 + u * kChunkThreads;
      if (v < nvec) r[u] = src[v];
    }
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u) {
      const long long v = v0 + u * kChunkThreads;
      if (v < nvec) dst[v] = r[u];
    }
  }
}

// First row handled by the calling warp, and the warp stride of the grid.
__device__ __forceinline__ long long first_warp_row() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long warp_row_stride() {
  return (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
}

inline unsigned int blocks_for(long long rows) {
  long long b = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace rowcopy

// Every library built from these sources exports the CUDA error text, so
// the Python wrapper can name the error a launch returned.
#define ROWCOPY_EXPORT_ERROR_STRING                                  \
  extern "C" const char* repro_cuda_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }
