// K6: fused unpack-gather-matmul, the MoE expert FFN's gate and up products.
//
// Replaces the Pallas TPU kernel `gather_matmul` (`_gather_matmul_kernel`)
// in src/repro/kernels/gather_matmul.py, reached through
// `ops.fused_unpack_matmul` from the MoE layer's receive side.
//
//   out[e, n, :] = valid[e, n] ? x[idx[e, n], :] @ w[e] : +0.0
//
// x [R, D], idx/valid [E, N] (int32/bool), w [E, D, F], out [E, N, F], all in
// one dtype (float32 or bfloat16), sums in float32, rounded once.
//
// Bound.  At OLMoE-1B-7B's prefill shape (E=64 experts, N=128 rows each,
// D=2048, F=1024, bf16) the kernel must read the 268 MB of w, the 33 MB of
// x and write the 17 MB of out: about 318 MB, 0.095 ms at 3.35 TB/s, against
// 34 GFLOP, 0.035 ms at 989 TFLOP/s.  So at serve shapes K6 is bound by
// bytes.  The serve path's row tables are all valid (the receiver does not
// know which capacity slots are filled, as in the JAX package), so in
// decode too every expert's whole [D, F] weight is read: 0.088 ms at N=64.
// A block whose rows are all invalid writes zeros and reads no weight, but
// only a caller that passes a real mask gains from that.
//
// Design.  The TPU kernel DMAs its TILE_R source rows one at a time into a
// VMEM tile and makes one MXU dot per (expert, row tile), with the whole
// [D, F] weight block resident.  Here it is a tiled GEMM whose A rows are
// gathered: one block per (expert, 64-row tile of N, 64-column tile of F).
// The block loads its own indices and masks, then loops over D in K-tiles:
// it gathers the A rows x[idx] into shared memory (16-byte loads where D and
// F are multiples of 8 elements), writing +0.0 by selection for invalid rows
// and for the ragged edges (the TPU kernel multiplies by the mask, which
// turns a NaN or inf in an unused source row into NaN), loads the matching
// w tile, and accumulates in registers.  bfloat16 uses the tensor cores
// through `mma.sync.m16n8k16` (four warps, 32x32 outputs each); float32 uses
// CUDA-core FMAs (256 threads, 4x4 outputs each), so it stays exact float32.
// Invalid output rows are stored as +0.0 by selection too.
//
// What this simple design leaves on the table: the K-loop is not pipelined
// (no cp.async or TMA ring, one barrier per tile), w is read once per 64-row
// tile of N rather than once, the gathered rows are re-read once per F tile
// (from L2), and mma.sync reaches a fraction of what wgmma does.  All
// offsets are 64-bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rowcopy.cuh"

namespace {

constexpr int BM = 64;  // rows of N per block
constexpr int BN = 64;  // columns of F per block

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_BK = 32;
constexpr int TC_THREADS = 128;
constexpr int A_LD = TC_BK + 8;  // halves per shared A row (80 bytes)
constexpr int B_LD = BN + 8;     // halves per shared B row (144 bytes)

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Loads this block's source rows (-1: invalid or past N); returns whether
// any row of the tile is valid.
__device__ __forceinline__ int load_rows(long long* src_row,
                                         const int32_t* __restrict__ idx,
                                         const uint8_t* __restrict__ valid,
                                         long long e, long long n0,
                                         long long N) {
  int any = 0;
  if (threadIdx.x < BM) {
    const long long r = n0 + threadIdx.x;
    long long s = -1;
    if (r < N && valid[e * N + r]) s = idx[e * N + r];
    src_row[threadIdx.x] = s;
    any = s >= 0;
  }
  return __syncthreads_or(any);
}

template <typename T>
__device__ void store_zero_tile(T* __restrict__ out_e, long long n0,
                                long long f0, long long N, long long F) {
  for (int c = threadIdx.x; c < BM * BN; c += blockDim.x) {
    const long long r = n0 + c / BN, f = f0 + c % BN;
    if (r < N && f < F) out_e[r * F + f] = T(0);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
gather_matmul_tc(const uint16_t* __restrict__ x,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ valid,
                 const uint16_t* __restrict__ w, uint16_t* __restrict__ out,
                 long long N, long long D, long long F) {
  __shared__ __align__(16) uint16_t As[BM][A_LD];
  __shared__ __align__(16) uint16_t Bs[TC_BK][B_LD];
  __shared__ long long src_row[BM];

  const long long e = blockIdx.z;
  const long long n0 = static_cast<long long>(blockIdx.y) * BM;
  const long long f0 = static_cast<long long>(blockIdx.x) * BN;
  uint16_t* __restrict__ out_e = out + e * N * F;
  if (!load_rows(src_row, idx, valid, e, n0, N)) {
    store_zero_tile(out_e, n0, f0, N, F);
    return;
  }
  const uint16_t* __restrict__ w_e = w + e * D * F;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (long long k0 = 0; k0 < D; k0 += TC_BK) {
    // Gathered A tile: BM rows x TC_BK columns, 8 halves per chunk.
    for (int c = tid; c < BM * (TC_BK / 8); c += TC_THREADS) {
      const int r = c / (TC_BK / 8), kc = (c % (TC_BK / 8)) * 8;
      const long long s = src_row[r];
      uint16_t* dst = &As[r][kc];
      if (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (s >= 0 && k0 + kc < D)
          v = *reinterpret_cast<const uint4*>(x + s * D + k0 + kc);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long k = k0 + kc + j;
          dst[j] = (s >= 0 && k < D) ? x[s * D + k] : uint16_t(0);
        }
      }
    }
    // w tile: TC_BK rows of D x BN columns of F.
    for (int c = tid; c < TC_BK * (BN / 8); c += TC_THREADS) {
      const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const long long k = k0 + kr, f = f0 + nc;
      uint16_t* dst = &Bs[kr][nc];
      if (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < D && f < F)
          v = *reinterpret_cast<const uint4*>(w_e + k * F + f);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (k < D && f + j < F) ? w_e[k * F + f + j] : uint16_t(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2 + 8]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        const int k = kk + t4 * 2;
        b[j][0] = uint32_t(Bs[k][n]) | (uint32_t(Bs[k + 1][n]) << 16);
        b[j][1] = uint32_t(Bs[k + 8][n]) | (uint32_t(Bs[k + 9][n]) << 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + g + h * 8;
      const long long row = n0 + r;
      if (row >= N) continue;
      const bool ok = src_row[r] >= 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long long f = f0 + wn + j * 8 + t4 * 2 + q;
          if (f < F)
            out_e[row * F + f] = ok ? __bfloat16_as_ushort(__float2bfloat16_rn(
                                             acc[i][j][h * 2 + q]))
                                    : uint16_t(0);
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int F32_BK = 16;
constexpr int F32_THREADS = 256;

__global__ void __launch_bounds__(F32_THREADS)
gather_matmul_f32(const float* __restrict__ x, const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ w, float* __restrict__ out,
                  long long N, long long D, long long F) {
  __shared__ float As[F32_BK][BM + 4];  // transposed: As[k][row]
  __shared__ float Bs[F32_BK][BN + 4];
  __shared__ long long src_row[BM];

  const long long e = blockIdx.z;
  const long long n0 = static_cast<long long>(blockIdx.y) * BM;
  const long long f0 = static_cast<long long>(blockIdx.x) * BN;
  float* __restrict__ out_e = out + e * N * F;
  if (!load_rows(src_row, idx, valid, e, n0, N)) {
    store_zero_tile(out_e, n0, f0, N, F);
    return;
  }
  const float* __restrict__ w_e = w + e * D * F;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < D; k0 += F32_BK) {
    for (int c = tid; c < BM * F32_BK; c += F32_THREADS) {
      const int r = c / F32_BK, kk = c % F32_BK;
      const long long s = src_row[r], k = k0 + kk;
      As[kk][r] = (s >= 0 && k < D) ? x[s * D + k] : 0.f;
    }
    for (int c = tid; c < F32_BK * BN; c += F32_THREADS) {
      const int kr = c / BN, nc = c % BN;
      const long long k = k0 + kr, f = f0 + nc;
      Bs[kr][nc] = (k < D && f < F) ? w_e[k * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F32_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const long long row = n0 + r;
    if (row >= N) continue;
    const bool ok = src_row[r] >= 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long f = f0 + tx * 4 + j;
      if (f < F) out_e[row * F + f] = ok ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// dtype: 0 float32, 1 bfloat16.  x [R, D], idx/valid [E, N],
// w [E, D, F] -> out [E, N, F].
extern "C" int repro_gather_matmul(const void* x, const void* idx,
                                   const void* valid, const void* w, void* out,
                                   long long E, long long N, long long D,
                                   long long F, int dtype, void* stream) {
  if (E == 0 || N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  if (E > 65535 || (N + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((F + BN - 1) / BN),
                  static_cast<unsigned>((N + BM - 1) / BM),
                  static_cast<unsigned>(E));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* vb = static_cast<const uint8_t*>(valid);
  if (dtype == 0) {
    gather_matmul_f32<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(x), i32, vb, static_cast<const float*>(w),
        static_cast<float*>(out), N, D, F);
  } else {
    const auto* xh = static_cast<const uint16_t*>(x);
    const auto* wh = static_cast<const uint16_t*>(w);
    auto* oh = static_cast<uint16_t*>(out);
    const bool vec = D % 8 == 0 && F % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (vec)
      gather_matmul_tc<true><<<grid, TC_THREADS, 0, s>>>(xh, i32, vb, wh, oh,
                                                         N, D, F);
    else
      gather_matmul_tc<false><<<grid, TC_THREADS, 0, s>>>(xh, i32, vb, wh, oh,
                                                          N, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}
