// K6: fused unpack-gather-matmul, the MoE expert FFN's gate and up products.
//
// Replaces the Pallas TPU kernel `gather_matmul` (`_gather_matmul_kernel`)
// in src/repro/kernels/gather_matmul.py (its `pallas_call` at line 94),
// reached through `ops.fused_unpack_matmul` from the MoE layer's receive
// side.
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
// bytes, almost all of them w: about 108 flop per byte, below the card's
// ~295.  The serve path's row tables are all valid (the receiver does not
// know which capacity slots are filled, as in the JAX package), so in decode
// too every expert's whole [D, F] weight is read: 0.088 ms at N=64.
//
// Three kernels; the wrapper (kernels/gather_matmul.py, `kernel_for`) picks
// one by a rule on dtype, shape and alignment:
//
//   bfloat16, D and F positive multiples of 8, x and w 16-byte aligned
//       -> gather_matmul_wgmma (the serve path's shapes);
//   any other bfloat16 call -> gather_matmul_tc (mma.sync, scalar loads);
//   float32 -> gather_matmul_f32 (CUDA-core FMAs: exact float32, no TF32).
//
// gather_matmul_wgmma streams each expert's weight once.  One CTA per
// (row chunk, expert, 128-column F tile), F tiles of one expert adjacent in
// the grid so that they run together and share the expert's gathered rows
// in L2; a chunk holds up to 128 rows (two m64 tiles) or, past N=128, 256
// rows, so at N <= 256 each w tile is read from HBM exactly once.  The
// causes that held back the mma.sync design, and what this one does:
//
//   - no pipelining: a ring of 3 (<=128 rows) or 4 stages in dynamic shared
//     memory.  One producer warp waits on a stage's empty mbarrier and
//     issues two TMA loads of w into it (3-D tensor map over w [E, D, F],
//     box 64 F x 64 D, 128-byte swizzle, zero fill past D and F) that
//     complete on the stage's full mbarrier.  Each consumer warpgroup
//     gathers its own rows for the same 64-deep K slice with 16-byte
//     cp.async, a ring ahead, swizzled as TMA would: every thread keeps its
//     4 (or 8) row offsets in registers, waits for its own copies with
//     `cp.async.wait_group`, fences them into the async proxy, and the
//     warpgroup meets at a named barrier.  Invalid rows, rows past N and
//     columns past D are copied as zeros (the zero-fill form): nothing
//     multiplies by a mask.  The gather is spread over the 256 consumer
//     threads because a single warp's cp.async stream cannot keep up with
//     the weight stream;
//   - w fetched once per 64-row tile: the CTA covers all the chunk's rows,
//     so the w tile is streamed once and each gathered row is read from L2
//     once per F tile (8 times at F=1024, against 16 before);
//   - mma.sync with scalar B loads: the two consumer warpgroups issue
//     `wgmma.mma_async.m64n128k16` straight from the swizzled stages (x as
//     the K-major A operand, w as the MN-major B operand), each warpgroup
//     one (or two, past 128 rows) m64 tiles of rows, float32 accumulators
//     in registers, and release the stage after `wgmma.wait_group 0`.
//
// The epilogue rounds once to bf16 and stores +0.0 by selection for invalid
// rows.  A CTA whose rows are all invalid stores zeros and reads no weight.
// With at most 128 rows a CTA uses ~100 KB of shared memory, so two share
// an SM and one's prologue and epilogue hide behind the other's stream.
// mbarrier waits give up with a trap after some seconds instead of hanging
// the card.  The tensor map is encoded on every call by
// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (cuda.h for its types only: no -lcuda); all offsets are 64-bit.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rowcopy.cuh"

namespace {

constexpr int BM = 64;  // rows of N per block (mma.sync and float32)
constexpr int BN = 64;  // columns of F per block (mma.sync and float32)

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

// ---------------------------------------------------------------------------
// bfloat16, shapes the wgmma kernel does not take: mma.sync, scalar loads
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
    // Gathered A tile: BM rows x TC_BK columns.
    for (int c = tid; c < BM * TC_BK; c += TC_THREADS) {
      const int r = c / TC_BK, kc = c % TC_BK;
      const long long s = src_row[r], k = k0 + kc;
      As[r][kc] = (s >= 0 && k < D) ? x[s * D + k] : uint16_t(0);
    }
    // w tile: TC_BK rows of D x BN columns of F.
    for (int c = tid; c < TC_BK * BN; c += TC_THREADS) {
      const int kr = c / BN, nc = c % BN;
      const long long k = k0 + kr, f = f0 + nc;
      Bs[kr][nc] = (k < D && f < F) ? w_e[k * F + f] : uint16_t(0);
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

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA weight ring, cp.async row gather, wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BK = 64;        // D per stage: one 128-byte swizzle row of bf16
constexpr int BOX_F = 64;     // F columns per TMA box (128 bytes)
constexpr int TILE_F = 128;   // F columns per CTA: two boxes, one wgmma N
constexpr int M_TILE = 64;    // rows per wgmma
constexpr int CONSUMER_WARPS = 8;                    // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;    // + one producer warp
constexpr int W_BYTES = BK * TILE_F * 2;             // 16384 per stage
constexpr int BOX_BYTES = BK * BOX_F * 2;            // 8192
constexpr int X_TILE_BYTES = M_TILE * BK * 2;        // 8192 per m64 tile
constexpr int FULL_ARRIVALS = 1;       // the producer's expect_tx
constexpr int EMPTY_ARRIVALS = CONSUMER_WARPS;
constexpr long long SPIN_CYCLES = 1LL << 34;  // ~10 s: a lost arrival traps

// SLOTS m64 tiles per consumer warpgroup: 1 up to 128 rows per CTA, 2 up to
// 256.  The Python wrapper mirrors these numbers (`wgmma_geometry`).
template <int SLOTS>
struct Geometry {
  static constexpr int ROWS = 2 * SLOTS * M_TILE;
  static constexpr int STAGES = SLOTS == 1 ? 3 : 4;
  static constexpr int STAGE_BYTES = W_BYTES + 2 * SLOTS * X_TILE_BYTES;
  // + 1024 so that the ring can start on a 1024-byte boundary (the swizzle
  // atom of TMA's and wgmma's 128-byte swizzle)
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
  static constexpr int MIN_BLOCKS = SLOTS == 1 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      t0 = clock64();
    else if (clock64() - t0 > SPIN_CYCLES)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 16 bytes from global to shared; src_bytes 0 writes 16 zero bytes and
// reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d[64x128] += A[64x16] (K-major) * B[16x128] (MN-major), bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS, Geometry<SLOTS>::MIN_BLOCKS)
gather_matmul_wgmma(const __grid_constant__ CUtensorMap w_map,
                    const uint16_t* __restrict__ x,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ valid,
                    uint16_t* __restrict__ out, long long E, long long N,
                    long long D, long long F) {
  using G = Geometry<SLOTS>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full_bar[G::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[G::STAGES];
  __shared__ long long src_off[G::ROWS];  // x offset of each row, -1: zero

  // Block -> (row chunk, expert, F tile), F tile fastest.
  const long long n_f = (F + TILE_F - 1) / TILE_F;
  const long long b = blockIdx.x;
  const long long f0 = (b % n_f) * TILE_F;
  const long long e = (b / n_f) % E;
  const long long r0 = (b / n_f / E) * G::ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(G::ROWS), N - r0));
  const int mt = (rows + M_TILE - 1) / M_TILE;
  uint16_t* __restrict__ out_c = out + (e * N + r0) * F;

  int any = 0;
  for (int r = threadIdx.x; r < G::ROWS; r += THREADS) {
    long long s = -1;
    if (r < rows && valid[e * N + r0 + r]) s = idx[e * N + r0 + r] * D;
    src_off[r] = s;
    any |= s >= 0;
  }
  if (!__syncthreads_or(any)) {
    // F is a multiple of 8, so column pairs never straddle F.
    for (int c = threadIdx.x; c < rows * (TILE_F / 2); c += THREADS) {
      const long long r = c / (TILE_F / 2), f = f0 + 2 * (c % (TILE_F / 2));
      if (f < F) *reinterpret_cast<uint32_t*>(out_c + r * F + f) = 0u;
    }
    return;
  }

  const uint32_t ring = (smem_u32(dyn_smem) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), FULL_ARRIVALS);
      mbar_init(smem_u32(&empty_bar[s]), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = static_cast<int>((D + BK - 1) / BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == CONSUMER_WARPS) {
    // ---- producer warp: the w tiles by TMA ----
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1u);
        const uint32_t ws = ring + stage * G::STAGE_BYTES;
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_expect_tx(full, W_BYTES);
        tma_load_3d(ws, &w_map, full, static_cast<int>(f0), kt * BK,
                    static_cast<int>(e));
        tma_load_3d(ws + BOX_BYTES, &w_map, full, static_cast<int>(f0 + BOX_F),
                    kt * BK, static_cast<int>(e));
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: each gathers its own rows, then wgmma ----
    const int group = warp / 4, t = threadIdx.x % 128, ch = t % 8;
    // This thread's 16-byte chunk `ch` of rows t/8 + 16i of each of its m64
    // tiles: x offsets (-1: write zeros) and swizzled places in a stage (the
    // chunk goes to chunk ch ^ (row % 8) of its 128-byte row, as TMA's
    // 128-byte swizzle would put it).
    long long off[SLOTS][4];
    uint32_t dst[SLOTS][4];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = group + 2 * s, r = m * M_TILE + t / 8 + 16 * i;
        off[s][i] = m < mt ? src_off[r] : -1;
        dst[s][i] = W_BYTES + r * 128 + ((ch ^ (r & 7)) << 4);
      }
    // The copies of stage kt form cp.async group kt of this thread; a stage
    // past the end commits an empty group, so that the count stays exact.
    auto gather = [&](int kt) {
      if (kt < nk) {
        const uint32_t base = ring + (kt % G::STAGES) * G::STAGE_BYTES;
        const long long k = static_cast<long long>(kt) * BK + ch * 8;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (group + 2 * s >= mt) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = off[s][i] >= 0 && k < D;
            cp_async_16(base + dst[s][i], ok ? x + off[s][i] + k : x,
                        ok ? 16 : 0);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float acc[SLOTS][64];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[s][i] = 0.f;

    for (int kt = 0; kt < G::STAGES - 1; ++kt) gather(kt);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      // Into the stage this warpgroup finished reading last iteration: its
      // own rows only, so no other warpgroup's reads are in the way.
      gather(kt + G::STAGES - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(G::STAGES - 1) : "memory");
      // The rows came by cp.async (the generic proxy); wgmma reads through
      // the async proxy.  Then all 128 threads' copies of stage kt are in.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
      mbar_wait(smem_u32(&full_bar[stage]), phase);
      const uint32_t ws = ring + stage * G::STAGE_BYTES, xs = ws + W_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int m = group + 2 * s;
        if (m < mt) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart, k16
            // steps 32 bytes along the row.  B: k16 steps 16 rows of 128
            // bytes; LBO 8 KB to the second 64-column box, SBO 1024 bytes
            // between 8-row groups of K.
            const uint64_t da =
                smem_desc(xs + m * X_TILE_BYTES + kk * 32, 16, 1024);
            const uint64_t db = smem_desc(ws + kk * 16 * 128, BOX_BYTES, 1024);
            wgmma_m64n128k16(acc[s], da, db);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
      if (++stage == G::STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }

    // Epilogue: the accumulator of warp q of a warpgroup holds rows
    // 16q + lane/4 (+8) and, per 8-column step j, columns 8j + 2(lane%4)
    // and the next.
    const int q = warp % 4;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int m = group + 2 * s;
      if (m >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m * M_TILE + q * 16 + (lane >> 2) + 8 * h;
        if (r >= rows) continue;
        const bool ok = src_off[r] >= 0;
        uint16_t* __restrict__ orow = out_c + static_cast<long long>(r) * F;
#pragma unroll
        for (int j = 0; j < TILE_F / 8; ++j) {
          const long long f = f0 + j * 8 + (lane & 3) * 2;
          if (f >= F) continue;
          uint32_t v = 0u;
          if (ok) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(
                acc[s][j * 4 + 2 * h], acc[s][j * 4 + 2 * h + 1]);
            v = *reinterpret_cast<const uint32_t*>(&p);
          }
          *reinterpret_cast<uint32_t*>(orow + f) = v;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int SLOTS>
cudaError_t launch_wgmma(const CUtensorMap& map, const uint16_t* x,
                         const int32_t* idx, const uint8_t* valid,
                         uint16_t* out, long long E, long long N, long long D,
                         long long F, long long grid, cudaStream_t s) {
  using G = Geometry<SLOTS>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t rc = cudaFuncSetAttribute(
        gather_matmul_wgmma<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    // All of the SM's unified memory as shared memory, so that two blocks
    // of at most 128 rows fit beside each other.
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(gather_matmul_wgmma<SLOTS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  gather_matmul_wgmma<SLOTS><<<static_cast<unsigned>(grid), THREADS, G::SMEM, s>>>(
      map, x, idx, valid, out, E, N, D, F);
  return cudaGetLastError();
}

}  // namespace wg

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
  if (dtype == 0)
    gather_matmul_f32<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(x), i32, vb, static_cast<const float*>(w),
        static_cast<float*>(out), N, D, F);
  else
    gather_matmul_tc<<<grid, TC_THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), i32, vb,
        static_cast<const uint16_t*>(w), static_cast<uint16_t*>(out), N, D, F);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 only; D and F positive multiples of 8, x and w 16-byte aligned.
// `slots`, `smem_bytes` and `grid` are the wrapper's geometry
// (`wgmma_geometry`); a launch whose geometry disagrees with this file's is
// refused with cudaErrorInvalidValue.
extern "C" int repro_gather_matmul_wgmma(const void* x, const void* idx,
                                         const void* valid, const void* w,
                                         void* out, long long E, long long N,
                                         long long D, long long F, int slots,
                                         int smem_bytes, long long grid,
                                         void* stream) {
  if (E == 0 || N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const long long rows = slots == 1 ? wg::Geometry<1>::ROWS : wg::Geometry<2>::ROWS;
  const int smem = slots == 1 ? wg::Geometry<1>::SMEM : wg::Geometry<2>::SMEM;
  const long long want_grid =
      (N + rows - 1) / rows * E * ((F + wg::TILE_F - 1) / wg::TILE_F);
  if ((slots != 1 && slots != 2) || smem_bytes != smem || grid != want_grid ||
      (slots == 1) != (N <= wg::Geometry<1>::ROWS) || D <= 0 || D % 8 != 0 ||
      F % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || grid > 0x7fffffffLL ||
      E > 0x7fffffffLL || D > 0x7fffffffLL || F > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);

  // w as a 3-D tensor [E, D, F], F innermost; zero fill past D and F.
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(F) * 2,
                                 static_cast<cuuint64_t>(D * F) * 2};
  const cuuint32_t box[3] = {wg::BOX_F, wg::BK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorNotSupported);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xh = static_cast<const uint16_t*>(x);
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* vb = static_cast<const uint8_t*>(valid);
  auto* oh = static_cast<uint16_t*>(out);
  const cudaError_t rc =
      slots == 1 ? wg::launch_wgmma<1>(map, xh, i32, vb, oh, E, N, D, F, grid, s)
                 : wg::launch_wgmma<2>(map, xh, i32, vb, oh, E, N, D, F, grid, s);
  return static_cast<int>(rc);
}
