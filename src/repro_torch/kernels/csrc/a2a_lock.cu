// K4: the lock-synchronised (passive-target) alltoallv epoch over P virtual
// ranks on one device.
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
// Bound: bytes.  An epoch reads the rows below cap_r of every bucket once and
// writes every row of every bucket once; on an H100 SXM the least time is
// those bytes over 3.35 TB/s of HBM bandwidth.
//
// Two kernels; the wrapper (kernels/a2a_lock.py, `kernel_for`) picks one by
// a rule on the row width and the base address:
//
// lock_cluster_kernel (row widths that are multiples of 16 bytes on 16-byte
// aligned bases): the whole epoch in ONE launch, as the TPU kernel is one
// call.  The grid is P thread-block clusters; cluster i is origin rank i and
// walks the epoch's phases in the schedule's order.  Phase 0 carries round
// 0 (the local bucket), the zero buckets of every elided round and the first
// active round, so that the local copy overlaps the first put as
// `local.start()` ... `local.wait()` does on the TPU; every later active
// round is a phase of its own.  Within a phase the cluster's CTAs split each
// bucket's cap_r * row_bytes contiguous bytes (and the zero rows cap_r..C)
// evenly, in 16-byte units.  One thread per CTA moves its share with the 1-D
// TMA bulk copy (bulkcopy.cuh): loads into an 8-stage ring of 16 KiB in
// shared memory that complete on mbarriers, stores out of it in bulk groups
// (a stage is refilled once all but the 4 newest stores have read their
// source), and zero rows stored from a zeroed 8 KiB region.  Loads read only
// the origin's own send buffer, so the next phase's pieces are loaded while
// the phase drains; every store (a put) waits for its phase.  Before the
// phase ends, `cp.async.bulk.wait_group 0` waits until every store of the
// CTA has completed; then the cluster meets at
// `barrier.cluster.arrive.release` / `barrier.cluster.wait.acquire`.  That
// barrier is Algorithm 3's unlock: one put in flight per origin, each
// complete before the next starts.  The P origins run concurrently, as the
// TPU's ranks do.  No cluster waits on anything another cluster sets
// (clusters need not be resident together), so the TPU's `rdma.wait()`
// keeps its send side only: the wait for the incoming block (its recv
// semaphore) would be a spin across clusters.  The rounds and capacities
// come from a small int32 table in device memory that the wrapper builds
// once per schedule.  The cluster size is the wrapper's
// (`lock_cluster_size`): the largest of 16, 8, 4, 2 for which the card can
// hold all P clusters at once by `cudaOccupancyMaxActiveClusters`
// (`repro_a2a_lock_cluster_occupancy`), else 1.  Each CTA's 136 KiB of
// shared memory keeps one CTA per SM: 8 CTAs per cluster at P=8, 2 at P=64
// on an H100.  Every mbarrier wait traps after ~10 s; a cluster barrier
// waits only on CTAs of its own cluster, which reach it unless one of their
// mbarrier waits traps, and a trap ends the grid.
//
// lock_step_kernel (other row widths or bases): one launch per active round,
// the launches in order on one stream (stream order is the per-target lock).
// The first launch of an epoch also carries the local bucket and writes the
// zero buckets of every elided round.  A launch's rounds are passed by value
// in the kernel's parameters, at most kMaxStepRounds of them: the wrapper
// (`step_launches`) cuts a longer phase, which P > 256 with elided rounds
// gives, into consecutive launches.  One warp moves one destination row
// (rowcopy.cuh).
#include "bulkcopy.cuh"
#include "rma_flags.cuh"
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


// ---------------------------------------------------------------------------
// lock_cluster_kernel: one launch per epoch, one cluster per origin rank
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 128;  // thread 0 moves the bytes
constexpr int kStages = 8;             // ring stages
constexpr uint32_t kStageBytes = 16384;
constexpr uint32_t kZeroBytes = 8192;
constexpr int kClusterSmem = kStages * kStageBytes + kZeroBytes + kStages * 8 + 128;

// The epoch's schedule, read from the table [rounds(n) | caps(n) |
// phase_start(phases + 1)], and this CTA's place in it.
struct Epoch {
  const uint8_t* packed;
  uint8_t* out;
  long long P, C, row_bytes;
  const int* table;
  int n;
  int pairwise;
  long long rank, part, parts;  // origin rank, CTA in its cluster, cluster size

  __device__ long long target(int e) const {
    const long long r = table[e];
    return pairwise ? (rank ^ r) : (rank + r) % P;
  }
  __device__ long long cap(int e) const { return table[n + e]; }
  // Rank `rank`'s bucket for the entry's target in its send buffer.
  __device__ const uint8_t* src_bucket(int e) const {
    return packed + (rank * P * C + target(e) * C) * row_bytes;
  }
  // Byte offset of rank `rank`'s bucket in the destination rank's window.
  __device__ uint8_t* dst_bucket(int e) const {
    return out + (target(e) * P * C + rank * C) * row_bytes;
  }
};

// Walks this CTA's share of the copy bytes of entries [e, end) in pieces of
// at most one stage (E: Epoch, or PeerEpoch for the peer kernel).
template <typename E>
struct StreamT {
  const E* ep;
  int e, end;
  long long off, len;
  const uint8_t* src;
  uint8_t* dst;

  __device__ void seek() {
    for (; e < end; ++e, off = 0) {
      long long lo, hi;
      bulk::split(ep->cap(e) * ep->row_bytes / 16, ep->parts, ep->part, &lo,
                  &hi);
      len = (hi - lo) * 16;
      if (off < len) {
        src = ep->src_bucket(e) + lo * 16;
        dst = ep->dst_bucket(e) + lo * 16;
        return;
      }
    }
  }
  __device__ bool more() const { return e < end; }
  // The next piece: its source, destination and bytes.
  __device__ uint32_t next(const uint8_t** s, uint8_t** d) {
    const long long left = len - off;
    const uint32_t bytes =
        static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes);
    *s = src + off;
    *d = dst + off;
    off += bytes;
    if (off >= len) {
      ++e;
      off = 0;
      seek();
    }
    return bytes;
  }
};

// The leader thread's side of a CTA's shared ring of S stages
// (lock_cluster_kernel: kStages; lock_peer_kernel: kPeerStages): one load
// stream over every entry of the epoch, in phase order, and one store
// stream per phase.  Pieces use the ring's stages in turn: piece g takes
// stage g % S, and its use number g / S gives the mbarrier parity.  Loads
// read only the origin's own send buffer, so the next phase's first pieces
// are loaded before the barrier that opens it; every store (a put) waits
// for that barrier.  A stage is refilled once all but the S / 2 newest
// stores have read their source.
template <typename E, int S = kStages>
struct Ring {
  static constexpr int kLag = S / 2;  // stores in flight before a refill
  uint8_t* ring;
  uint64_t* bars;
  StreamT<E> ld;
  long long n_ld, n_st;

  __device__ __forceinline__ void load() {
    const uint8_t* s;
    uint8_t* d;
    const uint32_t bytes = ld.next(&s, &d);
    const int stage = static_cast<int>(n_ld % S);
    bulk::mbar_arrive_expect_tx(&bars[stage], bytes);
    bulk::load(ring + stage * kStageBytes, s, bytes, &bars[stage]);
    ++n_ld;
  }
  // The first pieces, one per stage, before the first phase.
  __device__ __forceinline__ void prime() {
    ld.seek();
    while (ld.more() && n_ld < S) load();
  }
  // Stores the pieces of entries [e0, e1) as their loads land, refilling
  // each stage once all but the kLag newest stores have read their source,
  // and returns once every store of the CTA (these and any it
  // issued before) has completed, not just read.
  __device__ __forceinline__ void store_phase(int e0, int e1) {
    StreamT<E> st{ld.ep, e0, e1, 0, 0, nullptr, nullptr};
    st.seek();
    while (st.more()) {
      const uint8_t* s;
      uint8_t* d;
      const uint32_t bytes = st.next(&s, &d);
      const int stage = static_cast<int>(n_st % S);
      bulk::mbar_wait(&bars[stage], static_cast<uint32_t>((n_st / S) & 1));
      bulk::store(d, ring + stage * kStageBytes, bytes);
      bulk::commit();
      ++n_st;
      // Refill the stage of the piece stored one step ago: all but the
      // newest group have read their source.
      if (ld.more() && n_ld - S <= n_st - 1 - kLag) {
        bulk::wait_read<kLag>();
        load();
      }
    }
    bulk::wait_all();
  }
  // Every stage not holding a loaded piece is free now: load ahead.
  __device__ __forceinline__ void load_ahead() {
    while (ld.more() && n_ld - n_st < S) load();
  }
};

__global__ void __launch_bounds__(kClusterThreads)
lock_cluster_kernel(const uint8_t* __restrict__ packed,
                    uint8_t* __restrict__ out, long long P, long long C,
                    long long row_bytes, const int* __restrict__ table,
                    int n_entries, int n_phases, int pairwise) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint8_t* ring = base;
  uint8_t* zeros = ring + kStages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(zeros + kZeroBytes);

  for (uint32_t q = threadIdx.x; q < kZeroBytes / 16; q += blockDim.x)
    reinterpret_cast<uint4*>(zeros)[q] = make_uint4(0u, 0u, 0u, 0u);
  bulk::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bulk::mbar_init(&bars[s], 1);
    bulk::fence_mbar_init();
  }
  __syncthreads();

  Epoch ep{packed, out, P, C, row_bytes, table, n_entries, pairwise,
           static_cast<long long>(bulk::cluster_id()),
           static_cast<long long>(bulk::cluster_ctarank()),
           static_cast<long long>(bulk::cluster_nctarank())};
  const int* phase_start = table + 2 * n_entries;
  const bool leader = threadIdx.x == 0;
  Ring<Epoch> rg{ring, bars, {&ep, 0, n_entries, 0, 0, nullptr, nullptr}, 0, 0};
  if (leader) rg.prime();
  for (int ph = 0; ph < n_phases; ++ph) {
    if (leader) {
      const int e0 = phase_start[ph], e1 = phase_start[ph + 1];
      // The zero rows of the phase's buckets.
      for (int e = e0; e < e1; ++e) {
        long long lo, hi;
        const long long cap = ep.cap(e);
        bulk::split((C - cap) * row_bytes / 16, ep.parts, ep.part, &lo, &hi);
        uint8_t* d = ep.dst_bucket(e) + cap * row_bytes + lo * 16;
        for (long long b = 0; b < (hi - lo) * 16; b += kZeroBytes) {
          const long long left = (hi - lo) * 16 - b;
          bulk::store(d + b, zeros,
                      static_cast<uint32_t>(left < kZeroBytes ? left : kZeroBytes));
        }
      }
      bulk::commit();
      rg.store_phase(e0, e1);  // every store of this phase complete
      rg.load_ahead();
    }
    bulk::cluster_sync();  // the unlock: the next put starts after this one
  }
}


// ---------------------------------------------------------------------------
// lock_peer_kernel: one process per rank, this process's origin only
// ---------------------------------------------------------------------------
//
// The peer form of Algorithm 3 (`_lock_kernel`, src/repro/kernels/
// a2a_lock.py:36-58): this process is origin `me`, and round r puts bucket
// tgt = (me + r) % P (ring) or me ^ r (pairwise) into rows [me*C, me*C +
// cap_r) of rank tgt's window through the pointer this process maps
// (rma_signal.cu).  The whole epoch is ONE launch, its OPEN included.
// Phase 0 carries round 0 (the local bucket) and the first active round;
// every later active round is a phase of its own.  Rounds the schedule
// elides (capacity 0) are not in the table: they move nothing and wait on
// nothing, and both sides know them from the same baked schedule.  Rows
// cap_r..C of a received bucket are not written (the unpack reads rows
// below each pair's count only), so a window keeps stale bytes there, as an
// RMA window does.
//
// The grid is the window's `lock_ctas` CTAs, no cluster: at most the card's
// resident CTAs of this kernel split over the ranks that share the card
// (the fewest over the ranks, agreed at registration), launched
// cooperatively, so the runtime makes every CTA of the grid resident at
// once, or refuses the launch, and a CTA may wait on the others.  Each CTA moves
// its share of every round: the bucket's cap_r * row_bytes contiguous bytes
// split evenly over the CTAs.  Rows of 16-byte multiples on aligned bases
// (V = uint4) go as lock_cluster_kernel's do: one thread issues TMA bulk
// loads into a ring of kPeerStages stages of 16 KiB (so that several CTAs
// fit on one SM) and bulk stores through the peer pointer, loading the next
// round's pieces while this one drains.  Other rows go by register copies
// of 4-byte words or bytes (V = uint32_t or uint8_t), all threads striding.
//
// The synchronisation, per CTA c:
//   - at the start CTA 0 signals `open[me]` on every peer: stream order put
//     this rank's last unpack before the launch;
//   - before the barrier that starts round r (for round 0, before the loop)
//     the CTA's waiter thread has acquired `open[tgt]` in this rank's pad;
//   - after its puts of round r (bulk: `wait_group 0` and
//     `fence.proxy.async`; registers: a fence at the flags' scope and a
//     CTA barrier) the leader signals the CTA's round slot (me, c) in tgt's
//     pad, a release store; meanwhile the waiter acquires slot (src, c) in
//     this rank's pad, src = (me - r) % P or me ^ r (CTA c of the source
//     put its share of round r into this window), then round r + 1's opens;
//   - then the grid meets at a barrier on a counter in this rank's SyncWords
//     (rma_flags.cuh), and round r + 1 starts.
// So no CTA puts round r+1 before every put of round r by this origin has
// landed and every put into this window by round r's source has landed:
// the send and recv sides of the TPU's `rdma.wait()`.  Every rank has the
// same CTA count, so the slots match.  The flags take system scope, or GPU
// scope where every rank shares this card (`sys`, rma_flags.cuh).  Every
// wait is bounded and writes the record `ProcessExchangePlan.wait` reads
// (rma_flags.cuh); a trap need not end the grid (on an H100 one rank's grid
// ran on after a timed-out wait had trapped), so the host reads the record
// rather than waiting for it.
constexpr int kPeerStages = 4;

struct PeerEpoch {
  const uint8_t* packed;
  const unsigned long long* peers;
  long long P, C, row_bytes;
  const int* table;
  int n;
  int pairwise;
  long long rank, part, parts;

  __device__ long long target(int e) const {
    const long long r = table[e];
    return pairwise ? (rank ^ r) : (rank + r) % P;
  }
  __device__ long long source(int e) const {
    const long long r = table[e];
    return pairwise ? (rank ^ r) : (rank - r + P) % P;
  }
  __device__ long long cap(int e) const { return table[n + e]; }
  __device__ const uint8_t* src_bucket(int e) const {
    return packed + target(e) * C * row_bytes;
  }
  __device__ uint8_t* dst_bucket(int e) const {
    return reinterpret_cast<uint8_t*>(peers[target(e)]) + rank * C * row_bytes;
  }
};

template <typename V>
__global__ void __launch_bounds__(kClusterThreads)
lock_peer_kernel(const uint8_t* __restrict__ packed,
                 const unsigned long long* __restrict__ peers,
                 const unsigned long long* __restrict__ pads, int me, int P,
                 long long C, long long row_bytes,
                 const int* __restrict__ table, int n_entries, int n_phases,
                 int pairwise, int sys, long long epoch, long long timeout_ns,
                 rma::SyncWords* sync, long long* err) {
  constexpr bool kBulk = sizeof(V) == 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kPeerStages * kStageBytes);
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kPeerStages; ++s) bulk::mbar_init(&bars[s], 1);
      bulk::fence_mbar_init();
    }
  }
  __syncthreads();

  const int slot = static_cast<int>(blockIdx.x);
  const int slots = static_cast<int>(gridDim.x);
  PeerEpoch ep{packed, peers, P, C, row_bytes, table, n_entries, pairwise,
               me, slot, slots};
  long long* mine = reinterpret_cast<long long*>(pads[me]);
  if (blockIdx.x == 0) {
    rma::fence(sys);
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      if (j != me)
        rma::signal(rma::flag(reinterpret_cast<long long*>(pads[j]), P, slots,
                              rma::kOpen, me, 0),
                    epoch, sys);
  }
  const int* phase_start = table + 2 * n_entries;
  const bool leader = threadIdx.x == 0;    // moves the bytes (bulk form)
  const bool waiter = threadIdx.x == 32;   // acquires the peers' flags
  // The waiter acquires `open` of every remote target of phase `ph`.
  auto wait_open = [&](int ph) {
    for (int e = phase_start[ph]; e < phase_start[ph + 1]; ++e) {
      const int t = static_cast<int>(ep.target(e));
      if (t != me)
        rma::wait(rma::flag(mine, P, slots, rma::kOpen, t, 0), P, rma::kOpen,
                  t, me, epoch, timeout_ns, err, sys);
    }
  };
  Ring<PeerEpoch, kPeerStages> rg{
      ring, bars, {&ep, 0, n_entries, 0, 0, nullptr, nullptr}, 0, 0};
  if constexpr (kBulk) {
    if (leader) rg.prime();
  }
  if (waiter) wait_open(0);
  __syncthreads();  // phase 0's targets are open
  for (int ph = 0; ph < n_phases; ++ph) {
    const int e0 = phase_start[ph], e1 = phase_start[ph + 1];
    // The puts of this phase (its targets were opened before the barrier
    // that started it), then this CTA's round slot in each target's pad.
    if constexpr (kBulk) {
      if (leader) {
        rg.store_phase(e0, e1);  // every bulk store of the CTA complete
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
      }
    } else {
      for (int e = e0; e < e1; ++e) {
        long long lo, hi;
        bulk::split(ep.cap(e) * row_bytes / static_cast<long long>(sizeof(V)),
                    slots, slot, &lo, &hi);
        const V* __restrict__ src =
            reinterpret_cast<const V*>(ep.src_bucket(e));
        V* __restrict__ dst = reinterpret_cast<V*>(ep.dst_bucket(e));
        for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x)
          dst[v] = src[v];
      }
      rma::fence(sys);
      __syncthreads();
    }
    if (leader) {
      for (int e = e0; e < e1; ++e) {
        const int t = static_cast<int>(ep.target(e));
        if (t != me)
          rma::signal(rma::flag(reinterpret_cast<long long*>(pads[t]), P,
                                slots, rma::kRound, me, slot),
                      epoch, sys);
      }
      if constexpr (kBulk) rg.load_ahead();
    }
    // Meanwhile the waiter acquires this phase's incoming puts (slot c of
    // each source) and the next phase's opens.
    if (waiter) {
      for (int e = e0; e < e1; ++e) {
        const int s = static_cast<int>(ep.source(e));
        if (s != me)
          rma::wait(rma::flag(mine, P, slots, rma::kRound, s, slot), P,
                    rma::kRound, s, me, epoch, timeout_ns, err, sys);
      }
      if (ph + 1 < n_phases) wait_open(ph + 1);
    }
    // The unlock: the next round starts after this one, on every CTA.
    if (ph + 1 < n_phases)
      rma::grid_sync(&sync->bar, P, me, epoch, timeout_ns, err);
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

namespace {

// Cluster sizes the wrapper may ask for, and the launch attributes they need.
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    unsigned grid, int cluster, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid, 1, 1);
  cfg->blockDim = dim3(kClusterThreads, 1, 1);
  cfg->dynamicSmemBytes = kClusterSmem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// active[j]: how many clusters of kClusterSizes[j] CTAs the current device
// holds at once (cudaOccupancyMaxActiveClusters) for lock_cluster_kernel.
// It also sets the kernel's shared-memory limit and allows cluster sizes
// above 8 on this device, which every launch needs: the wrapper asks once
// per device before it launches there.
extern "C" int repro_a2a_lock_cluster_occupancy(int* active) {
  cudaError_t rc = cudaFuncSetAttribute(
      lock_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kClusterSmem);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(lock_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int j = 0; j < 5 && rc == cudaSuccess; ++j) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, kClusterSizes[j], kClusterSizes[j], nullptr);
    rc = cudaOccupancyMaxActiveClusters(&active[j], lock_cluster_kernel, &cfg);
  }
  return static_cast<int>(rc);
}

// packed [P, P*C, row_bytes] -> out [P, P*C, row_bytes], the whole epoch.
// `table` (device, int32) is [rounds(n) | caps(n) | phase_start(phases+1)];
// `cluster` CTAs per origin rank, a size repro_a2a_lock_cluster_occupancy
// gave for this device.  row_bytes and both bases must be 16-byte multiples;
// anything else is refused with cudaErrorInvalidValue.
extern "C" int repro_a2a_lock_cluster(const void* packed, void* out,
                                      long long P, long long C,
                                      long long row_bytes, const void* table,
                                      int n_entries, int n_phases,
                                      int pairwise, int cluster, void* stream) {
  bool size_ok = false;
  for (int c : kClusterSizes) size_ok |= c == cluster;
  if (!size_ok || P < 1 || P * cluster > 0x7fffffffLL || n_phases < 1 ||
      n_entries < n_phases || row_bytes % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P * C == 0 || row_bytes == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, static_cast<unsigned>(P * cluster), cluster,
                 static_cast<cudaStream_t>(stream));
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, lock_cluster_kernel, static_cast<const uint8_t*>(packed),
      static_cast<uint8_t*>(out), P, C, row_bytes,
      static_cast<const int*>(table), n_entries, n_phases, pairwise);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kPeerSmem = kPeerStages * kStageBytes + kPeerStages * 8 + 128;

namespace {

// The peer kernel's form for an access width of 16 (TMA bulk), 4 or 1 bytes,
// and its dynamic shared memory.
const void* peer_kernel_for(int width, int* smem) {
  *smem = width == 16 ? kPeerSmem : 0;
  switch (width) {
    case 16: return reinterpret_cast<const void*>(lock_peer_kernel<uint4>);
    case 4: return reinterpret_cast<const void*>(lock_peer_kernel<uint32_t>);
    case 1: return reinterpret_cast<const void*>(lock_peer_kernel<uint8_t>);
    default: return nullptr;
  }
}

}  // namespace

// What the card says of the peer kernel's form for `width` (16, 4 or 1) on
// the current device: out = [resident CTAs per SM, SMs, registers per
// thread, local memory bytes per thread (spills)].  It also sets the 16-byte
// form's shared-memory limit on this device, which its launches need: the
// wrapper asks once per device before it launches there.
extern "C" int repro_a2a_lock_peer_info(int width, int* out) {
  int smem = 0;
  const void* fn = peer_kernel_for(width, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && smem > 0)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                       kClusterThreads, smem);
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

// The lock epoch `epoch` of origin `me`: packed [P*C, row_bytes] (its send
// buckets) into every target's window (`peers`, device, P addresses), with
// the signal pads `pads` (device, P addresses; `ctas` round slots per
// origin) and this rank's `sync` words; the flags at system scope if `sys`,
// else GPU scope (every rank on this card).  `table` (device, int32) is
// [rounds(n) | caps(n) | phase_start(phases+1)] over the active rounds (the
// wrapper's `lock_peer_schedule`).  `ctas` CTAs, the window's budget;
// `width` the access width: 16 (row_bytes and packed 16-byte multiples, the
// window bases too, which the wrapper checks), 4 (4-byte multiples) or 1.
// Anything else is refused with cudaErrorInvalidValue.
extern "C" int repro_a2a_lock_peer(const void* packed, const void* peers,
                                   const void* pads, int me, int P,
                                   long long C, long long row_bytes,
                                   const void* table, int n_entries,
                                   int n_phases, int pairwise, int width,
                                   int ctas, int sys, long long epoch,
                                   long long timeout_ns, void* sync, void* err,
                                   void* stream) {
  int smem = 0;
  const void* fn = peer_kernel_for(width, &smem);
  if (fn == nullptr || P < 1 || me < 0 || me >= P || ctas < 1 ||
      n_phases < 1 || n_entries < n_phases || row_bytes % width != 0 ||
      (reinterpret_cast<uintptr_t>(packed) % width) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(packed);
  const auto* peer_table = static_cast<const unsigned long long*>(peers);
  const auto* pad_table = static_cast<const unsigned long long*>(pads);
  const auto* tab = static_cast<const int*>(table);
  auto* words = static_cast<rma::SyncWords*>(sync);
  auto* rec = static_cast<long long*>(err);
  // A cooperative launch: the runtime puts every CTA on the card at once
  // (the grid barrier needs them all) or refuses a grid that cannot fit.
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t rc;
  if (width == 16)
    rc = cudaLaunchKernelEx(&cfg, lock_peer_kernel<uint4>, src, peer_table,
                            pad_table, me, P, C, row_bytes, tab, n_entries,
                            n_phases, pairwise, sys, epoch, timeout_ns, words,
                            rec);
  else if (width == 4)
    rc = cudaLaunchKernelEx(&cfg, lock_peer_kernel<uint32_t>, src,
                            peer_table, pad_table, me, P, C, row_bytes, tab,
                            n_entries, n_phases, pairwise, sys, epoch,
                            timeout_ns, words, rec);
  else
    rc = cudaLaunchKernelEx(&cfg, lock_peer_kernel<uint8_t>, src, peer_table,
                            pad_table, me, P, C, row_bytes, tab, n_entries,
                            n_phases, pairwise, sys, epoch, timeout_ns, words,
                            rec);
  return static_cast<int>(rc);
}
