// Flag primitives of the peer epochs: ranks in separate processes signal
// each other through int64 flags in each other's signal pads (rma_signal.cu,
// the peer kernels of a2a_fence.cu and a2a_lock.cu).
//
// A pad of P origins holds, in order: open[P], close[P] and round[P][S],
// where S is the number of round slots per origin, the CTAs of the peer K4
// (the window's `lock_ctas`, agreed by every rank at registration).  Flag
// (open or close, j) is written only by origin j; round slot (j, c) only by
// CTA c of origin j's peer K4.  Each holds the number of the last epoch its
// writer signalled.  Flags are never reset: a wait is for a flag to reach
// the epoch at hand (`>=`), so a rank that runs ahead never undoes a
// signal.  A signal is a system-scope release store of the epoch number, a
// wait a system-scope acquire load, so the same code holds between
// processes on one card and across cards: everything the signalling thread
// wrote (or saw) before the store is visible to the waiting thread after
// its load returns the epoch.  Where every rank shares this card, the peer
// K2 and K4 take GPU scope instead (`sys` false): their peers' threads run
// on the same device, whose L2 is the point of coherence for all of them,
// and a system-scope fence, release or acquire costs about 1.5 us on an
// H100 against a few hundred ns.  The store writes the epoch rather than
// adding one, so an epoch that skips a flag (a lock round elided by the
// schedule) leaves the count of later epochs right.
//
// Beside the pad, each rank's window has `SyncWords` in its own device
// memory, which only its own kernels touch: the peer K4's grid barrier and
// the one-launch fence epoch's ticket, arrival count and go flag.  They
// start at zero and each kernel leaves them as a next launch needs them.
//
// Every wait is bounded: past `timeout_ns` of the global timer (which runs
// on while the process's context is switched out) it writes what it waited
// for into `err` (host memory the card can write, or null) unless a wait
// of this rank already did, prints it, and traps.  A record is (1, epoch,
// purpose * P + origin, rank).  A wait on this rank's own grid (a barrier,
// the go flag) waits twice as long, so the peer wait that held the grid up
// records first; if none did, it records purpose kGrid and origin = rank.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace rma {

constexpr int kOpen = 0;    // the target's window is free for this epoch
constexpr int kClose = 1;   // the origin's puts of this epoch have landed
constexpr int kRound = 2;   // the lock: the origin's round put has landed
constexpr int kGrid = 3;    // records only: a wait on this rank's own grid

struct SyncWords {
  unsigned bar;     // peer K4: grid barrier (each meeting adds 2^31)
  unsigned ticket;  // peer K2: blocks that have started this launch
  unsigned arrive;  // peer K2: blocks whose puts are published
  unsigned unused;
  long long go;     // peer K2: the epoch whose OPEN block 0 has completed
};

// The flag of (purpose, origin `from`, round slot `slot`) in a pad of P
// origins with `slots` round slots each.
__device__ __forceinline__ long long* flag(long long* pad, int P, int slots,
                                           int purpose, int from, int slot) {
  return purpose == kRound
             ? pad + 2LL * P + static_cast<long long>(from) * slots + slot
             : pad + static_cast<long long>(purpose) * P + from;
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// A release store and an acquire load at system scope (`sys`) or GPU scope.
__device__ __forceinline__ void store_release(long long* flag, long long v,
                                              bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(flag), "l"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(flag), "l"(v)
                 : "memory");
}

__device__ __forceinline__ long long load_acquire(const long long* flag,
                                                  bool sys) {
  long long v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(flag)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(flag)
                 : "memory");
  return v;
}

// A fence at system or GPU scope.
__device__ __forceinline__ void fence(bool sys) {
  if (sys)
    __threadfence_system();
  else
    __threadfence();
}

__device__ __forceinline__ unsigned load_acquire_gpu(const unsigned* word) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(word)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel_gpu(unsigned* word,
                                                    unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(word), "r"(v)
               : "memory");
  return old;
}

// A wait gave up: record it (unless this rank's record is already set),
// print it and trap.
__device__ __noinline__ void give_up(volatile long long* err, int P,
                                     int purpose, int from, int rank,
                                     long long epoch, long long seen,
                                     long long timeout_ns) {
  if (err != nullptr && err[0] == 0) {
    err[1] = epoch;
    err[2] = static_cast<long long>(purpose) * P + from;
    err[3] = rank;
    __threadfence_system();
    err[0] = 1;
    __threadfence_system();
  }
  printf("rma: rank %d, epoch %lld: %s of rank %d stayed at %lld for %lld "
         "ns\n",
         rank, epoch,
         purpose == kOpen    ? "flag open"
         : purpose == kClose ? "flag close"
         : purpose == kRound ? "flag round"
                             : "its own grid",
         from, seen, timeout_ns);
  __trap();
}

// Origin `rank` signals `epoch` into `flag` of a target's pad.
__device__ __forceinline__ void signal(long long* flag, long long epoch,
                                       bool sys = true) {
  store_release(flag, epoch, sys);
}

// Waits until `flag` (purpose `purpose` of origin `from` in this rank's
// pad) reaches `epoch`; past `timeout_ns` gives up.
__device__ __forceinline__ void wait(const long long* flag, int P,
                                     int purpose, int from, int rank,
                                     long long epoch, long long timeout_ns,
                                     volatile long long* err,
                                     bool sys = true) {
  if (load_acquire(flag, sys) >= epoch) return;
  const long long t0 = global_ns();
  long long v;
  while ((v = load_acquire(flag, sys)) < epoch) {
    if (global_ns() - t0 > timeout_ns)
      give_up(err, P, purpose, from, rank, epoch, v, timeout_ns);
    __nanosleep(256);
  }
}

// Waits until this rank's own `go` word reaches `epoch` (set by a block of
// the same grid that is running); past twice `timeout_ns` gives up.
__device__ __forceinline__ void wait_local(const long long* go, int P,
                                           int rank, long long epoch,
                                           long long timeout_ns,
                                           volatile long long* err) {
  if (load_acquire(go, false) >= epoch) return;
  const long long t0 = global_ns();
  long long v;
  while ((v = load_acquire(go, false)) < epoch) {
    if (global_ns() - t0 > 2 * timeout_ns)
      give_up(err, P, kGrid, rank, rank, epoch, v, 2 * timeout_ns);
    __nanosleep(64);
  }
}

// Every block of the grid meets here.  Every block must be resident (the
// grid is within the card's budget for this rank), and `bar` holds a
// multiple of 2^31 at the first meeting (zero): each meeting adds 2^31 in
// all, block 0 adding 2^31 - (gridDim.x - 1) and every other block 1, so a
// block waits for the top bit of `bar` to flip from what its own add saw.
// Release and acquire at GPU scope order each block's earlier work before
// any block's later work.  Bounded like `wait_local`.
__device__ __forceinline__ void grid_sync(unsigned* bar, int P, int rank,
                                          long long epoch,
                                          long long timeout_ns,
                                          volatile long long* err) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = add_acq_rel_gpu(bar, add);
    if (((load_acquire_gpu(bar) ^ old) & 0x80000000u) == 0) {
      const long long t0 = global_ns();
      while (((load_acquire_gpu(bar) ^ old) & 0x80000000u) == 0) {
        if (global_ns() - t0 > 2 * timeout_ns)
          give_up(err, P, kGrid, rank, rank, epoch, old, 2 * timeout_ns);
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
}

}  // namespace rma
