// Flag primitives of the peer epochs: ranks in separate processes signal
// each other through int64 flags in each other's signal pads (rma_signal.cu,
// a2a_lock.cu's peer kernel).
//
// A pad holds kPurposes * P flags: flag (purpose, j) at purpose * P + j is
// written only by origin rank j, and holds the number of the last epoch j
// signalled for that purpose.  Flags are never reset: a wait is for a flag
// to reach the epoch at hand (`>=`), so a rank that runs ahead never undoes
// a signal.  A signal is a system-scope release store of the epoch number,
// a wait a system-scope acquire load, so the same code holds between
// processes on one card and across cards: everything the signalling thread
// wrote (or saw) before the store is visible to the waiting thread after
// its load returns the epoch.  The store writes the epoch rather than
// adding one, so an epoch that skips a flag (a lock round elided by the
// schedule) leaves the count of later epochs right.
//
// Every wait is bounded: past `timeout_ns` of the global timer (which runs
// on while the process's context is switched out) it writes what it waited
// for into `err` (host memory the card can write, or null), prints it, and
// traps.  A trap ends the grid with an error that the next synchronising
// call reports, so a lost peer is an error, not a hang.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace rma {

constexpr int kOpen = 0;    // the target's window is free for this epoch
constexpr int kClose = 1;   // the origin's puts of this epoch have landed
constexpr int kRound = 2;   // the lock: the origin's round put has landed
constexpr int kPurposes = 3;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ void store_release(long long* flag, long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(flag), "l"(v)
               : "memory");
}

__device__ __forceinline__ long long load_acquire(const long long* flag) {
  long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(flag)
               : "memory");
  return v;
}

// Origin `rank` signals `purpose` of `epoch` into target `pad`.
__device__ __forceinline__ void signal(long long* pad, int P, int purpose,
                                       int rank, long long epoch) {
  store_release(pad + purpose * P + rank, epoch);
}

// Waits until origin `from`'s flag `purpose` in this rank's `pad` reaches
// `epoch`; past `timeout_ns` records (1, epoch, purpose * P + from, rank) in
// `err`, prints it and traps.
__device__ __forceinline__ void wait(const long long* pad, int P, int purpose,
                                     int from, int rank, long long epoch,
                                     long long timeout_ns,
                                     volatile long long* err) {
  const long long* flag = pad + purpose * P + from;
  if (load_acquire(flag) >= epoch) return;
  const long long t0 = global_ns();
  while (load_acquire(flag) < epoch) {
    if (global_ns() - t0 > timeout_ns) {
      if (err != nullptr) {
        err[1] = epoch;
        err[2] = purpose * P + from;
        err[3] = rank;
        __threadfence_system();
        err[0] = 1;
        __threadfence_system();
      }
      printf("rma: rank %d, epoch %lld: flag %d (%s) of rank %d stayed at "
             "%lld for %lld ns\n",
             rank, epoch, purpose,
             purpose == kOpen ? "open" : (purpose == kClose ? "close" : "round"),
             from, load_acquire(flag), timeout_ns);
      __trap();
    }
    __nanosleep(256);
  }
}

}  // namespace rma
