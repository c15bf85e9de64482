// The signal kernel of the peer epochs, and the window registration of the
// port's ranks in processes (CUDA IPC).
//
// The TPU kernels synchronise their epochs with semaphores: `_fence_kernel`
// (src/repro/kernels/a2a_fence.py) opens with a barrier semaphore signalled
// to every peer and waited on, and closes by waiting on its send and recv
// DMA semaphores; `_lock_kernel` (a2a_lock.py) waits per round.  With one
// process per rank those become int64 flags in each rank's signal pad
// (rma_flags.cuh).  The peer K2 and K4 (a2a_fence.cu, a2a_lock.cu) signal
// and wait inside their one launch per epoch; the peer K3's epoch launches
// this kernel to OPEN (signal `open[me]` on every peer: my window is free
// for this epoch; wait until every peer's `open` flag in my pad reaches the
// epoch) and, after its puts, to CLOSE (signal `close[me]` on every peer,
// wait for every peer's).  Stream order carries the rest: the puts of such
// an epoch are the kernel launched between its OPEN and its CLOSE, and the
// local unpack runs after the CLOSE.  `purpose` round signals and waits on
// every round slot of an origin.
//
// One block of 32 threads: lane j signals peer j and waits on peer j's flag
// (j < P, j != me, strided for P > 32).  Its bound is latency: P-1 remote
// stores and P-1 polled loads.  On one card without MPS the ranks' kernels
// are time-sliced, so a wait lasts until the peer's context gets its slice.
//
// Registration: each rank allocates its window (signal pad and exposed
// bytes) with cudaMalloc, zeroes it, and exports an IPC handle; the ranks
// exchange the handles over the control plane and each opens every peer's
// (cudaIpcOpenMemHandle), so a put is a store through the peer's pointer.
#include <cstring>

#include "rma_flags.cuh"
#include "rowcopy.cuh"

namespace {

__global__ void __launch_bounds__(32)
signal_kernel(const unsigned long long* __restrict__ pads, int me, int P,
              int slots, int purpose, long long epoch, int do_signal,
              int do_wait, long long timeout_ns, long long* err) {
  long long* mine = reinterpret_cast<long long*>(pads[me]);
  const int n = purpose == rma::kRound ? slots : 1;
  if (do_signal) {
    // Everything this rank's earlier kernels wrote is ordered before the
    // signal by stream order; the fence covers the block's own view of it.
    __threadfence_system();
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      if (j != me)
        for (int c = 0; c < n; ++c)
          rma::signal(rma::flag(reinterpret_cast<long long*>(pads[j]), P,
                                slots, purpose, me, c),
                      epoch);
  }
  if (do_wait) {
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      if (j != me)
        for (int c = 0; c < n; ++c)
          rma::wait(rma::flag(mine, P, slots, purpose, j, c), P, purpose, j,
                    me, epoch, timeout_ns, err);
  }
  __syncthreads();
}

}  // namespace

ROWCOPY_EXPORT_ERROR_STRING

// `pads` (device, P addresses): every rank's signal pad as this process
// maps it, its own at `me`; `slots` round slots per origin.  Signals
// `purpose` of `epoch` on every peer if `do_signal`, then waits for every
// peer's flag in its own pad if `do_wait`.  `err`: 4 int64 of host memory
// the card can write (or null), set on a timed-out wait.
extern "C" int repro_rma_signal(const void* pads, int me, int P, int slots,
                                int purpose, long long epoch, int do_signal,
                                int do_wait, long long timeout_ns, void* err,
                                void* stream) {
  if (P < 1 || me < 0 || me >= P || slots < 1 || purpose < rma::kOpen ||
      purpose > rma::kRound)
    return static_cast<int>(cudaErrorInvalidValue);
  signal_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(pads), me, P, slots, purpose,
      epoch, do_signal, do_wait, timeout_ns, static_cast<long long*>(err));
  return static_cast<int>(cudaGetLastError());
}

// A zeroed allocation of `bytes` on the current device and its IPC handle
// (`handle`: 64 bytes).  Waits for the zeroing, so a peer that opens the
// handle reads zeros.
extern "C" int repro_ipc_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t rc = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (rc == cudaSuccess) rc = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess)
    rc = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(rc);
}

// Maps a peer's allocation from its handle into this process.
extern "C" int repro_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int repro_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int repro_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// Bytes of an IPC handle (the wrapper checks it against its buffer).
extern "C" int repro_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}
