"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source under ``csrc/`` is compiled on first use, for Hopper
(``sm_90a``), into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  No library is linked
beyond the CUDA runtime: ``gather_matmul.cu`` includes ``cuda.h`` for the
tensor-map types only and looks up ``cuTensorMapEncodeTiled`` at run time
through the runtime's entry-point query, so the line needs no ``-lcuda``.  Nothing is built or loaded
when this module is imported: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.  Any build or launch error raises;
there is no fallback.

Builds take a file lock on the build directory, so processes that first
use a kernel at once (one per rank) build it once; a program that spawns
its ranks builds in the parent first.

Each kernel is a ``CudaKernel``: it holds the C symbol, its ``argtypes``,
and two counters.  ``launches`` grows by one where the wrapper launches the
kernel, and nowhere else; ``plain_calls`` grows where the kernel's plain
PyTorch version runs.  ``chip_smoke.py`` zeroes them before the main path
and reads them after it, to show that the path went through the kernels.

Each public wrapper is ``counted``: under an active step counter
(``roofline.trace.StepCounter``) a call reports one call of its kernel
(K1-K6) with the work its input and output shapes give, and the aten ops
its plain version runs are not counted again.  A ``meta`` tensor takes
each wrapper's shape path: an empty output of the kernel's shape and
dtype, neither a launch nor a plain call, so a step traces on ``meta``
(``launch.dryrun``) with the kernel calls, FLOPs and bytes of a run.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..roofline import trace

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("gather_rows", "a2a_fence", "a2a_lock", "a2a_hier", "gather_matmul",
           "rma_signal")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    path = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where the "
            "CUDA toolkit is installed")
    return path


def library_path(source: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:12]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory, so that processes that
    first use a kernel at the same time (one per rank) build it once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(sources=SOURCES) -> dict[str, float]:
    """Compile every source not built yet, all nvcc processes at once,
    under the build directory's lock: a second process waits for the first
    one's build and finds the libraries there.  A program that spawns one
    process per rank builds in the parent first.

    Returns the seconds each build took (0.0 for a library already there).
    Raises RuntimeError with nvcc's output if any build fails.
    """
    if all(library_path(s).exists() for s in sources):
        return {s: 0.0 for s in sources}
    nvcc = nvcc_path()
    with _build_lock():
        started = {}
        seconds = {}
        for source in sources:
            target = library_path(source)
            if target.exists():
                seconds[source] = 0.0
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started[source] = (proc, tmp, target, time.perf_counter())
        failures = []
        for source, (proc, tmp, target, t0) in started.items():
            out, _ = proc.communicate()
            seconds[source] = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{source}.cu (nvcc exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return seconds


class CudaKernel:
    """One hand-written kernel: its library, C entry point, counters and
    ``kid``, the TPU kernel it ports (K1-K6, ``PERF.md``'s table)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 kid: str | None = None):
        self.name = name
        self.kid = kid
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.plain_calls = 0
        self._fn = None
        self._error_string = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.repro_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._error_string, self._lib = fn, err, lib
        return self._fn

    def c_function(self, symbol: str, argtypes):
        """Another C entry point of this kernel's library (a query, not a
        launch: it counts nothing), returning a CUDA error code."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def error_string(self, rc: int) -> str:
        self._load()
        return self._error_string(rc).decode()

    def launch(self, *args) -> None:
        """Call the C launcher; raise on a non-zero ``cudaGetLastError``."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {rc} at launch: "
                f"{self.error_string(rc)}")
        self.launches += 1


VOIDP = ctypes.c_void_p
I64 = ctypes.c_longlong
INT = ctypes.c_int

# What a kernel's info entry point writes (four ints).
INFO_KEYS = ("blocks_per_sm", "sms", "registers", "local_bytes")


def kernel_info(kernel: CudaKernel, symbol: str, form: int,
                device_index: int) -> dict:
    """What the card says of one form of ``kernel`` through its C entry
    point ``symbol(form, out)``: resident blocks per SM, SMs, registers per
    thread and local memory bytes per thread (stack and spills); raises if
    the query fails."""
    import torch

    out = (INT * len(INFO_KEYS))()
    with torch.cuda.device(device_index):
        rc = kernel.c_function(symbol, [INT, VOIDP])(
            form, ctypes.cast(out, VOIDP))
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: occupancy query failed, CUDA "
                           f"error {rc}: {kernel.error_string(rc)}")
    return dict(zip(INFO_KEYS, out))

KERNELS: dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


def counts() -> dict[str, dict[str, int]]:
    return {name: {"launches": k.launches, "plain_calls": k.plain_calls}
            for name, k in KERNELS.items()}


def check_cuda(*tensors) -> None:
    """A kernel takes CUDA tensors on one device, contiguous; else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"kernel wrappers take CPU tensors (plain version), meta "
                f"tensors (shape) or CUDA tensors (kernel), got a tensor on "
                f"{t.device} beside one on {dev}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def check_meta(*tensors) -> None:
    """The shape path takes ``meta`` tensors only; else raise."""
    for t in tensors:
        if t.device.type != "meta":
            raise ValueError(
                f"kernel wrappers take CPU tensors (plain version), meta "
                f"tensors (shape) or CUDA tensors (kernel), got a tensor on "
                f"{t.device} beside one on meta")


def stream_handle(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def counted(kernel: CudaKernel, cost):
    """Decorate a kernel's public wrapper: under an active step counter a
    call reports one call of ``kernel.kid`` with ``cost(out, *args,
    **kwargs) -> (flops, bytes)``, and its own aten ops are hidden from the
    counter."""
    kid = kernel.kid

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            counter = trace.active()
            if counter is None:
                return fn(*args, **kwargs)
            with counter.hidden():
                out = fn(*args, **kwargs)
            counter.kernel(kid, *cost(out, *args, **kwargs))
            return out
        return wrapper
    return wrap


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)
