"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by hand with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers: seconds per build,
not minutes) and bound with ``ctypes``.  Builds happen at first use, from
the sources in this checkout, into ``kernels/_build/`` (git-ignored); a
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  All missing
libraries are compiled in parallel, one ``nvcc`` per source.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")

#: kernel name -> its source under csrc/ (each also includes common.cuh)
SOURCES = {"ksplit_gemm": "ksplit_gemm.cu", "mp_gemm_tile": "mp_gemm_tile.cu",
           "split_gemm": "split_gemm.cu", "grouped_gemm": "grouped_gemm.cu",
           "convert": "convert.cu",
           "decode_attention": "decode_attention.cu"}
_HEADERS = ("common.cuh", "tile_dot.cuh")

NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

#: torch dtype -> the DType code of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

#: guards the wrappers' module-level launch counters: the cluster's
#: replicas launch from their own threads, and ``launches += 1`` is a
#: read-modify-write
COUNT_LOCK = threading.Lock()

#: kernel name -> {"seconds": build time or 0.0 if reused, "log": nvcc's
#: stderr (ptxas register / spill report)} for the builds of this process
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> path.
    Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        for n in names:
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "log": ""})
        return paths
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, p)
    errors = []
    for n, (proc, tmp, p) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{n}: nvcc exited {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, p)   # atomic: a concurrent builder never sees half
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": err}
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The bound library of kernel ``name`` (built on first use); its
    ``<name>_launch`` entry gets ``argtypes`` and an int (cudaError_t)
    result."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def cuda_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a launch next to ``t``."""
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def upload_int32(arr, device: torch.device) -> torch.Tensor:
    """An int32 copy of host array ``arr`` on ``device``, queued on the
    current stream without waiting for it: staged through pinned memory,
    which the caching host allocator keeps until the copy has run (a
    pageable copy would wait for all earlier work on the stream)."""
    host = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
    return host.pin_memory().to(device, non_blocking=True)
