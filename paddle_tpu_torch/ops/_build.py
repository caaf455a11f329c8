"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` file under ``paddle_tpu_torch/csrc/`` exposes a plain C
interface. At first use they are compiled together into one shared
library for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/libpaddle_tpu_torch_kernels.so csrc/*.cu

The build directory sits at the root of the checkout, is keyed on a hash
of the sources and the flags (a changed source rebuilds, an unchanged one
loads what is there), and is listed in ``.gitignore``. PyTorch's headers
are never included, so a build takes seconds, not minutes.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

__all__ = ["load", "build_dir", "sources", "build_log", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_LIB_NAME = "libpaddle_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log = ""
_seconds = 0.0


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def build_dir() -> str:
    """``build/torch_kernels`` at the root of the checkout."""
    return os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of paddle_tpu_torch cannot be built (there is no fallback)")


def _key(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes for every entry point: a pointer or a stream as a Python
    int is 64 bits wide and must not be passed as a 32-bit C int."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lmhead_ce_partial.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.lmhead_ce_partial.restype = i
    lib.lmhead_ce_combine.argtypes = [p, p, p, p, p, i, i, p]
    lib.lmhead_ce_combine.restype = i
    for tile in (lib.lmhead_ce_tile_n, lib.lmhead_ce_tile_v):
        tile.argtypes = []
        tile.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (thread-safe)."""
    global _lib, _log, _seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        out_dir = os.path.join(build_dir(), _key(srcs))
        out = os.path.join(out_dir, _LIB_NAME)
        if not os.path.exists(out):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            _seconds = time.perf_counter() - t0
            _log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): "
                    f"{' '.join(cmd)}\n{_log}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all
        _lib = _declare(ctypes.CDLL(out))
        return _lib


def build_log() -> str:
    """nvcc's output of this process's build ('' when it loaded a built
    library): with -Xptxas=-v, each kernel's registers, shared memory
    and spills."""
    return _log


def build_seconds() -> float:
    """Seconds nvcc took in this process (0.0 when nothing was built)."""
    return _seconds
