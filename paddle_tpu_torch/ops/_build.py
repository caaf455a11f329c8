"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` file under ``paddle_tpu_torch/csrc/`` exposes a plain C
interface; the ``*.cuh`` headers beside them (``sm90.cuh``: the helpers
of the tensor-core kernels; ``flash_d256.cuh``: those the flash kernels
that split head_dim 256 between two warpgroups share; ``flash_f32.cuh``:
those of the split-TF32 flash forwards; ``flash_f32_bwd.cuh``: those of
the split-TF32 flash dq and dk/dv at every head_dim) are included, not
compiled. At
first use each source is compiled for Hopper (``sm_90a``) by its own
``nvcc``, all of them started together, and the objects are linked into
one shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas=-v -c -o <hash>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/torch_kernels/<hash>/libpaddle_tpu_torch_kernels.so <hash>/*.o

The build directory sits at the root of the checkout, is keyed on a hash
of the sources, the headers and the flags (a changed source or header
rebuilds, an unchanged tree loads what is there), and is listed in
``.gitignore``. PyTorch's headers
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

__all__ = ["load", "build_dir", "sources", "headers", "build_log",
           "build_seconds", "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_LIB_NAME = "libpaddle_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path = ""
_log = ""
_seconds = 0.0


def sources() -> List[str]:
    """The ``*.cu`` files: one nvcc each."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def headers() -> List[str]:
    """The ``*.cuh`` files the sources include: hashed, not compiled."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


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


def _key() -> str:
    """Hash of the flags and of every source and header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes for every entry point: a pointer or a stream as a Python
    int is 64 bits wide and must not be passed as a 32-bit C int."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lmhead_ce_combine.argtypes = [p, p, p, p, p, i, i, p]
    lib.lmhead_ce_combine.restype = i
    lib.lmhead_ce_bwd_f32_sm90.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.lmhead_ce_bwd_f32_sm90.restype = i
    lib.lmhead_ce_bwd_sm90.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.lmhead_ce_bwd_sm90.restype = i
    for fwd in (lib.lmhead_ce_fwd_sm90, lib.lmhead_ce_fwd_f32_sm90):
        fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fwd.restype = i
    for tile in (lib.lmhead_ce_bwd_f32_sm90_rows,
                 lib.lmhead_ce_bwd_f32_sm90_cols,
                 lib.lmhead_ce_bwd_f32_sm90_slab,
                 lib.lmhead_ce_bwd_f32_sm90_pad, lib.lmhead_ce_sm90_tile,
                 lib.lmhead_ce_sm90_half, lib.lmhead_ce_sm90_slab,
                 lib.lmhead_ce_sm90_max_d,
                 lib.lmhead_ce_fwd_sm90_tile_n, lib.lmhead_ce_fwd_sm90_tile_v,
                 lib.lmhead_ce_fwd_f32_sm90_tile_n,
                 lib.lmhead_ce_fwd_f32_sm90_tile_v,
                 lib.flash_attn_fwd_sm90_tile_q,
                 lib.flash_attn_fwd_sm90_tile_kv,
                 lib.flash_attn_fwd_d256_sm90_tile_q,
                 lib.flash_attn_fwd_d256_sm90_tile_kv,
                 lib.flash_attn_dkv_d256_sm90_tile,
                 lib.flash_attn_dkv_d256_sm90_stage,
                 lib.flash_attn_dq_d256_sm90_tile,
                 lib.flash_attn_dq_d256_sm90_stage,
                 lib.flash_attn_fwd_f32_d256_sm90_tile_q,
                 lib.flash_attn_fwd_f32_d256_sm90_tile_kv,
                 lib.flash_attn_dkv_f32_d256_sm90_tile,
                 lib.flash_attn_dkv_f32_d256_sm90_stage,
                 lib.flash_attn_dkv_f32_d256_sm90_flush,
                 lib.flash_attn_dkv_f32_sm90_tile,
                 lib.flash_attn_dkv_f32_sm90_stage,
                 lib.flash_attn_dkv_f32_sm90_flush,
                 lib.flash_attn_dq_f32_d256_sm90_tile,
                 lib.flash_attn_dq_f32_d256_sm90_stage,
                 lib.flash_attn_dq_f32_d256_sm90_flush,
                 lib.flash_attn_dq_f32_sm90_tile,
                 lib.flash_attn_dq_f32_sm90_stage,
                 lib.flash_attn_dq_f32_sm90_flush):
        tile.argtypes = []
        tile.restype = i
    f = ctypes.c_float
    lib.fused_adam_step.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong,
                                    f, f, f, f, f, f, i, i, p]
    lib.fused_adam_step.restype = i
    geo = ctypes.POINTER(ctypes.c_longlong)
    for fwd in (lib.flash_attn_fwd_sm90, lib.flash_attn_fwd_f32_sm90,
                lib.flash_attn_fwd_d256_sm90,
                lib.flash_attn_fwd_f32_d256_sm90):
        fwd.argtypes = [p] * 5 + [i] * 5 + [geo, geo, f, i, p]
        fwd.restype = i
    for dq in (lib.flash_attn_dq_sm90, lib.flash_attn_dq_d256_sm90,
               lib.flash_attn_dq_f32_sm90, lib.flash_attn_dq_f32_d256_sm90):
        dq.argtypes = [p] * 7 + [i] * 5 + [geo, geo, f, i, p]
        dq.restype = i
    for dkv in (lib.flash_attn_dkv_sm90, lib.flash_attn_dkv_d256_sm90,
                lib.flash_attn_dkv_f32_sm90, lib.flash_attn_dkv_f32_d256_sm90):
        dkv.argtypes = [p] * 8 + [i] * 5 + [geo, geo, f, i, p]
        dkv.restype = i
    for tile in (lib.flash_attn_bwd_sm90_tile, lib.flash_attn_dq_sm90_stage,
                 lib.flash_attn_dkv_sm90_stage,
                 lib.flash_attn_fwd_f32_sm90_tile_q,
                 lib.flash_attn_fwd_f32_sm90_tile_kv):  # of a head_dim
        tile.argtypes = [i]
        tile.restype = i
    return lib


def _run(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; their output, or raise on the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _compile(srcs: List[str], out_dir: str, out: str) -> str:
    """One nvcc per source, started together, then one link; the library
    appears atomically, so a concurrent loader sees all of it or none."""
    nvcc = _nvcc()
    pid = os.getpid()
    objs = [os.path.join(out_dir, f"{os.path.basename(s)[:-3]}.{pid}.o")
            for s in srcs]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                for s, o in zip(srcs, objs)])
    tmp = f"{out}.tmp.{pid}"
    log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
    os.replace(tmp, out)
    for o in objs:
        os.remove(o)
    return log


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (thread-safe)."""
    global _lib, _path, _log, _seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        out_dir = os.path.join(build_dir(), _key())
        out = os.path.join(out_dir, _LIB_NAME)
        if not os.path.exists(out):
            os.makedirs(out_dir, exist_ok=True)
            t0 = time.perf_counter()
            _log = _compile(srcs, out_dir, out)
            _seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(out))
        _path = out
        return _lib


def build_log() -> str:
    """nvcc's output of this process's build ('' when it loaded a built
    library): with -Xptxas=-v, each kernel's registers, shared memory
    and spills."""
    return _log


def library_path() -> str:
    """Path of the loaded shared library ('' before :func:`load`)."""
    return _path


def build_seconds() -> float:
    """Seconds nvcc took in this process (0.0 when nothing was built)."""
    return _seconds
