"""Build and load the package's CUDA kernels (``csrc/*.cu``).

All kernels go into one shared library with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``. Each
source compiles in its own ``nvcc`` process, all started together, and one
more links them. The library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is loaded from
``_build/``. Nothing here runs at import time: the CPU path never needs
nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types. Every entry returns the
# cudaError_t of its launch (0 = success).
_SIGNATURES = {
    "osk_fast_nms": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _F, _P),
    "osk_gather_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "osk_masked_best2": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build_log_path() -> str:
    """Where the last build's compiler output (``-Xptxas -v``) is kept."""
    return os.path.join(BUILD_DIR, "build.log")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs = _sources()
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libosk_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            compiles = []
            for src in srcs:
                obj = os.path.join(tmp, os.path.basename(src) + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
                compiles.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            log, failed = [], []
            for cmd, _, proc in compiles:
                out = proc.communicate()[0]
                log.append(" ".join(cmd) + "\n" + out)
                if proc.returncode != 0:
                    failed.append(out)
            lib_tmp = os.path.join(tmp, "lib.so")
            if not failed:
                cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp,
                       *(obj for _, obj, _ in compiles)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(proc.stderr)
            with open(build_log_path(), "w") as f:
                f.write("\n".join(log))
            if failed:
                raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
            os.replace(lib_tmp, so)  # atomic: concurrent builders never see half a file
    return bind(ctypes.CDLL(so))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on ``lib``."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.osk_error_string.argtypes = (ctypes.c_int,)
    lib.osk_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise if its launch reported an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.osk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream() -> int:
    """PyTorch's current CUDA stream, as the integer the C entries take."""
    return torch.cuda.current_stream().cuda_stream


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
