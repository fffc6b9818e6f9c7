"""ctypes bindings for the native host runtime (the package's
``native/host_ops.cpp``).

The port's own copy of ``orb_slam3_detailed_comments_kor_tpu/io/
native_host.py``. The native layer plays the role of the reference's C++
driver code (``Examples/Stereo-Inertial/stereo_inertial_euroc.cc``): image
decode, rectification (``cv::remap``) and a threaded prefetch feeder.

The source is this package's ``native/host_ops.cpp``: the C interface,
PGM decoder, remap and feeder of the repository's ``native/host_ops.cpp``,
with a PNG decoder of its own on zlib's ``inflate`` in place of libpng
(bit-equal to the libpng build's output; gray+alpha takes the gray channel,
as PIL does). ``load`` compiles it with ``g++`` (the flags of
``native/Makefile``, linked with zlib and pthreads only) into this
package's ``_build/``, under a file name that carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded. Nothing is built at import time. ``load`` raises when the build
fails; the loaders in ``datasets.py`` then fall back to numpy and PIL, as
the reference's do, and so does ``load_gray`` for a PNG the decoder
refuses (interlaced or damaged).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_error: Optional[BaseException] = None


def library_path() -> str:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhost_ops_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-shared", "-o", out, SOURCE, *LIBS],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr[-4000:]}")
        os.replace(out, so)  # atomic: concurrent builders never see half a file


def load():
    """Load (building if needed) the native library; raises on failure,
    and again on every later call once a build has failed."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _Module(_lib)
        if _error is not None:
            raise RuntimeError("native host_ops unavailable") from _error
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except Exception as e:
            _error = e
            raise
        lib.decode_gray.restype = ctypes.c_int
        lib.decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.remap_bilinear.restype = None
        lib.remap_bilinear.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.feeder_create.restype = ctypes.c_void_p
        lib.feeder_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.feeder_next.restype = ctypes.c_int
        lib.feeder_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.feeder_destroy.restype = None
        lib.feeder_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _Module(_lib)


def _fptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _Module:
    def __init__(self, lib):
        self._lib = lib

    def load_gray(self, path: str, cap_h: int = 2048,
                  cap_w: int = 2048) -> Optional[np.ndarray]:
        """Decode PNG/PGM to float32 gray; None if format unsupported."""
        buf = np.empty((cap_h, cap_w), np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.decode_gray(
            path.encode(), _fptr(buf), cap_h, cap_w,
            ctypes.byref(h), ctypes.byref(w),
        )
        if rc != 0:
            return None
        return np.ascontiguousarray(buf[: h.value, : w.value])

    def remap_bilinear(self, img: np.ndarray, map_x: np.ndarray,
                       map_y: np.ndarray) -> np.ndarray:
        img = np.ascontiguousarray(img, np.float32)
        h, w = img.shape
        out = np.empty_like(img)
        self._lib.remap_bilinear(
            _fptr(img), h, w,
            _fptr(np.ascontiguousarray(map_x, np.float32)),
            _fptr(np.ascontiguousarray(map_y, np.float32)), _fptr(out),
        )
        return out


class StereoFeeder:
    """Prefetching decode+rectify pipeline over the native thread pool.

    Replaces the reference's synchronous per-frame imread/remap in the
    driver loop with lookahead decoding, so the tracker never waits on disk.
    Falls back to synchronous Python decode if the native lib is missing;
    ``native`` says which of the two runs.
    """

    def __init__(
        self,
        left_paths: List[str],
        right_paths: Optional[List[str]],
        height: int,
        width: int,
        maps_l=None,  # (map_x, map_y) or None
        maps_r=None,
        depth: int = 6,
        workers: int = 3,
    ):
        self.n = len(left_paths)
        self.h, self.w = height, width
        self._i = 0
        self._native = None
        self._handle = None
        self._paths = (left_paths, right_paths)
        self._maps = (maps_l, maps_r)
        try:
            self._native = load()
        except Exception:
            return
        LP = (ctypes.c_char_p * self.n)(*[p.encode() for p in left_paths])
        RP = None
        if right_paths is not None:
            RP = (ctypes.c_char_p * self.n)(*[p.encode() for p in right_paths])
        self._keep = (LP, RP)  # keep alive
        mlx = mly = mrx = mry = None
        if maps_l is not None:
            mlx = np.ascontiguousarray(maps_l[0], np.float32)
            mly = np.ascontiguousarray(maps_l[1], np.float32)
        if maps_r is not None:
            mrx = np.ascontiguousarray(maps_r[0], np.float32)
            mry = np.ascontiguousarray(maps_r[1], np.float32)
        self._keep_maps = (mlx, mly, mrx, mry)
        self._handle = self._native._lib.feeder_create(
            LP, RP, self.n, height, width,
            _fptr(mlx), _fptr(mly), _fptr(mrx), _fptr(mry), depth, workers,
        )

    @property
    def native(self) -> bool:
        """Whether the native thread pool decodes (else the Python path)."""
        return self._native is not None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            self.close()
            raise StopIteration
        self._i += 1
        if self._handle is not None:
            out_l = np.empty((self.h, self.w), np.float32)
            out_r = (
                np.empty((self.h, self.w), np.float32)
                if self._paths[1] is not None else None
            )
            rc = self._native._lib.feeder_next(
                self._handle, _fptr(out_l), _fptr(out_r)
            )
            if rc != 0:
                raise IOError(f"decode failed for frame {self._i - 1} rc={rc}")
            return out_l, out_r
        # fallback: synchronous python decode
        from orb_slam3_detailed_comments_kor_tpu_torch.io import datasets as ds

        i = self._i - 1
        left_paths, right_paths = self._paths
        maps_l, maps_r = self._maps
        img_l = ds.load_gray(left_paths[i])
        if maps_l is not None:
            img_l = ds.remap_bilinear(img_l, maps_l[0], maps_l[1])
        img_r = None
        if right_paths is not None:
            img_r = ds.load_gray(right_paths[i])
            if maps_r is not None:
                img_r = ds.remap_bilinear(img_r, maps_r[0], maps_r[1])
        return img_l, img_r

    def close(self):
        if self._handle is not None:
            self._native._lib.feeder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
