"""ctypes bindings for the native C++ IO runtime (the port's copy of
vloam_tpu/runtime/native_io.py; builds with g++ on first use into
runtime/native/build/ beside the source).

The host-side data path (velodyne .bin parsing, projection to quantized
range images, threaded prefetch) stays native C++, as in the reference;
load_velodyne_bin (data/kitti.py) falls back to numpy when no compiler is
available, and available() says which of the two runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "native" / "kitti_io.cpp"
_BUILD = _HERE / "native" / "build"
_SO = _BUILD / "libvloam_io.so"
_lock = threading.Lock()
_lib = None


def _build() -> Path:
    """Compile into a private file, then rename it into place: processes
    that build at once (test workers) never load a half-written library."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f".{_SO.name}.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:  # built for another machine's libraries: rebuild
            _build()
            lib = ctypes.CDLL(str(_SO))
        lib.vloam_load_bin.restype = ctypes.c_int
        lib.vloam_load_bin.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int]
        lib.vloam_loader_create.restype = ctypes.c_void_p
        lib.vloam_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vloam_loader_next.restype = ctypes.c_int
        lib.vloam_loader_next.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_float)]
        lib.vloam_loader_destroy.restype = None
        lib.vloam_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.vloam_project_polar.restype = ctypes.c_int
        lib.vloam_project_polar.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ]
        lib.vloam_polar_loader_create.restype = ctypes.c_void_p
        lib.vloam_polar_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ]
        lib.vloam_polar_loader_next.restype = ctypes.c_int
        lib.vloam_polar_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16)]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library builds and loads here (else the loaders
    of data/kitti.py that have one take their numpy fallback)."""
    try:
        get_lib()
    except Exception:
        return False
    return True


def load_bin_native(path: str, max_pts: int = 200000) -> np.ndarray:
    lib = get_lib()
    out = np.empty((max_pts, 3), np.float32)
    n = lib.vloam_load_bin(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pts)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n].copy()


class PrefetchLoader:
    """Threaded read-ahead over a list of .bin files, emitting padded
    [max_pts, 3] frames in order."""

    def __init__(self, paths: list[str], max_pts: int, n_threads: int = 2):
        self.lib = get_lib()
        self.max_pts = max_pts
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self.handle = self.lib.vloam_loader_create(arr, len(self._paths),
                                                   max_pts, n_threads)
        self.n = len(paths)

    def __iter__(self):
        return self

    def __next__(self):
        out = np.empty((self.max_pts, 3), np.float32)
        cnt = self.lib.vloam_loader_next(
            self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if cnt == -2:
            raise StopIteration
        if cnt < 0:
            raise IOError("loader failure")
        return out, cnt

    def close(self):
        if self.handle:
            self.lib.vloam_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def project_polar_native(path: str, n_scans: int = 64, n_az: int = 1800,
                         range_scale: float = 0.005,
                         min_range: float = 0.0) -> np.ndarray:
    """Project one velodyne .bin to a quantized [n_scans, n_az] uint16 range
    image in native code (ring/azimuth formulas match the device decode)."""
    lib = get_lib()
    out = np.empty((n_scans, n_az), np.uint16)
    n = lib.vloam_project_polar(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n_scans, n_az, range_scale, min_range)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out


class PolarPrefetchLoader:
    """Threaded read-ahead emitting quantized range images in order (the
    native front half of the polar ingest path; LoamEngine.push_polar is
    the device half)."""

    def __init__(self, paths: list[str], n_scans: int = 64, n_az: int = 1800,
                 range_scale: float = 0.005, min_range: float = 0.0,
                 n_threads: int = 2):
        self.lib = get_lib()
        self.n_scans, self.n_az = n_scans, n_az
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self.handle = self.lib.vloam_polar_loader_create(
            arr, len(self._paths), n_scans, n_az, range_scale, min_range,
            n_threads)
        self.n = len(paths)

    def __iter__(self):
        return self

    def __next__(self):
        out = np.empty((self.n_scans, self.n_az), np.uint16)
        cnt = self.lib.vloam_polar_loader_next(
            self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if cnt == -2:
            raise StopIteration
        if cnt < 0:
            raise IOError("loader failure")
        return out, cnt

    def close(self):
        if self.handle:
            self.lib.vloam_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
