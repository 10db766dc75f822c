"""ctypes bindings for the native CPU spread/interp engine.

The shared library is built on demand from ``cc/nufft_cpu.cc`` (the
environment guarantees g++; pybind11 is unavailable, so the C ABI +
ctypes is used). The reference ships its native code as a prebuilt TF op
library (tools/build); here the engine is an optional accelerator with a
pure-JAX fallback, so lazy compilation is acceptable and keeps the
package source-only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _REPO_ROOT / "cc" / "nufft_cpu.cc"
_BUILD_DIR = pathlib.Path(
    os.environ.get("TFFT_BUILD_DIR",
                   str(_REPO_ROOT / "build"))).resolve()
_CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
              "-std=c++17"]


def _lib_path() -> pathlib.Path:
    """Cache key = source content hash + host arch + flags: a binary
    built with -march=native on another CPU (or from older source with a
    newer mtime) must never be loaded — it could SIGILL or be stale."""
    tag = hashlib.sha256(
        _SOURCE.read_bytes()
        + platform.machine().encode()
        + platform.processor().encode()
        + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libtfft_cpu_{tag}.so"


def _build() -> pathlib.Path:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _lib_path()
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def _load():
    with _LOCK:
        lib = ctypes.CDLL(str(_build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    for suffix, fp in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fpp = ctypes.POINTER(fp)
        for op in ("spread", "interp"):
            fn = getattr(lib, f"tfft_{op}_{suffix}")
            fn.restype = None
            fn.argtypes = [
                ctypes.c_int, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_double, ctypes.c_int,
                f64p, fpp, fpp,       # points are always double
            ]
    lib.tfft_num_threads.restype = ctypes.c_int
    lib.tfft_num_threads.argtypes = []
    return lib


def available() -> bool:
    """True if the native engine can be built/loaded on this host."""
    try:
        _load()
        return True
    except Exception:
        return False


def _as_interleaved(arr: np.ndarray, real_dt) -> np.ndarray:
    """complex array -> contiguous interleaved real view/copy."""
    c_dt = np.complex64 if real_dt == np.float32 else np.complex128
    arr = np.ascontiguousarray(arr, dtype=c_dt)
    return arr.view(real_dt)


def _ptr(arr: np.ndarray, fp):
    return arr.ctypes.data_as(ctypes.POINTER(fp))


def spread(strengths: np.ndarray, points_resc: np.ndarray,
           fine_shape, width: int, beta: float,
           num_threads: int = 0) -> np.ndarray:
    """[batch, M] complex strengths + [M, rank] rescaled points ->
    [batch, *fine_shape] complex fine grid."""
    _check_width(width)
    rank = points_resc.shape[-1]
    num_points = points_resc.shape[0]
    batch = strengths.shape[0]
    real_dt = np.float32 if strengths.dtype == np.complex64 \
        else np.float64
    fp = ctypes.c_float if real_dt == np.float32 else ctypes.c_double
    lib = _load()
    fn = lib.tfft_spread_f32 if real_dt == np.float32 \
        else lib.tfft_spread_f64

    pts = np.ascontiguousarray(points_resc, dtype=np.float64)
    s = _as_interleaved(strengths.reshape(batch, num_points), real_dt)
    fine = np.zeros((batch,) + tuple(fine_shape) + (2,), dtype=real_dt)
    dims = np.asarray(fine_shape, dtype=np.int64)
    fn(rank, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       num_points, batch, width, float(beta), num_threads,
       _ptr(pts, ctypes.c_double), _ptr(s, fp), _ptr(fine, fp))
    c_dt = np.complex64 if real_dt == np.float32 else np.complex128
    return fine.view(c_dt)[..., 0]


def _check_width(width: int) -> None:
    """The C engine's kernel buffers are sized for MAX_KERNEL_WIDTH=16
    (cc/nufft_cpu.cc); a wider width at this FFI boundary would be a
    stack buffer overflow, so validate here."""
    if not 1 <= int(width) <= 16:
        raise ValueError(
            f"native engine supports kernel widths 1..16, got {width}")


def interp(fine: np.ndarray, points_resc: np.ndarray, width: int,
           beta: float, num_threads: int = 0) -> np.ndarray:
    """[batch, *fine_shape] complex grid + [M, rank] rescaled points ->
    [batch, M] complex values."""
    _check_width(width)
    rank = points_resc.shape[-1]
    num_points = points_resc.shape[0]
    batch = fine.shape[0]
    fine_shape = fine.shape[1:]
    real_dt = np.float32 if fine.dtype == np.complex64 else np.float64
    fp = ctypes.c_float if real_dt == np.float32 else ctypes.c_double
    lib = _load()
    fn = lib.tfft_interp_f32 if real_dt == np.float32 \
        else lib.tfft_interp_f64

    pts = np.ascontiguousarray(points_resc, dtype=np.float64)
    f = _as_interleaved(fine, real_dt)
    vals = np.zeros((batch, num_points, 2), dtype=real_dt)
    dims = np.asarray(fine_shape, dtype=np.int64)
    fn(rank, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       num_points, batch, width, float(beta), num_threads,
       _ptr(pts, ctypes.c_double), _ptr(f, fp), _ptr(vals, fp))
    c_dt = np.complex64 if real_dt == np.float32 else np.complex128
    return vals.view(c_dt)[..., 0]
