"""ctypes bindings for the native host data-path library (torch package's
counterpart of `mirror_nerf_tpu/native.py`): ray generation, batch
gathering and RGBA blending over multithreaded C++ (`native/src/raygen.cpp`).

The library is built at first use from that source with the flags of
`native/Makefile` (g++ -O3 -std=c++17 -fPIC -shared -pthread) into
`build/native/` at the repository root (listed in .gitignore), its file
name keyed by a hash of the source and the flags, so an edited source is
rebuilt; the build writes a temporary file and renames it, so concurrent
processes never load a half-written library. Without a compiler every
binding falls back to its numpy version (`core/rays.py`, the JAX package's
fallbacks), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "src" / "raygen.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmnerf_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """The loaded native library, or None if it cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.mn_generate_rays.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, f32p, ctypes.c_int]
        lib.mn_gather_batch.argtypes = [
            f32p, f32p, f32p, i64p, ctypes.c_int64, f32p, f32p, f32p,
            ctypes.c_int]
        lib.mn_blend_rgba.argtypes = [
            u8p, ctypes.c_int64, f32p, u8p, ctypes.c_int]
        lib.mn_shuffle_indices.argtypes = [i64p, ctypes.c_int64,
                                           ctypes.c_uint64]
        _LIB = lib
        return _LIB


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def generate_rays(c2w: np.ndarray, H: int, W: int, focal: float, near: float,
                  far: float, n_threads: int = 0) -> np.ndarray:
    """(H*W, 8) ray buffer [o, d, near, far]; the native multithreaded path,
    or numpy without the library."""
    lib = get_lib()
    if lib is None:
        from .core.rays import get_ray_directions, get_rays, make_ray_buffer

        dirs = get_ray_directions(H, W, focal)
        o, d = get_rays(dirs, np.asarray(c2w, np.float32))
        return make_ray_buffer(o, d, near, far)
    c2w = np.ascontiguousarray(np.asarray(c2w, np.float32)[:3, :4])
    out = np.empty((H * W, 8), np.float32)
    lib.mn_generate_rays(_fp(c2w), H, W, float(focal), float(near),
                         float(far), _fp(out), n_threads)
    return out


def gather_batch(rays: np.ndarray, rgbs: np.ndarray, masks: np.ndarray,
                 idx: np.ndarray, n_threads: int = 0):
    """(rays[idx], rgbs[idx], masks[idx]); the native path if available."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return rays[idx], rgbs[idx], masks[idx]
    k = len(idx)
    out_r = np.empty((k, 8), np.float32)
    out_c = np.empty((k, 3), np.float32)
    out_m = np.empty((k,), np.float32)
    lib.mn_gather_batch(
        _fp(np.ascontiguousarray(rays, np.float32)),
        _fp(np.ascontiguousarray(rgbs, np.float32)),
        _fp(np.ascontiguousarray(masks, np.float32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), k,
        _fp(out_r), _fp(out_c), _fp(out_m), n_threads)
    return out_r, out_c, out_m


def blend_rgba(img: np.ndarray, n_threads: int = 0):
    """(N, 4) uint8 RGBA -> ((N, 3) float rgb blended on white, (N,) bool
    alpha > 0)."""
    lib = get_lib()
    img = np.ascontiguousarray(img.reshape(-1, 4), np.uint8)
    if lib is None:
        f = img.astype(np.float32) / 255.0
        rgb = f[:, :3] * f[:, 3:4] + (1.0 - f[:, 3:4])
        return rgb, img[:, 3] > 0
    n = img.shape[0]
    rgb = np.empty((n, 3), np.float32)
    valid = np.empty((n,), np.uint8)
    lib.mn_blend_rgba(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
                      _fp(rgb), valid.ctypes.data_as(
                          ctypes.POINTER(ctypes.c_uint8)), n_threads)
    return rgb, valid.astype(bool)
