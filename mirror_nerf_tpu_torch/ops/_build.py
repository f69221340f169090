"""Build and load the port's CUDA kernels: nvcc compiles each `csrc/*.cu`
into a shared library with a plain C interface, loaded with ctypes.

The build runs at first use, from the sources in this checkout only, into
`build/kernels/` at the repository root (listed in .gitignore). The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> seconds of the nvcc run (0.0 when the first load found the library)
build_seconds: dict = {}
build_log: dict = {}  # name -> nvcc output (ptxas registers / spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built at first use and need the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library.
    Callers keep the handle: each call hashes the source again."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if so.exists():
        build_seconds.setdefault(name, 0.0)
    else:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stdout + proc.stderr
    return ctypes.CDLL(str(so))


def on_card(what: str, *tensors) -> bool:
    """Dispatch of a wrapper: True for CUDA tensors (all on one card), False
    for CPU tensors; raises for another device or a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} path for device {dev}")
    return dev.type == "cuda"


def check_rc(lib: ctypes.CDLL, rc: int, what: str, refusals: dict) -> None:
    """A kernel entry's return code: 0 is a launch, a negative code an
    argument the kernel refused (`refusals` maps it to a message), a
    positive one the cudaError_t of the launch."""
    if rc < 0:
        raise ValueError(f"{what} kernel refused its arguments: "
                         f"{refusals.get(rc, rc)}")
    if rc > 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.mnerf_cuda_error_string(rc).decode())


def build_libraries(names) -> dict:
    """Build (if needed) and load several libraries at once, one nvcc
    process each; returns name -> ctypes library."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
