"""Build and load the port's CUDA kernels: nvcc compiles each `csrc/*.cu`
into a shared library with a plain C interface, loaded with ctypes.

The build runs at first use, from the sources in this checkout only, into
`build/kernels/` at the repository root (listed in .gitignore). The library
name carries a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source is rebuilt and a stale library is never loaded.

The launch path (`Library`, `card_index`) is what every launch of a
wrapper that adopted it pays on the host: one fast test of its inputs (the
detailed message is built only when it fails), the raw handle of the current
stream of the inputs' card, and one ctypes call into a C entry that makes
that card current only when it is not and restores the caller's device
after the launch (`csrc/launch.cuh`). No Python context manager, no Stream
object.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> seconds of the nvcc run (0.0 when the first load found the library)
build_seconds: dict = {}
build_log: dict = {}  # name -> nvcc output (ptxas registers / spills)


def cuda_tool(tool: str) -> str:
    """A tool of the CUDA toolkit that holds nvcc (`cuobjdump`, ...)."""
    return str(Path(_nvcc()).parent / tool)


def sass_counts(so_path, match: str,
                opcodes=("HMMA", "FFMA", "LDS", "LDG", "LDL", "STL")) -> dict:
    """Each function of a built library whose name holds `match` -> how
    many instructions of each opcode its machine code (cuobjdump -sass)
    holds; LDL and STL are local-memory traffic (spills)."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(so_path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.splitlines()[0].strip()
        if match in name:
            out[name] = {op: len(re.findall(rf"\b{op}\b", f))
                         for op in opcodes}
    return out


def ptxas_by_function(log: str, match: str = "") -> dict:
    """nvcc's `-Xptxas -v` output -> each compiled function whose name holds
    `match`: "<registers>; <spills>" (ptxas' own words)."""
    out, name, spills = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill" in ln:
            spills = ln.split(":", 1)[-1].strip()
        elif name and "registers" in ln and match in name:
            out[name] = ln.split(":", 1)[-1].strip() + "; " + spills
    return out


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


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: the name carries a hash of the
    source, the shared headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library.
    Callers keep the handle: each call hashes the source again."""
    src = CSRC / f"{name}.cu"
    so = library_path(name)
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
    for CPU tensors; raises for another device or a mix. The wrappers on the
    launch path ask `x.is_cuda` first and call this only off the card: their
    `card_index` refuses a mix on the card."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} path for device {dev}")
    return dev.type == "cuda"


def card_index(what: str, *checks) -> int:
    """The index of the card a launch runs on. Each check is (name, tensor,
    dtypes, alignment in bytes): the tensor must be a contiguous CUDA tensor
    of one of `dtypes` whose data starts at a multiple of the alignment, all
    on one card. One fast pass; when any check fails, raises ValueError
    naming every check that failed ("... needs CUDA tensors", "... on
    several devices", the dtype, contiguity, alignment)."""
    dev = checks[0][1].get_device()
    for _, t, dtypes, align in checks:
        if t.get_device() != dev or t.dtype not in dtypes \
                or not t.is_contiguous() or t.data_ptr() % align:
            break
    else:
        if dev >= 0:
            return dev
    raise ValueError(refusal(what, checks))


def refusal(what: str, checks) -> str:
    """The message of a failed `card_index`: every check that failed."""
    faults = []
    off = [f"{name} on {t.device}" for name, t, _, _ in checks
           if not t.is_cuda]
    if off:
        faults.append(f"the {what} kernel needs CUDA tensors, got "
                      + ", ".join(off))
    devs = {t.device for _, t, _, _ in checks}
    if len(devs) > 1:
        faults.append(f"inputs on several devices {devs}")
    for name, t, dtypes, align in checks:
        if t.dtype not in dtypes:
            faults.append(f"{name}: need "
                          f"{' or '.join(str(d) for d in dtypes)}, got "
                          f"{t.dtype}")
        if not t.is_contiguous():
            faults.append(f"{name}: need a contiguous tensor")
        elif t.data_ptr() % align:
            faults.append(f"{name}: need {align}-B aligned data")
    return f"{what}: " + "; ".join(faults)


_raw_stream = None  # torch._C._cuda_getCurrentRawStream, bound at first use


def current_stream(device: int) -> int:
    """The raw handle (cudaStream_t as an int) of the current stream of the
    card `device`: the stream a side-stream context or a CUDA-graph capture
    made current, the handle PyTorch's current-stream object holds,
    without building a Stream object (Triton's launcher reads it the same
    way)."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(device)


class Library:
    """A kernel library on the launch path: `csrc/<name>.cu`, built and
    loaded at the first call. `entries` maps each C entry to the ctypes
    types of its arguments before the two every entry takes last, the
    card's index and the stream (csrc/launch.cuh). An entry returns 0, a
    negative code for arguments it refused (`refusals` maps each to a
    message) or the cudaError_t of the launch."""

    def __init__(self, name: str, entries: dict, refusals: dict):
        self.name = name
        self.entries = {symbol: [*types, ctypes.c_int, ctypes.c_void_p]
                        for symbol, types in entries.items()}
        self.refusals = refusals
        self._lib = None
        self._fns = {}  # symbol -> the ctypes entry

    def __call__(self) -> ctypes.CDLL:
        """The loaded library (built at the first call)."""
        if self._lib is None:
            lib = load_library(self.name)
            for symbol, types in self.entries.items():
                fn = getattr(lib, symbol)
                fn.argtypes = types
                fn.restype = ctypes.c_int
                self._fns[symbol] = fn
            lib.mnerf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mnerf_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def entry(self, symbol: str):
        """The ctypes entry: a bare call is `fn(*args, device, stream)`."""
        self()
        return self._fns[symbol]

    def launch(self, symbol: str, what: str, device: int, *args) -> None:
        """One call of the C entry `symbol` on the current stream of card
        `device`; raises for a refusal or a failed launch."""
        fn = self._fns.get(symbol) or self.entry(symbol)
        rc = fn(*args, device, (_raw_stream or current_stream)(device))
        if rc:
            check_rc(self._lib, rc, what, self.refusals)


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
