"""Segmented exclusive prefix sums over 128-wide fp32 rows (torch
counterpart of the TPU probe kernel `kernel_reshape`,
`tools/exp_reshape_probe.py:35`, and of `_prefix_weights`,
`mirror_nerf_tpu/ops/pallas/fused_mlp_t.py:108`), as one hand-written kernel
(`csrc/segment_scan.cu`, sm_90a; see its source note) in three modes:

  * `segment_prefix(x, s, mode)`: out[…, i] = Σ_{j < i, same segment}
    x[…, j], segments of s values (s a power of two dividing 128) along the
    flattened tensor, whose size is a multiple of 128. mode "scan" (a warp
    per row, lane scans combined with shuffles) or "tri" (the TPU's
    formulation: each row times the strictly lower block-diagonal TRI, on
    the tensor cores in bf16 with x split into three bf16 pieces, fp32
    sums);
  * `prefix_weights(sd, s)` (WEIGHTS): the compositing weights
    w = exp(−prefix)·(1 − exp(−sd)) per segment (a segment is a ray), the
    scan with an epilogue.

Each dispatches on the device of its input: a CPU tensor takes the plain
version (`segment_prefix_reference`, `prefix_weights_reference`), a CUDA
tensor launches the kernel or raises (no fallback). Launches are counted
per mode in `launches_scan`, `launches_tri` and `launches_weights`. The
launch goes through `_build.Library` (one fast check, the raw current
stream, the device guard in C).

The prefix is exclusive by construction everywhere, never the inclusive sum
minus the value: a ray's last sd carries δ_inf = 1e10, and fp32
(1e10 + prefix) − 1e10 cancels the whole prefix. The plain version is a
cumsum shifted by one with a zero at each segment start (the JAX probe's own
oracle, cumsum − x, is the trap).

`split3` and `segment_prefix_split_reference` are TRI's arithmetic in plain
PyTorch (the tests hold them to float64 and to the JAX probe's kernel): the
three bf16 pieces of x, each multiplied by TRI, summed in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Library, card_index, on_card

_LIB = "segment_scan"
_REFUSALS = {-1: "the segment length is not a power of two in [1, 128]",
             -2: "no rows", -3: "an unknown mode"}
ROW = 128
# the kernel's modes (`Mode` in the .cu)
MODES = {"scan": 0, "tri": 1, "weights": 2}
_PREFIX_MODES = ("scan", "tri")

# kernel launches since import (or since a caller last reset them to 0)
launches_scan = 0
launches_tri = 0
launches_weights = 0


def _rows(x: torch.Tensor, s: int) -> int:
    """The count of 128-wide rows of x; raises for a segment length or a
    size the kernel does not take (the plain version keeps the contract)."""
    if s < 1 or ROW % s:
        raise ValueError(f"the segment length {s} does not divide {ROW}")
    if x.numel() == 0 or x.numel() % ROW:
        raise ValueError(f"need a positive multiple of {ROW} values, got "
                         f"{tuple(x.shape)}")
    return x.numel() // ROW


def segment_prefix_reference(x: torch.Tensor, s: int) -> torch.Tensor:
    """The plain version: per segment of s values, the cumsum shifted by one
    with a zero at the segment's start (any device)."""
    _rows(x, s)
    xs = x.reshape(-1, s)
    return torch.cat([torch.zeros_like(xs[:, :1]),
                      torch.cumsum(xs[:, :-1], dim=-1)], dim=-1
                     ).reshape(x.shape)


def split3(x: torch.Tensor):
    """x (fp32) as three bf16 pieces whose fp32 sum is x exactly: hi =
    bf16(x), mid = bf16(x − hi), lo = bf16(x − hi − mid), each rounded to
    nearest even and each difference exact in fp32 (TRI's split). hi and mid
    are the JAX package's two-piece `_mm_hilo_lhs` split."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def segment_prefix_split_reference(x: torch.Tensor, s: int) -> torch.Tensor:
    """TRI's arithmetic in plain PyTorch (any device): per segment of s,
    (lo·T + mid·T) + hi·T with T[j, i] = 1 for j < i, every product exact
    and the sums in fp32 (in the CPU's order, not the tensor cores')."""
    _rows(x, s)
    tri = torch.triu(torch.ones((s, s), dtype=torch.float32,
                                device=x.device), diagonal=1)
    hi, mid, lo = (p.float().reshape(-1, s) for p in split3(x))
    return ((lo @ tri + mid @ tri) + hi @ tri).reshape(x.shape)


_LOG2_E = 1.4426950408889634  # float64 log2(e)


def exp_plain(x: torch.Tensor) -> torch.Tensor:
    """exp(x) in x's type, for the plain versions. A CUDA tensor takes
    torch.exp. On the CPU, torch.exp hands fp32 and float64 tensors to MKL's
    VML (vmsExp / vmdExp) on torch's OpenMP threads, and the first fp32 call
    in a process sometimes returns one thread's share of the values (4096
    of 32768) with relative errors up to 1.5e-4: a fault in that library,
    not in the port. So the CPU path evaluates exp2(x·log2 e) in float64,
    which torch computes with its own vectorised (SLEEF) kernel and no MKL,
    and rounds once to x's type: within an ulp of exp in fp32 for any
    input."""
    if x.is_cuda:
        return torch.exp(x)
    return torch.exp2(x.double() * _LOG2_E).to(x.dtype)


def prefix_weights_reference(sd: torch.Tensor, s: int) -> torch.Tensor:
    """The plain version of WEIGHTS (any device): exp(−prefix)·(1 −
    exp(−sd)), `ops/fused_cp.py prefix_weights` per segment of s; the
    exponentials by `exp_plain`."""
    return exp_plain(-segment_prefix_reference(sd, s)) * (
        1.0 - exp_plain(-sd))


# ---- the CUDA kernel (csrc/segment_scan.cu) ----

# x, out, rows, seg, mode (then the card and the stream: _build.Library)
_library = Library(_LIB, {"mnerf_segment_scan": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int]}, _REFUSALS)
_F32 = (torch.float32,)


def _launch(x: torch.Tensor, s: int, mode: int) -> torch.Tensor:
    """One launch of `mode` (a `MODES` value) on the current stream; returns
    the output."""
    global launches_scan, launches_tri, launches_weights
    dev = card_index("segment-scan", ("x", x, _F32, 16))
    rows = _rows(x, s)
    out = torch.empty_like(x)
    _library.launch("mnerf_segment_scan", "segment-scan", dev, x.data_ptr(),
                    out.data_ptr(), rows, s, mode)
    if mode == 0:
        launches_scan += 1
    elif mode == 1:
        launches_tri += 1
    else:
        launches_weights += 1
    return out


def segment_prefix_cuda(x: torch.Tensor, s: int,
                        mode: str = "scan") -> torch.Tensor:
    """SCAN or TRI: launch the kernel (raises for anything it does not
    take)."""
    if mode not in _PREFIX_MODES:
        raise ValueError(f"mode is 'scan' or 'tri', got {mode!r}")
    return _launch(x, s, MODES[mode])


def prefix_weights_cuda(sd: torch.Tensor, s: int) -> torch.Tensor:
    """WEIGHTS: launch the kernel."""
    return _launch(sd, s, MODES["weights"])


def segment_prefix(x: torch.Tensor, s: int,
                   mode: str = "scan") -> torch.Tensor:
    """The per-segment exclusive prefix. CPU tensors take the plain version,
    CUDA tensors the kernel's SCAN or TRI mode."""
    if mode not in _PREFIX_MODES:
        raise ValueError(f"mode is 'scan' or 'tri', got {mode!r}")
    if x.is_cuda or on_card("segment prefix", x):
        return _launch(x, s, MODES[mode])
    return segment_prefix_reference(x, s)


def prefix_weights(sd: torch.Tensor, s: int) -> torch.Tensor:
    """Compositing weights per segment of s. CPU tensors take the plain
    version, CUDA tensors the kernel's WEIGHTS mode."""
    if sd.is_cuda or on_card("prefix weights", sd):
        return _launch(sd, s, MODES["weights"])
    return prefix_weights_reference(sd, s)
