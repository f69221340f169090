"""Segmented exclusive prefix sums over 128-wide fp32 rows (torch
counterpart of the TPU probe kernel `kernel_reshape`,
`tools/exp_reshape_probe.py:35`, and of `_prefix_weights`,
`mirror_nerf_tpu/ops/pallas/fused_mlp_t.py:108`), as one hand-written kernel
(`csrc/segment_scan.cu`, sm_90a; see its source note) in three modes:

  * `segment_prefix(x, s, mode)`: out[…, i] = Σ_{j < i, same segment}
    x[…, j], segments of s values (s a power of two dividing 128) along the
    flattened tensor, whose size is a multiple of 128. mode "scan" (a warp
    per row, lane scans combined with shuffles) or "tri" (the TPU's
    formulation: each row times the strictly lower block-diagonal TRI, fp32
    FMAs);
  * `prefix_weights(sd, s)` (WEIGHTS): the compositing weights
    w = exp(−prefix)·(1 − exp(−sd)) per segment (a segment is a ray), the
    scan with an epilogue.

Each dispatches on the device of its input: a CPU tensor takes the plain
version (`segment_prefix_reference`, `prefix_weights_reference`), a CUDA
tensor launches the kernel or raises (no fallback). Launches are counted
per mode in `launches_scan`, `launches_tri` and `launches_weights`.

The prefix is exclusive by construction everywhere, never the inclusive sum
minus the value: a ray's last sd carries δ_inf = 1e10, and fp32
(1e10 + prefix) − 1e10 cancels the whole prefix. The plain version is a
cumsum shifted by one with a zero at each segment start (the JAX probe's own
oracle, cumsum − x, is the trap).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_rc, on_card

_LIB = "segment_scan"
_REFUSALS = {-1: "the segment length is not a power of two in [1, 128]",
             -2: "no rows", -3: "an unknown mode"}
ROW = 128
# the kernel's modes (`Mode` in the .cu)
MODES = {"scan": 0, "tri": 1, "weights": 2}

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


def prefix_weights_reference(sd: torch.Tensor, s: int) -> torch.Tensor:
    """The plain version of WEIGHTS (any device): exp(−prefix)·(1 −
    exp(−sd)), `ops/fused_cp.py prefix_weights` per segment of s."""
    return torch.exp(-segment_prefix_reference(sd, s)) * (1.0
                                                          - torch.exp(-sd))


# ---- the CUDA kernel (csrc/segment_scan.cu) ----

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library(_LIB)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mnerf_segment_scan.argtypes = [p, p, ll, i, i, p]
        lib.mnerf_segment_scan.restype = i
        lib.mnerf_cuda_error_string.argtypes = [i]
        lib.mnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x: torch.Tensor, s: int, mode: str) -> torch.Tensor:
    """One launch of `mode` on the current stream; returns the output."""
    global launches_scan, launches_tri, launches_weights
    if x.device.type != "cuda":
        raise ValueError(f"the segment-scan kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"need a contiguous, 16-B aligned float32 tensor, "
                         f"got {x.dtype} (contiguous={x.is_contiguous()})")
    rows = _rows(x, s)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _library().mnerf_segment_scan(
            x.data_ptr(), out.data_ptr(), rows, s, MODES[mode],
            torch.cuda.current_stream(x.device).cuda_stream)
    check_rc(_library(), rc, f"segment-scan {mode.upper()}", _REFUSALS)
    if mode == "scan":
        launches_scan += 1
    elif mode == "tri":
        launches_tri += 1
    else:
        launches_weights += 1
    return out


def segment_prefix_cuda(x: torch.Tensor, s: int,
                        mode: str = "scan") -> torch.Tensor:
    """SCAN or TRI: launch the kernel (raises for anything it does not
    take)."""
    if mode not in ("scan", "tri"):
        raise ValueError(f"mode is 'scan' or 'tri', got {mode!r}")
    return _launch(x, s, mode)


def prefix_weights_cuda(sd: torch.Tensor, s: int) -> torch.Tensor:
    """WEIGHTS: launch the kernel."""
    return _launch(sd, s, "weights")


def segment_prefix(x: torch.Tensor, s: int,
                   mode: str = "scan") -> torch.Tensor:
    """The per-segment exclusive prefix. CPU tensors take the plain version,
    CUDA tensors the kernel's SCAN or TRI mode."""
    if mode not in ("scan", "tri"):
        raise ValueError(f"mode is 'scan' or 'tri', got {mode!r}")
    if on_card("segment prefix", x):
        return _launch(x, s, mode)
    return segment_prefix_reference(x, s)


def prefix_weights(sd: torch.Tensor, s: int) -> torch.Tensor:
    """Compositing weights per segment of s. CPU tensors take the plain
    version, CUDA tensors the kernel's WEIGHTS mode."""
    if on_card("prefix weights", sd):
        return prefix_weights_cuda(sd, s)
    return prefix_weights_reference(sd, s)
