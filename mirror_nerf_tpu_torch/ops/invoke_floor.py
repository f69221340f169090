"""The launch floor: the two kernels of the TPU probe
`tools/exp_invoke_floor.py` (`kern` run as `small`, `kern_g` run as `grid`),
y = 1.000001·x + 1e-6 over fp32, as one hand-written kernel
(`csrc/invoke_floor.cu`, sm_90a; see its source note) in two launch shapes:

  * SMALL: the (8, 128) tensor in one CTA;
  * GRID: a (B, 1, L) tensor, one CTA per row (the probe's (128, 1, 4096)).

`axpb(x, out=None)` dispatches on the device of x: a CPU tensor takes the
plain version `axpb_reference`, a CUDA tensor launches the kernel through
`axpb_cuda` or raises (no fallback). `chain_cuda` launches a dependent chain
from C, with no Python between the launches: the bare floor the probe
compares the wrapper with. Launches are counted per shape in
`launches_small` and `launches_grid`, by the wrappers and by `chain_cuda`.

The wrapper launches through the port's launch path (`_build.Library`: one
fast check, the raw current stream, the device guard in C), so the probe's
"wrapper" column measures what every adopting wrapper pays. It takes the
current stream, allocates only when no `out` is given, and never
synchronises, so a chain of calls can be captured in a CUDA graph
(`tools/exp_invoke_floor.py`); the counters then move once, at capture, and
not on replay.

XLA contracts the JAX body into one fused multiply-add, so the kernel calls
`__fmaf_rn` and the plain version rounds once too (`fma32`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import Library, card_index, on_card

_LIB = "invoke_floor"
_REFUSALS = {-1: "the row length is not a positive multiple of 4",
             -2: "no rows", -3: "no launches"}
SCALE = np.float32(1.000001)
SHIFT = np.float32(1e-6)
SMALL_SHAPE = (8, 128)
GRID_SHAPE = (128, 1, 4096)

# kernel launches since import (or since a caller last reset them to 0)
launches_small = 0
launches_grid = 0


def _f64(v):
    """An fp32 tensor in float64, or a number rounded to fp32 first."""
    return v.double() if torch.is_tensor(v) else float(np.float32(v))


def fma32(x: torch.Tensor, scale, shift) -> torch.Tensor:
    """fp32 x·scale + shift rounded once, as a fused multiply-add, for any
    fp32 x on any device; scale and shift are numbers (rounded to fp32) or
    fp32 tensors that broadcast with x. The product of two floats is exact
    in float64; the float64 sum is made round-to-odd (its exact error from
    TwoSum; an inexact sum with an even last bit moves one ulp toward the
    exact value), after which the cast to fp32 rounds as one rounding
    would."""
    p = x.double() * _f64(scale)
    c = _f64(shift)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    nudge = (err != 0) & even & torch.isfinite(s)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def axpb_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: fp32 1.000001·x + 1e-6, one rounding (any
    device)."""
    return fma32(x, SCALE, SHIFT)


def _shape(x: torch.Tensor):
    """(rows, row length, is SMALL) of a tensor the kernel takes: SMALL for
    (8, 128), GRID for (B, 1, L) with L a multiple of 4."""
    if tuple(x.shape) == SMALL_SHAPE:
        return 1, x.numel(), True
    if x.dim() == 3 and x.shape[1] == 1 and x.shape[2] % 4 == 0 \
            and x.shape[0] * x.shape[2] > 0:
        return x.shape[0], x.shape[2], False
    raise ValueError(f"the floor kernel takes {SMALL_SHAPE} (SMALL) or "
                     f"(B, 1, L), L a multiple of 4 (GRID); got "
                     f"{tuple(x.shape)}")


# ---- the CUDA kernel (csrc/invoke_floor.cu) ----

# x, y, rows, row length (and a launch count for the chain); then the card
# and the stream (_build.Library)
_P, _I = ctypes.c_void_p, ctypes.c_int
_library = Library(_LIB, {"mnerf_floor_launch": [_P, _P, _I, _I],
                          "mnerf_floor_chain": [_P, _P, _I, _I, _I]},
                   _REFUSALS)
_F32 = (torch.float32,)


def _count(small: bool, n: int) -> None:
    global launches_small, launches_grid
    if small:
        launches_small += n
    else:
        launches_grid += n


def _cuda_pair(a: torch.Tensor, b: torch.Tensor):
    """Checks shared by the entries: two distinct contiguous, 16-B aligned
    CUDA float32 tensors of one shape the kernel takes, on one card.
    Returns (card index, rows, row length, is SMALL)."""
    dev = card_index("floor", ("x", a, _F32, 16), ("out", b, _F32, 16))
    if a.shape != b.shape:
        raise ValueError(f"x and out differ: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.data_ptr() == b.data_ptr():
        raise ValueError("out must not be x")
    return (dev, *_shape(a))


def axpb_cuda(x: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """One launch on the current stream: out = 1.000001·x + 1e-6 (a new
    tensor unless `out` is given; it must not be x)."""
    if out is None:
        out = torch.empty_like(x)
    dev, rows, row_len, small = _cuda_pair(x, out)
    _library.launch("mnerf_floor_launch", "floor", dev, x.data_ptr(),
                    out.data_ptr(), rows, row_len)
    _count(small, 1)
    return out


def chain_cuda(a: torch.Tensor, b: torch.Tensor, launches: int
               ) -> torch.Tensor:
    """`launches` dependent launches a → b → a → … looped in C on the
    current stream (each reads what the previous one wrote; a is
    overwritten after the second). Returns the tensor holding the last
    result."""
    dev, rows, row_len, small = _cuda_pair(a, b)
    _library.launch("mnerf_floor_chain", "floor", dev, a.data_ptr(),
                    b.data_ptr(), rows, row_len, int(launches))
    _count(small, int(launches))
    return b if launches % 2 else a


def axpb(x: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """1.000001·x + 1e-6 for fp32 x of the SMALL or GRID shape. CPU tensors
    take the plain version, CUDA tensors the kernel."""
    if x.is_cuda or on_card("floor", x, *(() if out is None else (out,))):
        return axpb_cuda(x, out)  # raises for an `out` on another device
    _shape(x)
    y = axpb_reference(x)
    return y if out is None else out.copy_(y)
