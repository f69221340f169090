"""The roof and the operation counts every share of a peak is taken against.

A share of a roofline or of a peak is the least time the chip could take for
the work, divided by the measured time. The least time is the larger of the
operations over 989 TFLOP/s (an H100 SXM's dense bf16 / fp16 rate: no route
that passes an fp32 check computes faster, bf16×3, 3×TF32 and int8 slicing
all stay below it) and the bytes over 3.35 TB/s (its HBM3 rate). A
multiply-add counts 2 operations, scalar work 1 each, on the same roof;
each input byte is read once and each output byte written once.

The per-sample counts are frozen copies of the counts the port's bring-up
used beside its kernels (`chip_smoke.py`: `MLP_MACS`, `_cp_flop`,
`_hash_flop`); `tf32x3_seconds` gives the figure those bring-up tables
compare against (3 TF32 products over the 495 TFLOP/s TF32 rate), printed
beside a share and never reported as one.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # operations/s: dense bf16 / fp16 tensor cores, 700 W
PEAK_BYTES = 3.35e12  # bytes/s: HBM3
PEAK_TF32 = 495e12  # dense TF32 tensor cores: the 3×TF32 figure only

# multiply-adds a sample of the flagship PE-MLP: trunk 63·256 + 6·256² +
# 319·256 and σ 256 (σ-only); + xyz_final 256², dir_enc 283·128, rgb 128·3,
# normal 256·128 + 128·3, mirror 256·128 + 128 (full)
MLP_MACS = {True: 491_264, False: 659_456}


def cp_flop(sum_r: int, full: bool) -> tuple:
    """Operations a sample of the CP / NGP composite's nets, (products,
    the rest): the fold of the rank products into 32 features (32
    multiply-adds a rank), the σ-net 32→64→16 and, in the full variant,
    color 31→64→64→3, normal 15→64→3 and mirror 15→32→1; the rest is per
    rank three lerps (3 each) and the three-axis product (2)."""
    mm = sum_r * 2 * 32 + 2 * (32 * 64 + 64 * 16)
    if full:
        mm += 2 * (31 * 64 + 64 * 64 + 64 * 3 + 15 * 64 + 64 * 3 + 15 * 32
                   + 32)
    return mm, sum_r * (9 + 2)


def hash_flop(c: int = 2) -> int:
    """Operations a (point, level) of the hash-grid lookup: position 3
    multiply-adds, floor and fraction (6), 1 − t (3), eight corner weights
    of two multiplies, eight corner rows of C multiply-adds; the integer
    index work is not counted."""
    return 6 + 6 + 3 + 8 * 2 + 8 * c * 2


def mlp_sample_flop(sigma_only: bool) -> int:
    """Operations a sample of the flagship's field (products only)."""
    return 2 * MLP_MACS[sigma_only]


def hash_sample_flop(sigma_only: bool, levels: int = 16) -> int:
    """Operations a sample of the NGP field: the nets' products and the
    levels' interpolation."""
    return cp_flop(0, not sigma_only)[0] + levels * hash_flop()


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the chip could take: operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    return max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES)


def share_percent(flop: float, nbytes: float, seconds: float):
    """The least time over the measured time, in %; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(flop, nbytes) / seconds


def tf32x3_seconds(product_flop: float) -> float:
    """The bring-up tables' figure: three TF32 products a product over the
    TF32 rate. A figure printed beside a share, not a share."""
    return 3.0 * product_flop / PEAK_TF32
