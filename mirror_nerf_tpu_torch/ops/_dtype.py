"""`--compute_dtype`: the dtype a field computes in, the cast to it, and a
bf16 field's fp32 self (what the fused kernels and their plain versions
compute, and the σ-gradient pass's field under --fp32_sigma_grad).

Shared by the field modules (`models/`) and the ops below them.
"""

from __future__ import annotations

import dataclasses

import torch


def compute_dtype(name: str):
    """The dtype a field casts its activations and weights to: None for
    "float32" (no cast: a field on float64 inputs and parameters computes
    in float64, the tests' and chip_smoke.py's references),
    torch.bfloat16 for "bfloat16"."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {name!r}: float32 or "
                         "bfloat16")
    return torch.bfloat16 if name == "bfloat16" else None


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in `dtype` (`compute_dtype`'s result; None leaves it as it is)."""
    return x if dtype is None else x.to(dtype)


def float32_field(field):
    """A bf16 `field` as its fp32 self (any other field unchanged): what a
    fused kernel (and its plain version) computes for a bf16 field, and the
    σ-gradient pass's field under --fp32_sigma_grad."""
    if getattr(field, "compute_dtype", "float32") != "bfloat16":
        return field
    return dataclasses.replace(field, compute_dtype="float32")
