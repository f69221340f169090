"""Minimal functional NN building blocks on tensors.

Linear parameters are {"w": (in, out), "b": (out,)} — the JAX package's
layout, so checkpoints bridge leaf for leaf — initialized U(±1/sqrt(fan_in))
for weight and bias (torch's nn.Linear distribution).

`--compute_dtype bfloat16` (`ops/_dtype.py`) casts where the JAX package
casts, with explicit `.to` calls: each bf16 op then rounds its result to
bf16, as XLA's jitted bf16 ops do on the CPU (`torch.autocast` would pick
its own op list), except the last op before a cast back to fp32, which XLA
leaves unrounded (`linear_out`). Parameters stay fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops._dtype import cast


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def init_linear(generator: Optional[torch.Generator], in_dim: int,
                out_dim: int, bias: bool = True, device="cpu") -> dict:
    bound = 1.0 / (in_dim ** 0.5)
    p = {"w": _uniform((in_dim, out_dim), bound, generator, device)}
    if bias:
        p["b"] = _uniform((out_dim,), bound, generator, device)
    return p


def linear(p: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x @ w + b; with `dtype`, w and b cast to it first (JAX's `_lin`)."""
    y = x @ cast(p["w"], dtype)
    if "b" in p:
        y = y + cast(p["b"], dtype)
    return y


def linear_out(p: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The last linear of a net whose result the JAX package casts back to
    fp32, as XLA computes it in bf16: XLA gives an op whose only use is
    that cast an fp32 result, so the product is rounded to bf16 only when a
    bias follows it, and the bias add is not rounded. fp32 out; without
    `dtype` this is `linear`."""
    if dtype is None:
        return linear(p, x)
    w = p["w"].to(dtype)
    if "b" in p:
        return (x @ w).float() + p["b"].to(dtype).float()
    return x.float() @ w.float()


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
