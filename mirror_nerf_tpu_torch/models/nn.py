"""Minimal functional NN building blocks on tensors.

Linear parameters are {"w": (in, out), "b": (out,)} — the JAX package's
layout, so checkpoints bridge leaf for leaf — initialized U(±1/sqrt(fan_in))
for weight and bias (torch's nn.Linear distribution).
"""

from __future__ import annotations

from typing import Optional

import torch


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


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
