"""Small math helpers shared across the port (torch counterparts of
`mirror_nerf_tpu/core/mathutil.py`)."""

from __future__ import annotations

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def l2_normalize(x: torch.Tensor, eps: float = _F32_EPS) -> torch.Tensor:
    """Normalize to unit length along the last axis (safe at zero): the
    squared norm is clamped at `eps` before the rsqrt, as in the JAX
    package."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, eps))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror-reflect incident direction `d` about unit normal `n`: with
    w = normalize(-d) the outgoing direction is r = 2 (n·w) n − w."""
    w = l2_normalize(-d)
    cos = torch.sum(w * n, dim=-1, keepdim=True)
    return 2.0 * cos * n - w


def binary_cross_entropy(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities (the caller clamps p away from
    {0, 1})."""
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, gt))


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where `mask` (broadcastable) is true; 0, not NaN, on
    an empty selection (a batch without a mirror pixel)."""
    mask = mask.to(values.dtype)
    num = torch.sum(values * mask)
    den = torch.sum(mask * torch.ones_like(values))
    return num / torch.clamp_min(den, 1.0)
