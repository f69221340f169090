"""Per-ray depth sampling: stratified coarse samples + inverse-CDF importance
(torch counterparts of `mirror_nerf_tpu/core/sampling.py`).

Randomness comes from an explicit `torch.Generator`; with `perturb == 0`
(the eval path) no random numbers are drawn.
"""

from __future__ import annotations

from typing import Optional

import torch


def _unit_steps(n: int, like: torch.Tensor) -> torch.Tensor:
    """linspace(0, 1, n) as i / (n − 1), each step correctly rounded — the
    JAX package's values bit for bit (torch.linspace rounds differently)."""
    steps = torch.arange(n, dtype=like.dtype, device=like.device)
    return steps / max(n - 1, 1)


def stratified_z_vals(
    near: torch.Tensor,  # (N, 1)
    far: torch.Tensor,  # (N, 1)
    N_samples: int,
    use_disp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse depth samples per ray, (N, N_samples): linear in depth (or
    disparity), optionally jittered within each interval."""
    z_steps = _unit_steps(N_samples, near)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(near.shape[0], N_samples)

    if perturb > 0.0:
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        u = torch.rand(z_vals.shape, dtype=z_vals.dtype,
                       device=z_vals.device, generator=generator)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(
    bins: torch.Tensor,  # (N, M+1) interval midpoints of the coarse z_vals
    weights: torch.Tensor,  # (N, M)
    N_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw N_importance samples per ray from the piecewise-constant PDF
    defined by `weights` over `bins`: weights floored by eps, the CDF
    zero-padded on the left, `u` a deterministic linspace or uniform noise,
    indices from a right-inclusive searchsorted. `ind - 1` is never below 0
    (cdf_0 = 0 <= u) and `ind` is clamped to the last entry."""
    n_rays, m = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, M+1)

    if det:
        u = _unit_steps(N_importance, cdf).expand(n_rays, N_importance)
        u = u.contiguous()
    else:
        u = torch.rand((n_rays, N_importance), dtype=cdf.dtype,
                       device=cdf.device, generator=generator)

    ind = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(ind - 1, 0)
    above = torch.clamp_max(ind, m)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bin_lo = torch.gather(bins, 1, below)
    bin_hi = torch.gather(bins, 1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def merge_fine_z_vals(
    z_vals: torch.Tensor,  # (N, S) coarse samples
    weights: torch.Tensor,  # (N, S) coarse compositing weights
    N_importance: int,
    perturb: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse+fine merged, sorted depth samples, (N, S+N_importance). The
    PDF uses the interior coarse weights with gradients stopped."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, weights[:, 1:-1].detach(), N_importance,
                        det=(perturb == 0.0), generator=generator)
    merged = torch.cat([z_vals, z_fine], dim=-1)
    return torch.sort(merged, dim=-1).values
