"""Plain PyTorch pieces the references share: products at a stated
precision, positional encoding, sampling, compositing, the eval-path render
and its Whitted trace.

Written from the published description of Mirror-NeRF's renderer (64
stratified coarse samples, 128 inverse-CDF fine samples on the interior
coarse weights, α-compositing with δ_inf = 1e10 and 1e-10 in the
transmittance, the mirror mask thresholded at 0.5, reflection about the
composited predicted normal, secondary rays from the surface point with a
0.1 forward offset) and the reference implementation's conventions. It
imports nothing of the program under test.

Products run at `prec`: "fp32" (cuBLAS with TF32 off on the card) or
"tf32", the control: each factor rounded to TF32 (10 mantissa bits, to
nearest even) before an fp32 product, what TF32 tensor cores compute.
"""

from __future__ import annotations

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
RAY_FORWARD_OFFSET = 0.1


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.detach().contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """x @ w on TF32-rounded factors, its backward's products likewise
    (differentiable again, for the normals' grad-of-grad)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return to_tf32(x) @ to_tf32(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (_TF32Product.apply(g, w.transpose(-1, -2)),
                _TF32Product.apply(x.transpose(-1, -2), g))


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return _TF32Product.apply(x, w)
    if prec != "fp32":
        raise ValueError(f"unknown precision {prec!r}")
    return x @ w


def linear(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    y = mm(x, p["w"], prec)
    return y + p["b"] if "b" in p else y


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, F32_EPS))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    w = l2_normalize(-d)
    return 2.0 * torch.sum(w * n, dim=-1, keepdim=True) * n - w


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(k-1) x), cos(2^(k-1) x)],
    the cosine as sin(z + fp32(π/2)) as the reference's fp32 code rounds
    it; 2^k x is exact."""
    if n_freqs == 0:
        return x
    half_pi = torch.tensor(np.float32(np.pi / 2.0), device=x.device)
    out = [x]
    for k in range(n_freqs):
        z = x * float(2.0 ** k)
        out += [torch.sin(z), torch.sin(z + half_pi)]
    return torch.cat(out, dim=-1)


def unit_steps(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device) / max(
        n - 1, 1)


def stratified(near, far, n: int, u=None) -> torch.Tensor:
    """(N, n) depths linear in depth, jittered within their intervals by
    `u` (N, n) uniform draws when given."""
    t = unit_steps(n, near)
    z = (near * (1.0 - t) + far * t).expand(near.shape[0], n)
    if u is None:
        return z
    mids = 0.5 * (z[:, :-1] + z[:, 1:])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, n: int, u=None, eps: float = 1e-5):
    """Inverse-CDF samples of the piecewise-constant pdf `weights` over
    `bins`: `u` (N, n) uniform draws, or evenly spaced without them."""
    n_rays, m = weights.shape
    w = weights + eps
    cdf = torch.cumsum(w / torch.sum(w, -1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if u is None:
        u = unit_steps(n, cdf).expand(n_rays, n).contiguous()
    ind = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(ind - 1, 0)
    above = torch.clamp_max(ind, m)
    c_lo, c_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b_lo, b_hi = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    den = c_hi - c_lo
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def fine_depths(z, w_coarse, n: int, u=None) -> torch.Tensor:
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    zf = sample_pdf(mid, w_coarse[:, 1:-1].detach(), n, u)
    return torch.sort(torch.cat([z, zf], -1), -1).values


def composite_weights(sigma, z, noise=None) -> torch.Tensor:
    """α-compositing weights of raw σ (ReLU density) with optional σ
    noise."""
    delta = z[:, 1:] - z[:, :-1]
    delta = torch.cat([delta, torch.full_like(delta[:, :1], 1e10)], -1)
    s = sigma if noise is None else sigma + noise
    alpha = 1.0 - torch.exp(-delta * torch.clamp_min(s, 0.0))
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       1.0 - alpha + 1e-10], -1)
    return alpha * torch.cumprod(trans[:, :-1], -1)


def _points(rays, z):
    return (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(
        -1, 3)


@torch.no_grad()
def render_eval(field, params: dict, rays: torch.Tensor, n_samples: int,
                n_importance: int, prec: str) -> dict:
    """One eval render of (N, 8) [o, d, near, far] rays: a σ-only coarse
    pass, the fine pass on the merged samples. Returns per-ray rgb, depth,
    opacity, the mirror mask (the composite of the mirror probability),
    the composited unit normal, and per sample the fine weights and the
    mirror logits (for the calibration of the mirror bias)."""
    n = rays.shape[0]
    z = stratified(rays[:, 6:7], rays[:, 7:8], n_samples)
    sig_c, _ = field.density(params["coarse"], _points(rays, z), prec)
    w_c = composite_weights(sig_c.reshape(n, -1), z)
    zf = fine_depths(z, w_c, n_importance)
    s = zf.shape[1]
    fine = params["fine"]
    sig, geo = field.density(fine, _points(rays, zf), prec)
    dirs = rays[:, 3:6].repeat_interleave(s, dim=0)
    rgb = field.color(fine, geo, dirs, prec).reshape(n, s, 3)
    nrm = l2_normalize(field.normal(fine, geo, prec)).reshape(n, s, 3)
    logit = field.mirror_logit(fine, geo, prec).reshape(n, s)
    w = composite_weights(sig.reshape(n, s), zf)
    depth = (w * zf).sum(-1)
    return {"rgb": (w[..., None] * rgb).sum(1), "depth": depth,
            "mask": (w * torch.sigmoid(logit)).sum(-1),
            "normal": (w[..., None] * nrm).sum(1), "weights": w,
            "logit": logit,
            "x_surface": rays[:, 0:3] + rays[:, 3:6] * depth[:, None]}


def secondary(rays: torch.Tensor, r: dict) -> torch.Tensor:
    """The reflected rays of a render: from the surface point, about the
    composited normal, near the forward offset, the primary's far."""
    far = rays[:, 7:8]
    return torch.cat([r["x_surface"],
                      reflect(rays[:, 3:6], l2_normalize(r["normal"])),
                      torch.full_like(far, RAY_FORWARD_OFFSET), far], -1)


@torch.no_grad()
def trace_eval(field, params: dict, rays: torch.Tensor, levels: int,
               n_samples: int, n_importance: int, prec: str,
               block: int = 4096) -> dict:
    """The Whitted eval trace of `rays` to `levels` bounces: a ray whose
    mask exceeds 0.5 at a level takes the colour of its reflection traced
    from there; only such rays are traced further. Per ray: `rgb`, `depth`
    (level 0), `mask` (level 0, thresholded), `depth_reflect` (level 1's
    depth for the level-0 mirrors, else 0), and `mask_value` (levels + 1,
    N): each level's unthresholded mask, NaN where the ray was not traced
    to that level."""
    outs = [_trace_block(field, params, rays[i:i + block], levels, n_samples,
                         n_importance, prec)
            for i in range(0, rays.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs], -1 if k == "mask_value"
                         else 0) for k in outs[0]}


def _trace_block(field, params, rays, levels, n_samples, n_importance, prec):
    n = rays.shape[0]
    r = render_eval(field, params, rays, n_samples, n_importance, prec)
    m = r["mask"] > 0.5
    rgb = r["rgb"]
    depth_reflect = torch.zeros_like(r["depth"])
    values = torch.full((levels + 1, n), float("nan"), device=rays.device)
    values[0] = r["mask"]
    if levels > 0 and bool(m.any()):
        idx = torch.nonzero(m)[:, 0]
        sub = _trace_block(field, params, secondary(rays, r)[idx],
                           levels - 1, n_samples, n_importance, prec)
        rgb = rgb.clone()
        rgb[idx] = sub["rgb"]
        depth_reflect[idx] = sub["depth"]
        values[1:, idx] = sub["mask_value"]
    return {"rgb": rgb, "depth": r["depth"], "mask": m.to(torch.float32),
            "depth_reflect": depth_reflect, "mask_value": values}
