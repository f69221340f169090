"""Plain PyTorch reference of one Mirror-NeRF training step in the
reflection stage, written from the paper and the reference implementation
(`train.py`, `models/rendering.py`, `losses.py`): the level-0 render of
the batch with ∇σ normals (autograd, differentiable), the reflected rays
of the ground-truth mirror pixels rendered at level 1 and blended in,
the losses (colour MSE of both passes, the mirror mask's BCE, the
plane-consistency of 4-tuples of mirror surface points, the normal loss
×100 inside the mirror, the normal regulariser, the novel-ray distortion
prior), their gradients, and Adam.

The random draws come from a generator the caller seeds, in the order the
step takes them: per level the stratified jitter, the coarse pass's σ
noise, the importance samples' uniforms, the fine pass's σ noise; then
the plane tuples; then the novel rays' origin jitter and depths.
"""

from __future__ import annotations

import torch

from .common import (RAY_FORWARD_OFFSET, composite_weights, l2_normalize,
                     reflect, sample_pdf, stratified)


def _pass(field, p, rays, z, noise_std, g, with_grad_normal, prec):
    n, s = z.shape
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(
        -1, 3)
    out = {}
    if with_grad_normal:
        x = xyz if xyz.requires_grad else xyz.detach().requires_grad_(True)
        sigma, geo = field.density(p, x, prec)
        (grad,) = torch.autograd.grad(sigma.sum(), x, create_graph=True)
        out["normal"] = l2_normalize(-grad).reshape(n, s, 3)
    else:
        sigma, geo = field.density(p, xyz, prec)
    pred = l2_normalize(field.normal(p, geo, prec)).reshape(n, s, 3)
    dirs = rays[:, 3:6].repeat_interleave(s, dim=0)
    rgb = field.color(p, geo, dirs, prec).reshape(n, s, 3)
    mirror = torch.sigmoid(field.mirror_logit(p, geo, prec)).reshape(n, s)
    sigma = sigma.reshape(n, s)
    noise = torch.randn(sigma.shape, generator=g, device=sigma.device)
    w = composite_weights(sigma, z, noise * noise_std)
    out.update(weights=w, rgb=(w[..., None] * rgb).sum(1),
               depth=(w * z).sum(-1), mask=(w * mirror).sum(-1),
               pred_normal=pred, surface_normal=(pred * w[..., None]).sum(1))
    if with_grad_normal:
        out["normal_dif"] = (w * ((out["normal"] - pred) ** 2).sum(-1)).sum(
            -1)
    out["x_surface"] = rays[:, 0:3] + rays[:, 3:6] * out["depth"][:, None]
    return out


def render_train(field, params, rays, g, st: dict, with_grad_normal: bool,
                 prec: str) -> dict:
    """Coarse and fine passes of one level, perturbed and noisy."""
    n = rays.shape[0]
    near, far = rays[:, 6:7], rays[:, 7:8]
    u = torch.rand((n, st["N_samples"]), generator=g, device=rays.device)
    z = stratified(near, far, st["N_samples"], u)
    coarse = _pass(field, params["coarse"], rays, z, st["noise_std"], g,
                   with_grad_normal, prec)
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    u = torch.rand((n, st["N_importance"]), generator=g, device=rays.device)
    zf = sample_pdf(mid, coarse["weights"][:, 1:-1].detach(),
                    st["N_importance"], u)
    zf = torch.sort(torch.cat([z, zf], -1), -1).values
    fine = _pass(field, params["fine"], rays, zf, st["noise_std"], g,
                 with_grad_normal, prec)
    return {"coarse": coarse, "fine": fine}


def _masked_mean(v, m):
    m = m.to(v.dtype)
    return torch.sum(v * m) / torch.clamp_min(torch.sum(m * torch.ones_like(v)),
                                              1.0)


def distortion(w, z):
    """Mean interval distortion (mip-NeRF 360, eq. 15) of weights over
    sorted depths, normalised to [0, 1] along each ray."""
    s = (z - z[:, :1]) / torch.clamp_min(z[:, -1:] - z[:, :1], 1e-8)
    w_cum = torch.cumsum(w, -1) - w
    ws_cum = torch.cumsum(w * s, -1) - w * s
    bi = 2.0 * torch.sum(w * (s * w_cum - ws_cum), -1)
    delta = torch.diff(s, dim=-1, append=s[:, -1:])
    return torch.mean(bi + torch.sum(w * w * delta, -1) / 3.0)


def step_loss(field, params, batch: dict, g, st: dict, prec: str):
    """The step's loss (differentiable in `params`) and its parts."""
    rays, rgbs, gt = batch["rays"], batch["rgbs"], batch["mirror_mask"]
    lv0 = render_train(field, params, rays, g, st, True, prec)
    m = gt[:, None]  # valid ground truth: the level-0 mirror mask
    sec = torch.cat([lv0["fine"]["x_surface"],
                     reflect(rays[:, 3:6],
                             l2_normalize(lv0["fine"]["surface_normal"])),
                     torch.full_like(rays[:, 7:8], RAY_FORWARD_OFFSET),
                     rays[:, 7:8]], -1)
    lv1 = render_train(field, params, sec, g, st, False, prec)
    rgb = {t: m * lv1[t]["rgb"] + (1.0 - m) * lv0[t]["rgb"]
           for t in ("coarse", "fine")}
    w = st["weights"]
    parts = {"color": w["color"] * sum(torch.mean((rgb[t] - rgbs) ** 2)
                                       for t in ("coarse", "fine"))}
    eps = 1e-7
    bce = 0.0
    for t in ("coarse", "fine"):
        p = torch.clamp(lv0[t]["mask"], eps, 1.0 - eps)
        b = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
        bce = bce + torch.mean(b * (gt >= 0).to(b.dtype))
    parts["mask"] = w["mask"] * bce
    inside = (gt > 0.5).to(torch.float32)
    probs = torch.where(inside.sum() > 0, inside, torch.ones_like(inside))
    idx = torch.multinomial(probs, st["plane_tuples"] * 4, replacement=True,
                            generator=g).reshape(-1, 4)
    active = (gt >= 0).all() & ((gt > 0.5).sum() >= 4)
    plane = 0.0
    for t in ("fine", "coarse"):
        pts = lv0[t]["x_surface"][idx]
        v1, v2, v3 = (pts[:, k] - pts[:, 0] for k in (1, 2, 3))
        term = torch.mean(torch.abs(torch.sum(torch.linalg.cross(v1, v2) * v3,
                                              -1)))
        plane = plane + torch.where(active, term, torch.zeros_like(term))
    parts["plane"] = w["plane"] * plane
    inm = gt > 0.5
    normal = 0.0
    for t in ("coarse", "fine"):
        dif = lv0[t]["normal_dif"]
        masked = _masked_mean(dif, inm) * 100.0 + _masked_mean(dif, ~inm)
        normal = normal + torch.where((gt >= 0).all(), masked,
                                      torch.mean(dif))
    parts["normal"] = w["normal"] * normal
    d = rays[:, None, 3:6]
    reg = sum(torch.mean(torch.sum(torch.relu(n * d), -1) * lv0[t]["weights"])
              for t, n in (("coarse", lv0["coarse"]["pred_normal"]),
                           ("fine", lv0["fine"]["pred_normal"]),
                           ("fine", lv0["fine"]["normal"])))
    parts["normal_reg"] = w["normal_reg"] * reg
    nr = rays[:st["novel_rays"]]
    o_noise = torch.randn(nr[:, 0:3].shape, generator=g, device=nr.device)
    u = torch.rand((nr.shape[0], st["N_samples"]), generator=g,
                   device=nr.device)
    z = stratified(nr[:, 6:7], nr[:, 7:8], st["N_samples"], u)
    o = nr[:, 0:3] + st["novel_jitter"] * o_noise
    xyz = (o[:, None, :] + nr[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    sigma, _ = field.density(params["fine"], xyz, prec)
    wn = composite_weights(sigma.reshape(z.shape), z)
    parts["novel"] = w["novel"] * distortion(wn, z)
    loss = (parts["color"] + parts["mask"] + parts["plane"] + parts["normal"]
            + parts["normal_reg"]) + parts["novel"]
    return loss, parts


class Adam:
    """Adam as published: m̂ / (√v̂ + eps), bias-corrected moments."""

    def __init__(self, leaves, lr: float, eps: float, b1=0.9, b2=0.999):
        self.lr, self.eps, self.b1, self.b2 = lr, eps, b1, b2
        self.m = [torch.zeros_like(x) for x in leaves]
        self.v = [torch.zeros_like(x) for x in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, leaves, grads) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for x, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            x.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
