"""Training losses with the reference's staging schedule (torch counterpart
of `mirror_nerf_tpu/train/losses.py`).

  * `color_loss`: MSE with three masking regimes in the geometry stage
    (invalid GT mask → exclude predicted mirror pixels; valid GT mask +
    woMaskRGBtoBlack → exclude GT mirror pixels; else plain, the targets
    blacked out inside the mirror by the train step);
  * `normal_loss`: weighted pred-vs-gradient normal MSE, ×100 inside the
    mirror when the GT mask is valid;
  * `plane_consistent_loss`: |triple product| over 4-tuples of mirror
    surface points;
  * `normal_reg_loss`, `mirror_mask_loss`, `distortion_loss`, and the
    novel-ray regularization;
  * `total_loss`, the per-epoch schedule, and `make_loss_settings`.

"Is the GT mask valid in this batch?" stays on the device as a scalar
predicate selecting between branch values, as in the JAX package. Random
draws are inputs: the plane loss takes its tuple indices (`draw_plane_tuples`
makes them with a `torch.Generator`), the novel-ray regularization its
origin jitter and depths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.mathutil import binary_cross_entropy, masked_mean


@dataclass(frozen=True)
class LossSettings:
    """Static loss configuration, resolved per stage/epoch by the caller."""

    color_loss_weight: float = 1.0
    normal_loss_weight: float = 1e-4
    normal_reg_loss_weight: float = 0.1
    mirror_mask_loss_weight: float = 0.1
    plane_consistent_loss_weight: float = 0.1
    # opt-in floater suppression; 0 = exact reference loss set
    distortion_loss_weight: float = 0.0

    train_geometry_stage: bool = False
    woMaskRGBtoBlack: bool = False
    normal_loss_only_inside_mirror: bool = False
    use_plane_consistent_loss: bool = False
    # epoch-resolved schedule switches
    enable_mask_loss: bool = True
    enable_plane_loss: bool = False
    enable_normal_losses: bool = True
    # number of 4-tuples for the plane loss (batch // 4)
    plane_n_tuples: int = 256
    # stable BCE clamp (reference losses.py:193)
    bce_eps: float = 1e-7


def _typs(results):
    return [t for t in ("coarse", "fine") if f"rgb_{t}" in results]


def color_loss(ls: LossSettings, results: dict, batch: dict) -> torch.Tensor:
    targets = batch["rgbs"].reshape(-1, 3)
    gt_mask = batch.get("mirror_mask")
    loss = 0.0
    if ls.train_geometry_stage and gt_mask is not None:
        gt_invalid = (gt_mask < 0).any()
        pred_key = next((k for k in ("mirror_mask_fine", "mirror_mask_coarse")
                         if k in results), None)
        for typ in _typs(results):
            se = (results[f"rgb_{typ}"] - targets) ** 2
            if pred_key is not None:
                pm = results[pred_key].detach() > 0.5
                loss_invalid = masked_mean(se, ~pm[:, None])
            else:
                loss_invalid = se.new_zeros(())
            if ls.woMaskRGBtoBlack:
                loss_valid = masked_mean(se, ~(gt_mask > 0.5)[:, None])
            else:
                # the step blacked out the targets inside the mirror
                loss_valid = torch.mean(se)
            loss = loss + torch.where(gt_invalid, loss_invalid, loss_valid)
    else:
        for typ in _typs(results):
            loss = loss + torch.mean((results[f"rgb_{typ}"] - targets) ** 2)
    return ls.color_loss_weight * loss


def normal_loss(ls: LossSettings, results: dict,
                batch: dict) -> Optional[torch.Tensor]:
    gt_mask = batch.get("mirror_mask")
    terms = []
    for typ in ("coarse", "fine"):
        key = f"normal_dif_{typ}"
        if key not in results:
            continue
        dif = results[key]
        plain = torch.mean(dif)
        if gt_mask is not None:
            m = gt_mask > 0.5
            inside = masked_mean(dif, m) * 100.0
            masked = inside if ls.normal_loss_only_inside_mirror else (
                inside + masked_mean(dif, ~m))
            terms.append(torch.where((gt_mask >= 0).all(), masked, plain))
        else:
            terms.append(plain)
    if not terms:
        return None
    return ls.normal_loss_weight * sum(terms)


def draw_plane_tuples(gt_mask: torch.Tensor, n_tuples: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """(n_tuples, 4) pixel indices drawn uniformly from the GT mirror pixels
    (uniformly from all pixels when there is none: the loss is then gated
    to 0)."""
    inside = (gt_mask > 0.5).to(torch.float32)
    probs = torch.where(inside.sum() > 0, inside, torch.ones_like(inside))
    idx = torch.multinomial(probs, n_tuples * 4, replacement=True,
                            generator=generator)
    return idx.reshape(n_tuples, 4)


def plane_consistent_loss(ls: LossSettings, results: dict, batch: dict,
                          idx: torch.Tensor) -> Optional[torch.Tensor]:
    """|((p1−p0)×(p2−p0))·(p3−p0)| over the 4-tuples of surface points at
    the pixel indices `idx` (T, 4)."""
    gt_mask = batch.get("mirror_mask")
    if gt_mask is None:
        return None
    # active only with a valid GT mask and >= 4 mirror pixels
    active = (gt_mask >= 0).all() & ((gt_mask > 0.5).sum() >= 4)
    terms = []
    for typ in ("fine", "coarse"):
        key = f"x_surface_{typ}"
        if key not in results:
            continue
        pts = results[key][idx]  # (T, 4, 3)
        v1 = pts[:, 1] - pts[:, 0]
        v2 = pts[:, 2] - pts[:, 0]
        v3 = pts[:, 3] - pts[:, 0]
        triple = torch.sum(torch.linalg.cross(v1, v2) * v3, dim=-1)
        term = torch.mean(torch.abs(triple))
        terms.append(torch.where(active, term, torch.zeros_like(term)))
    if not terms:
        return None
    return ls.plane_consistent_loss_weight * sum(terms)


def distortion_core(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mean per-ray interval distortion (mip-NeRF 360, eq. 15) of weights
    (N, S) over sorted depths (N, S), O(S) by exclusive prefix sums."""
    z0, z1 = z[:, :1], z[:, -1:]
    s = (z - z0) / torch.clamp_min(z1 - z0, 1e-8)
    w = w.to(torch.float32)
    s = s.to(torch.float32)
    w_cum = torch.cumsum(w, dim=-1) - w  # exclusive
    ws_cum = torch.cumsum(w * s, dim=-1) - w * s
    bi = 2.0 * torch.sum(w * (s * w_cum - ws_cum), dim=-1)
    delta = torch.diff(s, dim=-1, append=s[:, -1:])
    intra = torch.sum(w * w * delta, dim=-1) / 3.0
    return torch.mean(bi + intra)


def distortion_loss(ls: LossSettings,
                    results: dict) -> Optional[torch.Tensor]:
    for typ in ("fine", "coarse"):
        w, z = results.get(f"weights_{typ}"), results.get(f"z_vals_{typ}")
        if w is not None and z is not None:
            return ls.distortion_loss_weight * distortion_core(w, z)
    return None


def novel_ray_regularization(field, params: dict, rays: torch.Tensor,
                             o_noise: torch.Tensor, z: torch.Tensor,
                             jitter: float, fused: bool = False,
                             sigma_act: str = "relu") -> torch.Tensor:
    """Distortion prior along rays cast from jittered origins
    o + jitter·o_noise at depths z (N, S), with no color target: it sweeps
    the space between train cameras that train-ray losses never see.
    σ-only through the fine field (the coarse one without a fine field)."""
    from ..render.renderer import _composite_weights

    o = rays[:, 0:3] + jitter * o_noise
    xyz = (o[:, None, :] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
    fine = params.get("fine", params["coarse"])
    if fused and getattr(field, "supports_fused_train", False):
        from ..ops.fused_cp_train import density_fused

        # the jittered origins carry no gradient: skip d_x
        sigma, _ = density_fused(field, fine, xyz, need_dx=False)
    else:
        sigma, _ = field.density(fine, xyz)
    w = _composite_weights(sigma.reshape(z.shape), z, torch.zeros_like(z),
                           sigma_act)
    return distortion_core(w, z)


def normal_reg_loss(ls: LossSettings, results: dict,
                    batch: dict) -> Optional[torch.Tensor]:
    rays_d = batch["rays"][..., 3:6].reshape(-1, 3)
    valid = batch.get("valid_mask")

    def _term(normals, weights):
        pen = torch.sum(torch.relu(normals * rays_d[:, None, :]), dim=-1)
        per_elem = pen * weights
        if valid is not None:
            return masked_mean(per_elem, valid.reshape(-1, 1))
        return torch.mean(per_elem)

    terms = [_term(results[f"pred_normal_{typ}"], results[f"weights_{typ}"])
             for typ in ("coarse", "fine") if f"pred_normal_{typ}" in results]
    # the fine gradient normal too (ext_supervise_grad_normal)
    if "normal_fine" in results:
        terms.append(_term(results["normal_fine"], results["weights_fine"]))
    if not terms:
        return None
    return ls.normal_reg_loss_weight * sum(terms)


def mirror_mask_loss(ls: LossSettings, results: dict,
                     batch: dict) -> Optional[torch.Tensor]:
    gt_mask = batch.get("mirror_mask")
    if gt_mask is None:
        return None
    terms = []
    for typ in ("coarse", "fine"):
        key = f"mirror_mask_{typ}"
        if key not in results:
            continue
        pred = torch.clamp(results[key], ls.bce_eps, 1.0 - ls.bce_eps)
        bce = binary_cross_entropy(pred, gt_mask)
        # mean over ALL rays with the invalid (−1) entries zeroed
        terms.append(torch.mean(bce * (gt_mask >= 0).to(bce.dtype)))
    if not terms:
        return None
    return ls.mirror_mask_loss_weight * sum(terms)


def total_loss(ls: LossSettings, results: dict, batch: dict,
               plane_idx: Optional[torch.Tensor] = None):
    """Scheduled sum of all losses → (loss, dict of components).
    `plane_idx` (T, 4) is needed when the plane loss is on."""
    loss_dict = {"color_loss": color_loss(ls, results, batch)}
    candidates = []
    if ls.enable_mask_loss:
        candidates.append(("mirror_mask_loss",
                           lambda: mirror_mask_loss(ls, results, batch)))
    if ls.enable_plane_loss and ls.use_plane_consistent_loss:
        candidates.append(("plane_consistent_loss",
                           lambda: plane_consistent_loss(ls, results, batch,
                                                         plane_idx)))
    if ls.distortion_loss_weight > 0:
        candidates.append(("distortion_loss",
                           lambda: distortion_loss(ls, results)))
    if ls.enable_normal_losses:
        candidates.append(("normal_loss",
                           lambda: normal_loss(ls, results, batch)))
        candidates.append(("normal_reg_loss",
                           lambda: normal_reg_loss(ls, results, batch)))
    for name, fn in candidates:
        v = fn()
        if v is not None:
            loss_dict[name] = v
    return sum(loss_dict.values()), loss_dict


def make_loss_settings(cfg, train_geometry_stage: bool,
                       epoch: int) -> LossSettings:
    """Resolve the per-epoch schedule (reference losses.py:221-248)."""
    return LossSettings(
        color_loss_weight=cfg.color_loss_weight,
        normal_loss_weight=cfg.normal_loss_weight,
        normal_reg_loss_weight=cfg.normal_reg_loss_weight,
        mirror_mask_loss_weight=cfg.mirror_mask_loss_weight,
        plane_consistent_loss_weight=cfg.plane_consistent_loss_weight,
        distortion_loss_weight=cfg.distortion_loss_weight,
        train_geometry_stage=train_geometry_stage,
        woMaskRGBtoBlack=cfg.woMaskRGBtoBlack,
        normal_loss_only_inside_mirror=cfg.normal_loss_only_inside_mirror,
        use_plane_consistent_loss=cfg.use_plane_consistent_loss,
        enable_mask_loss=(not train_geometry_stage)
        or epoch >= cfg.train_mirror_mask_start_epoch,
        enable_plane_loss=epoch >= cfg.smooth_mirror_start_epoch,
        enable_normal_losses=(not train_geometry_stage)
        or epoch >= cfg.train_normal_start_epoch,
        plane_n_tuples=max(cfg.batch_size // 4, 1),
    )
