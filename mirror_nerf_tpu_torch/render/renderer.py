"""Volume renderer (torch counterpart of `mirror_nerf_tpu/render/renderer.py`).

Stratified coarse sampling, α-compositing with σ-noise, inverse-CDF fine
resampling over the detached interior coarse weights, `test_time` /
`fine_pass` semantics, mirror-mask and normal aggregation with the
reference's stop-gradient variants, surface points x = o + d·depth.

The field runs one of three ways: a fused eval kernel (`fused_field`,
forward-only), which composites in-kernel on noise-free passes
(ops/fused_cp.py for the CP grid, ops/fused_mlp_t.py for the flagship
PE-MLP, ops/fused_hash.py for the hash grid, `nerf_tcnn`) and emits
per-sample rows that are composited here on σ-noise passes, and on the
flagship's passes with `fused_t` off or a trunk other than the default
(ops/fused_cp.py `fused_cp_rays_eval`, ops/fused_mlp.py `fused_rays_eval`); the hash grid's σ-noise passes take
the plain route below (ENCODE and the PyTorch nets); the training kernels
for density + ∇σ or density alone (`fused_density`,
ops/fused_cp_train.py); or the plain field modules, with the σ-gradient
normal by `torch.autograd.grad` (`density_with_grad_reference`): the
route that trains the flagship (cuBLAS on the card) and the hash grid
(ENCODE, its backward BWD and, for the normal losses' grad-of-grad, BWD2).

With `--compute_dtype bfloat16` the plain route runs the field's bf16
modules; the fused kernels compute in fp32 whatever the field's dtype (as
the JAX package's do), so a bf16 field reaches them as its fp32 self
(`float32_field`; their plain versions on the CPU likewise).
`fp32_sigma_grad` rebuilds a bf16 field's σ-gradient pass in fp32 when the
train kernels do not take it (JAX `renderer.py:190-215`); that pass's σ and
geometry feature feed the composite and the heads in fp32.

σ noise is drawn from `generator` once per pass, after the pass's field and
before the next draw (the fine pass's pdf samples), on every route alike;
`render_rays(sigma_noise=...)` takes pre-drawn noise instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.mathutil import l2_normalize
from ..core.sampling import merge_fine_z_vals, stratified_z_vals
from ..ops._dtype import float32_field
from ..ops.segment_scan import exp_plain

@dataclass(frozen=True)
class RenderSettings:
    """Static knobs of one render_rays call."""

    N_samples: int = 64
    N_importance: int = 128
    use_disp: bool = False
    perturb: float = 1.0
    noise_std: float = 1.0
    white_back: bool = False
    test_time: bool = False
    # compute the σ-gradient (analytic) normal alongside density
    compute_normal: bool = True
    # "fine" | "coarse" (only_one_field past warm-up) | "none"
    fine_pass: str = "fine"
    # stop-gradient plumbing (reference opt.py:211-221)
    detach_density_outside_mirror_for_mask_loss: bool = False
    detach_density_for_mask_loss: bool = False
    detach_density_for_normal_loss: bool = False
    # run the field through its fused eval kernel (CP grid or PE-MLP;
    # engages when the σ-gradient normal is off)
    fused_field: bool = False
    # the flagship's noise-free fused passes composite in-kernel
    # (ops/fused_mlp_t.py); off, they take the per-sample rows kernel
    # (ops/fused_mlp.py) and composite here, as σ-noise passes always do
    fused_t: bool = True
    # the training kernels for density + ∇σ (compute_normal) or density
    # alone, differentiable incl. grad-of-grad (ops/fused_cp_train.py)
    fused_density: bool = False
    # a bf16 field's σ-gradient (analytic normal) pass in fp32 when the
    # train kernels do not take it (--fp32_sigma_grad)
    fp32_sigma_grad: bool = False
    # eval-only: no coarse proposal pass; one fine pass on
    # N_samples + N_importance stratified samples
    proposal_skip: bool = False
    # σ -> density nonlinearity in compositing: "relu" | "softplus"
    sigma_activation: str = "relu"

    @property
    def has_fine(self) -> bool:
        return self.fine_pass != "none" and self.N_importance > 0


def check_secondary_render(rs, rs_sec) -> None:
    """A reduced secondary-bounce budget must keep the render's key
    structure (has_fine) identical to the primary's."""
    if rs_sec is None:
        return
    if rs_sec.has_fine != rs.has_fine:
        raise ValueError(
            f"secondary render budget (N_importance={rs_sec.N_importance}, "
            f"fine_pass={rs_sec.fine_pass!r}) changes has_fine "
            f"({rs_sec.has_fine}) vs the primary ({rs.has_fine}); use "
            "secondary_N_importance >= 1 (or 0 only when the primary also "
            "renders coarse-only)")


def sigma_activation(sigmas: torch.Tensor, act: str) -> torch.Tensor:
    """Raw σ -> nonnegative density: "relu" or a stable softplus
    max(x, 0) + log1p(exp(−|x|))."""
    if act == "softplus":
        return torch.clamp_min(sigmas, 0.0) + torch.log1p(
            exp_plain(-sigmas.abs()))
    if act != "relu":
        raise ValueError(f"unknown sigma activation {act!r}")
    return torch.clamp_min(sigmas, 0.0)


def _composite_weights(sigmas, z_vals, noise, act: str = "relu"):
    """α-compositing weights from raw σ (δ_inf = 1e10 on the last sample,
    transmittance a cumprod of 1 − α + 1e-10); the exponential by
    `exp_plain`: torch.exp on the card, no MKL on the CPU (F5)."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], -1)
    alphas = 1.0 - exp_plain(-deltas * sigma_activation(sigmas + noise, act))
    shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1)
    return alphas * torch.cumprod(shifted[:, :-1], dim=-1)


def _sigma_noise(rs: RenderSettings, sigmas, generator, drawn=None):
    """A pass's σ noise, (N, S): `drawn` (standard normal, pre-drawn) or
    one draw from `generator`, × noise_std; zeros when noise_std is 0."""
    if rs.noise_std <= 0:
        return torch.zeros_like(sigmas)
    if drawn is None:
        drawn = torch.randn(sigmas.shape, generator=generator,
                            dtype=sigmas.dtype, device=sigmas.device)
    return drawn.to(sigmas) * rs.noise_std


def _gated_detach(x, keep_grad):
    """x where keep_grad, else x with its gradient stopped (same values)."""
    return torch.where(keep_grad, x, x.detach())


def _inference(field, params, typ: str, rays_o, rays_d, z_vals, dirs,
               rs: RenderSettings, results: dict, sigma_only: bool,
               mirror_mask_per_ray=None, gt_mask_valid=None,
               generator: Optional[torch.Generator] = None,
               noise=None) -> dict:
    """One pass; `noise` (N, S) pre-drawn standard-normal σ noise, or None
    to draw it from `generator` (see `_sigma_noise`)."""
    n, s = z_vals.shape
    if rs.fused_field and not rs.compute_normal:
        def pass_noise(sigmas):
            return _sigma_noise(rs, sigmas, generator, noise)

        kfield = float32_field(field)  # what the kernels compute

        if getattr(field, "supports_fused_cp", False):
            return _inference_fused_cp(kfield, params, typ, z_vals, dirs, rs,
                                       results, sigma_only, rays_o, rays_d,
                                       pass_noise)
        if getattr(field, "supports_fused_hash", False):
            if rs.noise_std == 0:
                from ..ops.fused_hash import fused_hash_rays_composite

                return _inference_in_kernel(
                    fused_hash_rays_composite, kfield, params, typ, z_vals,
                    dirs, rs, results, sigma_only, rays_o, rays_d)
            # σ-noise passes: ENCODE and the PyTorch nets below (a rows
            # mode of the fused kernel is ROADMAP.md queue 2, item 13)
        # a hash-grid field the fused NGP composite does not take renders
        # every pass that way too: ENCODE (any spec) and the nets, the
        # route the JAX package takes for every hash-grid pass
        if getattr(field, "supports_fused", False):
            # the composite kernel takes the default trunk; every trunk of
            # the range takes the rows kernels with the composite outside
            if (rs.fused_t and rs.noise_std == 0
                    and getattr(field, "supports_fused_t", False)):
                from ..ops.fused_mlp_t import fused_t_rays_composite

                return _inference_in_kernel(
                    fused_t_rays_composite, kfield, params, typ, z_vals,
                    dirs, rs, results, sigma_only, rays_o, rays_d)
            return _inference_fused(kfield, params, typ, z_vals, dirs, rs,
                                    results, sigma_only, rays_o, rays_d,
                                    pass_noise)
        if hasattr(field, "supports_fused") and z_vals.device.type != "cpu":
            raise NotImplementedError(
                "--fused_field: the PE-MLP kernels take a width that is a "
                "multiple of 128 and at most 20 posenc frequencies each "
                f"(the JAX kernels' range); {field} is outside it. Render "
                "it without --fused_field")

    xyz_flat = (rays_o[:, None, :]
                + rays_d[:, None, :] * z_vals[..., None]).reshape(-1, 3)
    fused = rs.fused_density and getattr(field, "supports_fused_train",
                                         False)
    normals = None
    if rs.compute_normal:
        from ..ops.fused_cp_train import (density_with_grad_fused,
                                          density_with_grad_reference)

        # the plain version is the JAX package's _density_with_grad: ∇σ by
        # autograd, differentiable (grad-of-grad) for the normal losses;
        # under fp32_sigma_grad a bf16 field's pass is rebuilt in fp32 (the
        # train kernels compute in fp32 already)
        f_grad = (float32_field(field) if rs.fp32_sigma_grad and not fused
                  else field)
        sigma_flat, geo_flat, grad_flat = (
            density_with_grad_fused if fused else
            density_with_grad_reference)(f_grad, params, xyz_flat)
        normals = l2_normalize(-grad_flat).reshape(n, s, 3)
    elif fused:
        from ..ops.fused_cp_train import density_fused

        sigma_flat, geo_flat = density_fused(field, params, xyz_flat)
    else:
        sigma_flat, geo_flat = field.density(params, xyz_flat)
    sigmas = sigma_flat.reshape(n, s)

    keep_grad = None
    if (rs.detach_density_outside_mirror_for_mask_loss
            and mirror_mask_per_ray is not None):
        # detach the samples outside the GT mirror, but only when the GT
        # mask is valid: values are identical, only gradients are gated
        keep_grad = ((mirror_mask_per_ray > 0.5)
                     | ~gt_mask_valid)[:, None]  # (N, 1)

    pred_normals = None
    if field.predict_normal:
        geo_n = (geo_flat.detach() if rs.detach_density_for_normal_loss
                 else geo_flat)
        pred_normals = l2_normalize(
            field.normal_head(params, geo_n)).reshape(n, s, 3)
    rgbs = is_mirrors = None
    if not sigma_only:
        dirs_flat = dirs.repeat_interleave(s, dim=0)
        rgbs = field.color(params, geo_flat, dirs_flat).reshape(n, s, 3)
        if field.predict_mirror_mask:
            if rs.detach_density_for_mask_loss:
                geo_m = geo_flat.detach()
            elif keep_grad is not None:
                geo_m = _gated_detach(
                    geo_flat, keep_grad.expand(n, s).reshape(-1, 1))
            else:
                geo_m = geo_flat
            is_mirrors = field.mirror_head(params, geo_m).reshape(n, s)

    weights = _composite_weights(
        sigmas, z_vals, _sigma_noise(rs, sigmas, generator, noise),
        rs.sigma_activation)
    weights_sum = weights.sum(-1)
    results[f"weights_{typ}"] = weights
    results[f"opacity_{typ}"] = weights_sum
    results[f"z_vals_{typ}"] = z_vals
    if sigma_only:
        return results

    rgb_map = (weights[..., None] * rgbs).sum(1)
    if rs.white_back:
        rgb_map = rgb_map + (1.0 - weights_sum[:, None])
    results[f"rgb_{typ}"] = rgb_map
    results[f"depth_{typ}"] = (weights * z_vals).sum(-1)
    if is_mirrors is not None:
        if rs.detach_density_for_mask_loss:
            w_mask = weights.detach()
        elif keep_grad is not None:
            w_mask = _gated_detach(weights, keep_grad)
        else:
            w_mask = weights
        results[f"mirror_mask_{typ}"] = (w_mask * is_mirrors).sum(-1)

    w_normal = (weights.detach() if rs.detach_density_for_normal_loss
                else weights)
    if normals is not None:
        results[f"normal_{typ}"] = normals
        results[f"surface_normal_grad_{typ}"] = (
            normals * w_normal[..., None]).sum(1)
    if pred_normals is not None:
        results[f"pred_normal_{typ}"] = pred_normals
        results[f"surface_normal_{typ}"] = (
            pred_normals * w_normal[..., None]).sum(1)
    if normals is not None and pred_normals is not None:
        dif = ((normals - pred_normals) ** 2).sum(-1)
        results[f"normal_dif_{typ}"] = (w_normal * dif).sum(-1)
    return results


def _inference_fused_cp(field, params, typ, z_vals, dirs, rs, results,
                        sigma_only, ray_o, ray_d, pass_noise) -> dict:
    """Inference for the CP-grid field through its fused kernel: with
    noise_std 0 the composite mode (weights + per-ray render in-kernel),
    else the rows mode, whose raw σ takes the noise before the cumprod
    compositing of `_composite_weights`. Forward-only."""
    from ..ops.fused_cp import (fused_cp_rays_composite, fused_cp_rays_eval,
                                ray_sums)

    if rs.noise_std == 0:
        res = fused_cp_rays_composite(field, params, ray_o, ray_d, dirs,
                                      z_vals, sigma_only=sigma_only,
                                      sigma_act=rs.sigma_activation)
        return _composited(field, typ, z_vals, rs, results, sigma_only, res)
    rows = fused_cp_rays_eval(field, params, ray_o, ray_d, dirs, z_vals,
                              sigma_only=sigma_only)
    sigmas = rows["sigma"]
    w = _composite_weights(sigmas, z_vals, pass_noise(sigmas),
                           rs.sigma_activation)
    res = {"weights": w} if sigma_only else ray_sums(w, rows, z_vals)
    return _composited(field, typ, z_vals, rs, results, sigma_only, res)


def _inference_in_kernel(composite, field, params, typ, z_vals, dirs, rs,
                         results, sigma_only, ray_o, ray_d) -> dict:
    """Eval-path inference through a fused kernel with in-kernel
    compositing, `composite` its adapter: the flagship PE-MLP's
    (ops/fused_mlp_t.py) or the hash grid's (ops/fused_hash.py).
    Forward-only; eval semantics (noise_std == 0)."""
    res = composite(field, params, ray_o, ray_d, dirs, z_vals,
                    sigma_only=sigma_only, sigma_act=rs.sigma_activation)
    return _composited(field, typ, z_vals, rs, results, sigma_only, res)


def _inference_fused(field, params, typ, z_vals, dirs, rs, results,
                     sigma_only, ray_o, ray_d, pass_noise) -> dict:
    """Inference for the flagship PE-MLP through the rows mode of its
    kernel (ops/fused_mlp.py): one (N·S, 8) row per sample [raw σ, rgb,
    unit normal, mirror]; the noise goes on raw σ, `_composite_weights`
    composites, and the per-ray values come from one weighted sum over the
    sample axis of the (N, S, 8) rows. Forward-only."""
    from ..ops.fused_mlp import fused_rays_eval

    n, s = z_vals.shape
    rows = fused_rays_eval(field, params, ray_o, ray_d, dirs, z_vals,
                           sigma_only=sigma_only).reshape(n, s, -1)
    sigmas = rows[..., 0]
    w = _composite_weights(sigmas, z_vals, pass_noise(sigmas),
                           rs.sigma_activation)
    res = {"weights": w}
    if not sigma_only:
        pmap = (w[..., None] * rows).sum(1)
        res.update(opacity=w.sum(-1), depth=(w * z_vals).sum(-1),
                   rgb=pmap[:, 1:4], normal=pmap[:, 4:7], mirror=pmap[:, 7])
    return _composited(field, typ, z_vals, rs, results, sigma_only, res)


def _composited(field, typ, z_vals, rs, results, sigma_only,
                res: dict) -> dict:
    """The results of a fused pass from its composite: weights (N, S) and,
    unless σ-only, the per-ray opacity/rgb/depth/mirror/normal."""
    weights = res["weights"]
    results[f"weights_{typ}"] = weights
    results[f"z_vals_{typ}"] = z_vals
    if sigma_only:
        results[f"opacity_{typ}"] = weights.sum(-1)
        return results
    results[f"opacity_{typ}"] = res["opacity"]
    rgb_map = res["rgb"]
    if rs.white_back:
        rgb_map = rgb_map + (1.0 - res["opacity"][:, None])
    results[f"rgb_{typ}"] = rgb_map
    results[f"depth_{typ}"] = res["depth"]
    if field.predict_mirror_mask:
        results[f"mirror_mask_{typ}"] = res["mirror"]
    if field.predict_normal:
        results[f"surface_normal_{typ}"] = res["normal"]
    return results


def render_rays(field, params: dict, rays: torch.Tensor, rs: RenderSettings,
                generator: Optional[torch.Generator] = None,
                mirror_mask_gt: Optional[torch.Tensor] = None,
                view_dirs: Optional[torch.Tensor] = None,
                sigma_noise: Optional[dict] = None,
                gt_valid: Optional[torch.Tensor] = None) -> dict:
    """Render a (N, 8) = [o, d, near, far] ray batch through the
    coarse(+fine) fields; result keys suffixed _coarse/_fine. `generator`
    draws the perturbation and σ noise when `rs` asks for them;
    `mirror_mask_gt` (N,) (−1 = no GT mask) gates the outside-mirror detach;
    `view_dirs` overrides the color head's view direction. `sigma_noise`
    replaces the generator's σ-noise draws with pre-drawn standard-normal
    ones (× noise_std): "coarse" (N, N_samples) for the proposal pass,
    "fine" for the pass on the merged samples (or the one proposal-skip
    pass) — the JAX package's k_noise_c and k_noise_f. `gt_valid`, a
    boolean scalar, says whether the batch's GT masks are all valid when
    these rays are one rank's rows of it (by default: all of these are)."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    dirs = rays_d if view_dirs is None else view_dirs
    if mirror_mask_gt is not None and gt_valid is None:
        gt_valid = (mirror_mask_gt >= 0).all()

    def infer(typ, z, sigma_only, pass_name):
        _inference(field, params[typ], typ, rays_o, rays_d, z, dirs, rs,
                   results, sigma_only, mirror_mask_gt, gt_valid,
                   generator=generator,
                   noise=(sigma_noise or {}).get(pass_name))

    results: dict = {}
    if rs.proposal_skip and rs.has_fine:
        z_all = stratified_z_vals(near, far, rs.N_samples + rs.N_importance,
                                  rs.use_disp, rs.perturb, generator)
        typ = "coarse" if rs.fine_pass == "coarse" else "fine"
        infer(typ, z_all, False, "fine")
        results[f"x_surface_{typ}"] = (
            rays_o + rays_d * results[f"depth_{typ}"][:, None])
        return results

    z_vals = stratified_z_vals(near, far, rs.N_samples, rs.use_disp,
                               rs.perturb, generator)
    infer("coarse", z_vals, rs.test_time and rs.has_fine, "coarse")

    if rs.has_fine:
        z_fine = merge_fine_z_vals(z_vals, results["weights_coarse"],
                                   rs.N_importance, rs.perturb, generator)
        # fine_pass "coarse" (only_one_field past warm-up) overwrites the
        # coarse results with a second pass of the coarse field
        typ = "coarse" if rs.fine_pass == "coarse" else "fine"
        infer(typ, z_fine, False, "fine")

    for typ in ("coarse", "fine"):
        if f"depth_{typ}" in results:
            results[f"x_surface_{typ}"] = (
                rays_o + rays_d * results[f"depth_{typ}"][:, None])
    return results
