"""Eval-side Whitted tracing and the per-view render loop (torch counterpart of
`mirror_nerf_tpu/eval/apps.py`).

The eval tracer: the mirror mask comes from the thresholded prediction;
rendering is deterministic (perturb 0, noise 0) and `test_time` skips the
coarse rgb pass; secondary rays below level 1 are compacted into a fixed
capacity picked per view by a low-res prepass. The compaction is the JAX
package's cumsum-slot scheme — capacity rounded to 128, an overflow slot,
per-ray `compact_dropped` — so results match it even when a view
overflows. The four applications (new mirror, roughness, substitution,
guest objects) raise until their slice lands (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..core.mathutil import l2_normalize, reflect
from ..render.renderer import (RenderSettings, check_secondary_render,
                               render_rays)
from ..render.tracer import RAY_FORWARD_OFFSET

_APP_FLAGS = ("app_place_new_mirror", "app_control_mirror_roughness",
              "app_reflection_substitution",
              "app_reflect_newly_placed_objects")


@dataclass(frozen=True)
class EvalAppFlags:
    """Application switches of an eval trace. The port renders plain novel
    views only; any application raises in `eval_trace`."""

    place_new_mirror: object = None
    roughness: bool = False
    substitution: bool = False
    reflect_objects: bool = False
    near: float = 0.05

    @property
    def any_app(self) -> bool:
        return (self.place_new_mirror is not None or self.roughness
                or self.substitution or self.reflect_objects)


def _apps_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item 3 "
        "(applications)")


def _resolve_pred_mask(results: dict, sel: str):
    for key in (f"mirror_mask_{sel}", "mirror_mask_fine",
                "mirror_mask_coarse"):
        if key in results:
            return (results[key] > 0.5).to(torch.float32)
    return None


def eval_trace(field, params: dict, rays: torch.Tensor, rs: RenderSettings,
               app: EvalAppFlags, max_recursive_level: int,
               trace_secondary_rays: bool, level: int = 0,
               compact_frac: float = 1.0, compact_from_level: int = 1,
               rs_secondary: Optional[RenderSettings] = None) -> dict:
    """One eval render level + (optionally) the traced reflection below it."""
    if app.any_app:
        raise _apps_not_ported("an eval application")
    if level > 0 and rs_secondary is not None:
        rs = rs_secondary
    results = render_rays(field, params, rays, rs)
    sel = "fine" if rs.fine_pass == "fine" else "coarse"
    results[f"rgb_{sel}_reflect"] = torch.zeros_like(results[f"rgb_{sel}"])
    results[f"depth_{sel}_reflect"] = torch.zeros_like(
        results[f"depth_{sel}"])

    mirror_mask = _resolve_pred_mask(results, sel)
    if mirror_mask is None:
        mirror_mask = torch.zeros(rays.shape[0], dtype=torch.float32,
                                  device=rays.device)
    if not (trace_secondary_rays and level < max_recursive_level):
        results["mirror_mask_resolved"] = mirror_mask
        return results

    d = rays[:, 3:6]
    far = rays[:, 7:8]
    secondary_o = results[f"x_surface_{sel}"]
    reflect_dir = reflect(d, l2_normalize(results[f"surface_normal_{sel}"]))
    results["reflect_direction"] = reflect_dir
    results["secondary_rays_o"] = secondary_o
    secondary = torch.cat(
        [secondary_o, reflect_dir, torch.full_like(far, RAY_FORWARD_OFFSET),
         far], dim=-1)

    def _trace_bundle(bundle):
        return eval_trace(field, params, bundle, rs, app,
                          max_recursive_level, trace_secondary_rays,
                          level + 1, compact_frac, compact_from_level,
                          rs_secondary)

    n = rays.shape[0]
    if (compact_frac < 1.0 and level >= compact_from_level
            and int(n * compact_frac) < n):
        # fixed-capacity compaction: mirror rays land in cumsum-assigned
        # slots (slot `cap` takes the overflow and is dropped), results
        # scatter back; non-mirror rays are never traced (blend weight 0)
        cap = min(max((int(n * compact_frac) + 127) // 128 * 128, 128), n)
        keep = mirror_mask > 0.5
        pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1
        valid = keep & (pos < cap)
        slot = torch.where(valid, pos, torch.full_like(pos, cap))
        buf = torch.zeros((cap + 1,) + secondary.shape[1:],
                          dtype=secondary.dtype, device=secondary.device)
        buf[slot] = secondary
        sec_sub = _trace_bundle(buf[:cap])
        pos_c = torch.clamp(pos, 0, cap - 1)

        def _expand(v):
            mask = valid.reshape((n,) + (1,) * (v.ndim - 1))
            return torch.where(mask, v[pos_c], torch.zeros((), dtype=v.dtype,
                                                           device=v.device))

        sec = {k: _expand(v) for k, v in sec_sub.items()
               if k.startswith(("rgb_", "depth_"))}
        # overflow guard: per-ray indicator of mirror rays dropped past
        # capacity (here + deeper levels)
        dropped = (keep & ~valid).to(torch.float32)
        if "compact_dropped" in sec_sub:
            dropped = dropped + _expand(sec_sub["compact_dropped"])
        results["compact_dropped"] = dropped
    else:
        sec = _trace_bundle(secondary)
        if "compact_dropped" in sec:
            results["compact_dropped"] = sec["compact_dropped"]

    m = mirror_mask[:, None]
    base = results[f"rgb_{sel}"]
    results[f"rgb_{sel}_direct"] = base
    results[f"rgb_{sel}"] = m * sec[f"rgb_{sel}"] + (1.0 - m) * base
    results[f"rgb_{sel}_reflect"] = (
        sec[f"rgb_{sel}"] if level == 0 else m * sec[f"rgb_{sel}"])
    results[f"depth_{sel}_reflect"] = (
        sec[f"depth_{sel}"] if level == 0
        else mirror_mask * sec[f"depth_{sel}"])
    results["mirror_mask_resolved"] = mirror_mask
    return results


# ---- host-side orchestration ----


@dataclass
class AppContext:
    cfg: object
    field: object
    params: dict
    rs: RenderSettings
    app: EvalAppFlags
    device: torch.device
    # reduced secondary-bounce sample budget (None = same as rs)
    rs_sec: Optional[RenderSettings] = None

    @classmethod
    def build(cls, cfg, args, field, params, device) -> "AppContext":
        for flag in _APP_FLAGS:
            if getattr(args, flag):
                raise _apps_not_ported(f"--{flag}")
        if cfg.num_gpus > 1:
            raise NotImplementedError(
                "multi-GPU eval is not ported yet: ROADMAP.md queue 1, "
                "item 9 (torch.distributed)")
        rs = RenderSettings(
            N_samples=cfg.N_samples, N_importance=cfg.N_importance,
            use_disp=cfg.use_disp, perturb=0.0, noise_std=0.0,
            white_back=False, test_time=not args.render_coarse_rgb,
            compute_normal=cfg.trace_secondary_rays and not cfg.predict_normal,
            fine_pass=("fine" if cfg.N_importance > 0
                       and not cfg.only_one_field
                       else ("coarse" if cfg.N_importance > 0 else "none")),
            fused_field=args.fused_field,
            proposal_skip=args.proposal_skip,
            sigma_activation=cfg.sigma_activation,
        )
        if rs.compute_normal:
            raise NotImplementedError(
                "the eval tracer reflects about the predicted normal: "
                "tracing without --predict_normal is not ported yet "
                "(ROADMAP.md queue 1, item 10)")
        rs_sec = None
        sec_ns = args.secondary_N_samples
        sec_ni = args.secondary_N_importance
        if sec_ns >= 0 or sec_ni >= 0:
            rs_sec = replace(
                rs, N_samples=sec_ns if sec_ns >= 0 else cfg.N_samples,
                N_importance=sec_ni if sec_ni >= 0 else cfg.N_importance)
            check_secondary_render(rs, rs_sec)
        if rs.proposal_skip and args.render_coarse_rgb:
            raise ValueError("--proposal_skip renders no coarse pass; drop "
                             "--render_coarse_rgb")
        return cls(cfg=cfg, field=field, params=params, rs=rs,
                   app=EvalAppFlags(near=cfg.near),
                   device=torch.device(device), rs_sec=rs_sec)


def _pad(arr: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return torch.cat([arr, arr[-1:].expand(pad, -1)], dim=0)


CAPACITY_BUCKETS = (0.125, 0.25, 0.5, 1.0)


def _keep_eval_key(kk: str) -> bool:
    """Eval output filter: drop per-sample buffers the writers never read."""
    return not kk.startswith(("weights_", "z_vals_", "pred_normal_"))


@torch.no_grad()
def estimate_mirror_fraction(ctx: AppContext, rays_all: torch.Tensor) -> float:
    """Cheap low-res prepass: the level-0 mirror-mask fraction of this view
    over 2048 strided rays, used to pick the secondary-ray capacity."""
    n = rays_all.shape[0]
    stride = max(n // 2048, 1)
    sub = _pad(rays_all[::stride][:2048], 2048)
    mask = eval_trace(ctx.field, ctx.params, sub, ctx.rs, ctx.app,
                      max_recursive_level=0,
                      trace_secondary_rays=False)["mirror_mask_resolved"]
    return float(mask.mean())


def pick_capacity(frac: float) -> float:
    """Smallest capacity bucket covering the estimate with safety margin."""
    need = min(frac * 1.3 + 0.03, 1.0)
    for b in CAPACITY_BUCKETS:
        if b >= need:
            return b
    return 1.0


@torch.no_grad()
def run_view(ctx: AppContext, sample: dict) -> dict:
    """Render one full view through fixed-size chunks; returns numpy dict."""
    cfg = ctx.cfg
    rays_all = torch.as_tensor(np.asarray(sample["rays"], np.float32),
                               device=ctx.device)
    n = rays_all.shape[0]
    chunk = min(cfg.chunk, n)
    if cfg.trace_secondary_rays and cfg.max_recursive_level > 0:
        compact_frac = pick_capacity(estimate_mirror_fraction(ctx, rays_all))
    else:
        compact_frac = 1.0

    outs: dict = {}
    for start in range(0, n, chunk):
        res = eval_trace(ctx.field, ctx.params,
                         _pad(rays_all[start:start + chunk], chunk), ctx.rs,
                         ctx.app, cfg.max_recursive_level,
                         cfg.trace_secondary_rays, compact_frac=compact_frac,
                         compact_from_level=1, rs_secondary=ctx.rs_sec)
        valid = min(chunk, n - start)
        for kk, vv in res.items():
            if _keep_eval_key(kk):
                outs.setdefault(kk, []).append(vv[:valid])
    return {kk: torch.cat(v, 0).cpu().numpy() for kk, v in outs.items()}
