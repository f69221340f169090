"""Whitted-style recursive ray tracer over the volume renderer (torch
counterpart of `mirror_nerf_tpu/render/tracer.py`), the training side.

One render per bounce level, recursion to `max_recursive_level`:

  * the mirror mask is the GT mask at level 0 when it is valid, else the
    thresholded detached prediction; it is never differentiated, so the
    blend trains the reflection colors and the mask head only through its
    own loss;
  * with `only_trace_rays_in_mirrors` every ray is traced and non-mirror
    rays are blended with weight 0, or, with `compact_frac < 1`, the mirror
    rays are packed into a fixed-capacity buffer by cumsum-assigned slots
    (overflow counted per ray in `compact_dropped`), traced, and scattered
    back;
  * the surface normal driving the reflection keeps its gradient unless
    `detach_normal_in_reflection`; `detach_ref_color_for_blend` stops the
    gradient into the reflected color.

The eval tracer (`eval/apps.py eval_trace`) stays a separate function, as in
the JAX package: it resolves masks from the prediction only and carries the
per-view capacity and the application hooks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core.mathutil import l2_normalize, reflect
from .renderer import RenderSettings, render_rays

# offset pushing secondary-ray origins off the mirror surface
# (reference train.py:232: ray_forward_offset = 0.1)
RAY_FORWARD_OFFSET = 0.1


@dataclass(frozen=True)
class TraceSettings:
    """Static trace configuration (resolved per stage/epoch)."""

    render: RenderSettings = RenderSettings()
    # True when tracing is enabled AND we are past the geometry stage
    trace_secondary_rays: bool = True
    max_recursive_level: int = 1
    # "train": the CLI flag at every level; "eval": level 0 traces
    # everything, deeper levels only mirror rays
    only_trace_mode: str = "train"
    only_trace_rays_in_mirrors: bool = False
    detach_normal_in_reflection: bool = False
    detach_ref_color_for_blend: bool = False
    is_eval: bool = False
    # fixed-capacity compaction of secondary rays at levels where
    # only_in_mirrors holds; 1.0 traces everything
    compact_frac: float = 1.0
    # reduced sample budget for bounce levels >= 1 (None = `render`)
    secondary_render: Optional[RenderSettings] = None
    # also compact the level-0 secondary trace
    compact_level0: bool = False

    def only_in_mirrors(self, level: int) -> bool:
        if self.only_trace_mode == "eval":
            return level >= 1
        return self.only_trace_rays_in_mirrors

    def compact_at(self, level: int) -> bool:
        return self.only_in_mirrors(level) or (level == 0
                                               and self.compact_level0)

    @property
    def select_type(self) -> str:
        return "fine" if self.render.fine_pass == "fine" else "coarse"


def _resolve_mirror_mask(results: dict, gt_mask: torch.Tensor,
                         level: int) -> torch.Tensor:
    """Hard {0,1} mirror mask for this bounce: the GT mask at level 0 when
    it is valid, else the thresholded detached prediction."""
    sel = None
    for typ in ("fine", "coarse"):
        if f"mirror_mask_{typ}" in results:
            sel = results[f"mirror_mask_{typ}"]
            break
    if sel is None:
        return torch.zeros_like(gt_mask)
    pred = (sel.detach() > 0.5).to(gt_mask.dtype)
    if level > 0:
        return pred
    return torch.where((gt_mask < 0).any(), pred, gt_mask)


def _surface_normal(ts: TraceSettings, results: dict) -> torch.Tensor:
    """Normal driving the reflection: the predicted head if present, else
    the σ-gradient normal."""
    sel = ts.select_type
    if f"surface_normal_{sel}" in results:
        n = results[f"surface_normal_{sel}"]
    elif f"pred_normal_{sel}" in results:
        n = (results[f"pred_normal_{sel}"]
             * results[f"weights_{sel}"][..., None]).sum(1)
    elif f"surface_normal_grad_{sel}" in results:
        n = results[f"surface_normal_grad_{sel}"]
    else:
        n = (results[f"normal_{sel}"]
             * results[f"weights_{sel}"][..., None]).sum(1)
    if ts.detach_normal_in_reflection:
        n = n.detach()
    return l2_normalize(n)


def next_level_settings(field, ts: TraceSettings) -> TraceSettings:
    """TraceSettings for the next (deeper) bounce. With a predicted-normal
    field, deeper bundles never read their σ-gradient normals (reflection
    uses the head's normal, the normal losses read level 0 only), so
    compute_normal is switched off there, on both the next render and the
    carried secondary_render so that it stays off at every deeper level."""
    rs_next = ts.secondary_render if ts.secondary_render is not None \
        else ts.render
    sec_next = ts.secondary_render
    if field.predict_normal and rs_next.compute_normal:
        rs_next = replace(rs_next, compute_normal=False)
    if field.predict_normal and sec_next is not None \
            and sec_next.compute_normal:
        sec_next = replace(sec_next, compute_normal=False)
    if rs_next is ts.render and sec_next is ts.secondary_render:
        return ts
    return replace(ts, render=rs_next, secondary_render=sec_next)


def trace_rays(field, params: dict, rays: torch.Tensor,
               mirror_mask_gt: torch.Tensor, ts: TraceSettings,
               generator: Optional[torch.Generator] = None, level: int = 0,
               mirror_mask_prev: Optional[torch.Tensor] = None) -> dict:
    """Render `rays` (N, 8) with GT masks (N,) (−1 = none) and trace their
    reflections; `generator` draws the perturbation and σ noise."""
    results = render_rays(field, params, rays, ts.render, generator,
                          mirror_mask_gt=mirror_mask_gt)
    sel = ts.select_type
    mirror_mask = _resolve_mirror_mask(results, mirror_mask_gt, level)
    if (not ts.only_in_mirrors(level) and level > 0
            and mirror_mask_prev is not None):
        mirror_mask = mirror_mask * mirror_mask_prev.detach()

    if not (ts.trace_secondary_rays and level < ts.max_recursive_level):
        if ts.is_eval:
            for typ in ("coarse", "fine"):
                if f"rgb_{typ}" in results:
                    zeros = torch.zeros_like(results[f"rgb_{typ}"])
                    results[f"rgb_{typ}_reflect"] = zeros
                    results[f"rgb_{typ}_direct"] = zeros
            if f"depth_{sel}" in results:
                results[f"depth_{sel}_reflect"] = torch.zeros_like(
                    results[f"depth_{sel}"])
                results["secondary_rays_o"] = torch.zeros_like(
                    results[f"rgb_{sel}"])
                results["reflect_direction"] = torch.zeros_like(
                    results[f"rgb_{sel}"])
        results["mirror_mask_resolved"] = mirror_mask
        return results

    far = rays[:, 7:8]
    secondary_o = results[f"x_surface_{sel}"]
    reflect_dir = reflect(rays[:, 3:6], _surface_normal(ts, results))
    secondary = torch.cat([secondary_o, reflect_dir,
                           torch.full_like(far, RAY_FORWARD_OFFSET), far],
                          dim=-1)
    ts_next = next_level_settings(field, ts)

    n = rays.shape[0]
    if (ts.compact_frac < 1.0 and ts.compact_at(level)
            and int(n * ts.compact_frac) < n):
        # mirror rays keep their order and land in cumsum-assigned slots;
        # slot `cap` takes the overflow and is dropped. Exact while the
        # mirror rays fit; non-mirror rays are never traced (blend weight 0)
        cap = min(max((int(n * ts.compact_frac) + 127) // 128 * 128, 128), n)
        keep = mirror_mask.detach() > 0.5
        pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1
        valid = keep & (pos < cap)
        slot = torch.where(valid, pos, torch.full_like(pos, cap))

        def _compact(arr):
            buf = arr.new_zeros((cap + 1,) + arr.shape[1:])
            return buf.index_put((slot,), arr)[:cap]

        sec_sub = trace_rays(field, params, _compact(secondary),
                             _compact(mirror_mask_gt), ts_next, generator,
                             level + 1, _compact(mirror_mask))
        pos_c = torch.clamp(pos, 0, cap - 1)

        def _expand(v):
            mask = valid.reshape((n,) + (1,) * (v.ndim - 1))
            return torch.where(mask, v[pos_c], v.new_zeros(()))

        sec = {k: _expand(v) for k, v in sec_sub.items()
               if k.startswith(("rgb_", "depth_"))}
        # overflow guard: mirror rays dropped past capacity here, plus any
        # dropped deeper (expanded to this level's rays)
        dropped = (keep & ~valid).to(torch.float32)
        if "compact_dropped" in sec_sub:
            dropped = dropped + _expand(sec_sub["compact_dropped"])
        results["compact_dropped"] = dropped
    else:
        sec = trace_rays(field, params, secondary, mirror_mask_gt, ts_next,
                         generator, level + 1, mirror_mask)
        if "compact_dropped" in sec:
            results["compact_dropped"] = sec["compact_dropped"]

    m = mirror_mask[:, None]  # {0, 1}, never differentiated
    for typ in ("coarse", "fine"):
        if f"rgb_{typ}" in results and f"rgb_{typ}" in sec:
            base = results[f"rgb_{typ}"]
            results[f"rgb_{typ}_direct"] = base
            reflection = sec[f"rgb_{typ}"]
            if ts.detach_ref_color_for_blend:
                reflection = reflection.detach()
            results[f"rgb_{typ}"] = m * reflection + (1.0 - m) * base
            if ts.is_eval:
                results[f"rgb_{typ}_reflect"] = (
                    m * sec[f"rgb_{typ}"] if ts.only_in_mirrors(level)
                    else sec[f"rgb_{typ}"])
    if ts.is_eval:
        results[f"depth_{sel}_reflect"] = (
            mirror_mask * sec[f"depth_{sel}"] if ts.only_in_mirrors(level)
            else sec[f"depth_{sel}"])
        results["secondary_rays_o"] = secondary_o
        results["reflect_direction"] = reflect_dir
    results["mirror_mask_resolved"] = mirror_mask
    return results
