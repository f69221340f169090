"""Eval-side Whitted tracing, the four applications and the per-view render
loop (torch counterpart of `mirror_nerf_tpu/eval/apps.py`).

The eval tracer: the mirror mask comes from the thresholded prediction;
it reflects about the predicted normal, or without `--predict_normal`
about the σ-gradient normal (`_surface_normal_eval`);
rendering is deterministic (perturb 0, noise 0) and `test_time` skips the
coarse rgb pass; secondary rays below level 1 are compacted into a fixed
capacity picked per view by a low-res prepass. The compaction is the JAX
package's cumsum-slot scheme — capacity rounded to 128, an overflow slot,
per-ray `compact_dropped` — so results match it even when a view
overflows. Above 3 levels, without substitution, guest objects or
roughness, a view takes the deep trace (`eval_trace_deep`): one level at a
time front to back, until no throughput is left.

Applications (the reference CLI's flags):
  * place_new_mirror: a virtual planar mirror — ray/plane hit, rectangle
    clip, on-ray test, occlusion by the rendered depth — overriding the
    normal, mirror mask, depth and secondary origins (`_inject_plane_mirror`;
    at level 0 of `eval_trace`, at every level of `eval_trace_deep`);
  * control_mirror_roughness: glossy reflection, the mean of
    `trace_ray_times` + 1 secondary bundles about Gaussian-perturbed normals
    (`roughness_bundle`, `roughness_average`; the noise from a
    `torch.Generator` seeded from the view and the chunk);
  * reflection_substitution: the level-0 secondary rays rendered in a second
    checkpoint's field, moved by the scene's rigid transform;
  * reflect_newly_placed_objects: a guest field (models/guests.py) rendered
    along the same rays and depth-composited before the mask is resolved;
    where it is drawn the mirror mask clears (`_composite_object`).
Every render goes through `render_rays`, so each application runs the
model's eval kernels on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.mathutil import l2_normalize, reflect
from ..parallel.mesh import compact_slots, pad_to_multiple
from ..render.renderer import (RenderSettings, check_secondary_render,
                               render_rays)
from ..render.tracer import RAY_FORWARD_OFFSET

# ---- scene-preset tables (reference eval.py:369-433, 551-594, 178-189) ----


@dataclass(frozen=True)
class PlaneMirrorSpec:
    axis: int  # 0 = plane x=v, 1 = plane y=v
    value: float
    normal: Tuple[float, float, float]
    rec_bound: Tuple[float, float, float, float]


def plane_preset(plane_pos: str, root_dir: str) -> PlaneMirrorSpec:
    if plane_pos == "plane_x":
        if "livingroom" in root_dir:
            return PlaneMirrorSpec(0, 0.0, (-1, 0, 0), (-1, 1, -0.5, 0.5))
        if "washroom" in root_dir:
            return PlaneMirrorSpec(0, -1.0, (1, 0, 0), (-1, 1, -1, 0.75))
        if "office" in root_dir:
            return PlaneMirrorSpec(0, 1.0, (1, 0, 0), (-1, 1, -1, 0.75))
        return PlaneMirrorSpec(0, -1.0, (1, 0, 0), (-1, 1, -0.5, 0.5))
    # plane_y
    if "washroom" in root_dir:
        return PlaneMirrorSpec(1, 1.3, (0, -1, 0), (-1, 1, -1, 1))
    if "livingroom" in root_dir:
        return PlaneMirrorSpec(1, 1.65, (0, -1, 0), (-0.3, 1.5, -0.5, 1))
    if "office" in root_dir:
        return PlaneMirrorSpec(1, 0.0, (0, -1, 0), (-1, 1, -0.5, 0.5))
    return PlaneMirrorSpec(1, 1.0, (0, -1, 0), (-1, 1, -0.5, 0.5))


def substitution_transform(root_dir: str):
    """(rotation 3x3 or None, translation, scale) for the substituted field."""
    if "office" in root_dir:
        return None, (0.0, 1.0, 0.0), 1.0
    if "market" in root_dir:
        rot = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
        return rot, (0.0, 0.0, 0.0), 1.0
    return None, (0.0, 0.0, 0.0), 1.0


def object_transform(root_dir: str):
    """(translation, scale) mapping scene rays into the object field."""
    if "livingroom" in root_dir:
        return (0.0, 0.0, 0.0), 2.0
    if "washroom" in root_dir:
        return (-0.5, -0.5, 0.0), 2.0
    if "office" in root_dir:
        return (0.0, 3.0, 0.5), 2.0
    return (0.0, 0.0, 0.0), 1.0


# ---- static eval-trace configuration ----


@dataclass(frozen=True)
class EvalAppFlags:
    """Application switches of an eval trace."""

    place_new_mirror: Optional[PlaneMirrorSpec] = None
    roughness: bool = False
    substitution: bool = False
    reflect_objects: bool = False
    near: float = 0.05  # for the valid-depth occlusion masks


@dataclass(frozen=True)
class SubstitutedField:
    """The substitution app's field and its rigid transform
    (`substitution_transform`)."""

    field: object
    transform: tuple = (None, (0.0, 0.0, 0.0), 1.0)


def _resolve_pred_mask(results: dict, sel: str):
    for key in (f"mirror_mask_{sel}", "mirror_mask_fine",
                "mirror_mask_coarse"):
        if key in results:
            return (results[key] > 0.5).to(torch.float32)
    return None


def _mirror_mask_key(results: dict, sel: str) -> Optional[str]:
    """The first mirror-mask key the results hold, or None."""
    for key in (f"mirror_mask_{sel}", "mirror_mask_fine",
                "mirror_mask_coarse"):
        if key in results:
            return key
    return None


def _surface_normal_eval(results: dict, sel: str) -> torch.Tensor:
    """The normal the eval tracer reflects about: the predicted normal's
    composite, else the σ-gradient normal's (`--predict_normal` off)."""
    if f"surface_normal_{sel}" in results:
        return results[f"surface_normal_{sel}"]
    if f"pred_normal_{sel}" in results:
        return (results[f"pred_normal_{sel}"]
                * results[f"weights_{sel}"][..., None]).sum(1)
    if f"surface_normal_grad_{sel}" in results:
        return results[f"surface_normal_grad_{sel}"]
    return (results[f"normal_{sel}"]
            * results[f"weights_{sel}"][..., None]).sum(1)


def _secondary_rays(secondary_o, reflect_dir, rays) -> torch.Tensor:
    """(N, 8) secondary rays: origin, direction, the forward offset as
    near, the primary's far."""
    far = rays[:, 7:8]
    return torch.cat([secondary_o, reflect_dir,
                      torch.full_like(far, RAY_FORWARD_OFFSET), far], dim=-1)


def _inject_plane_mirror(app: EvalAppFlags, rays, results: dict, sel: str,
                         mirror_mask, normal, secondary_o):
    """Virtual planar mirror (reference eval.py:364-504), fully masked: a
    ray whose hit on the plane lies in its rectangle, ahead of the origin
    and in front of the rendered depth (where that is above `near`) becomes
    a mirror ray with the plane's normal, its hit as the secondary origin
    and the hit's distance as its depth."""
    spec = app.place_new_mirror
    o, d = rays[:, 0:3], rays[:, 3:6]
    ax = spec.axis
    other = [(1, 2), (0, 2)][ax]  # in-plane coordinate axes for the rect clip
    dax = d[:, ax]
    t = (spec.value - o[:, ax]) / torch.where(dax.abs() < 1e-9, 1e-9, dax)
    hit = o + t[:, None] * d  # (N, 3) intersection with the infinite plane
    u, v = hit[:, other[0]], hit[:, other[1]]
    b = spec.rec_bound
    new_mask = (u >= b[0]) & (u <= b[1]) & (v >= b[2]) & (v <= b[3])
    # on the ray (not its reverse extension)
    new_mask = new_mask & (((hit - o) * d).sum(-1) > 0)
    # foreground occlusion by the rendered scene depth
    depth = results[f"depth_{sel}"]
    depth_new = torch.linalg.norm(o - hit, dim=-1)
    blocked = (depth_new > depth) & (depth > app.near)
    new_mask = new_mask & ~blocked

    nm = new_mask[:, None]
    normal = torch.where(nm, torch.tensor(spec.normal, dtype=normal.dtype,
                                          device=normal.device), normal)
    secondary_o = torch.where(nm, hit, secondary_o)
    mirror_mask = torch.where(new_mask, 1.0, mirror_mask)
    results[f"depth_{sel}"] = torch.where(new_mask, depth_new, depth)
    key = _mirror_mask_key(results, sel)
    if key is not None:
        results[key] = mirror_mask
    return results, mirror_mask, normal, secondary_o


def _composite_object(app: EvalAppFlags, obj_render_fn, rays,
                      results: dict, sel: str, frame_time: float) -> dict:
    """Depth-composite a guest object field (reference eval.py:173-291):
    the rays mapped into the object's frame (x·scale + translation), its
    depth back by 1/scale; drawn where its opacity is above 0.8 and it is
    in front of the rendered depth (above `near`), and there the mirror
    mask clears."""
    translation, scale = obj_render_fn.transform
    rays_obj = rays.clone()
    rays_obj[:, 0:3] = rays[:, 0:3] * scale + torch.tensor(
        translation, dtype=rays.dtype, device=rays.device)
    obj = obj_render_fn(rays_obj, frame_time)  # {"rgb", "depth", "opacity"}
    obj_depth = obj["depth"] / scale
    depth = results[f"depth_{sel}"]
    mask_obj = (obj_depth > 0) & (obj["opacity"] > 0.8)
    blocked = (obj_depth > depth) & (depth > app.near)
    use_obj = mask_obj & ~blocked
    results[f"rgb_{sel}"] = torch.where(use_obj[:, None], obj["rgb"],
                                        results[f"rgb_{sel}"])
    results[f"depth_{sel}"] = torch.where(use_obj, obj_depth, depth)
    key = _mirror_mask_key(results, sel)
    if key is not None:
        results[key] = torch.where(use_obj, 0.0, results[key])
    return results


def _render_substituted(subst_field: SubstitutedField, subst_params: dict,
                        bundle, rs: RenderSettings) -> dict:
    """The substitution app's secondary render: origins and directions
    rotated by R (the directions renormalized), the origins scaled and
    translated, then rendered in the substituted field."""
    rot, translation, scale = subst_field.transform
    so, sd = bundle[:, 0:3], bundle[:, 3:6]
    if rot is not None:
        # x @ Rᵀ as elementwise sums: positions stay out of reduced-
        # precision matmuls
        R = torch.as_tensor(np.asarray(rot, np.float32), device=so.device)
        so = (so[:, None, :] * R[None]).sum(-1)
        sd = l2_normalize((sd[:, None, :] * R[None]).sum(-1))
    so = so * scale + torch.tensor(translation, dtype=so.dtype,
                                   device=so.device)
    bundle = torch.cat([so, sd, bundle[:, 6:8]], dim=-1)
    return render_rays(subst_field.field, subst_params, bundle, rs)


def eval_trace(field, params: dict, rays: torch.Tensor, rs: RenderSettings,
               app: EvalAppFlags, max_recursive_level: int,
               trace_secondary_rays: bool, level: int = 0,
               compact_frac: float = 1.0, compact_from_level: int = 1,
               rs_secondary: Optional[RenderSettings] = None, *,
               subst_params: Optional[dict] = None, subst_field=None,
               obj_render_fn: Optional[Callable] = None,
               frame_time: float = 0.0,
               normal_noise: Optional[torch.Tensor] = None, group=None,
               n_global: Optional[int] = None,
               real: Optional[torch.Tensor] = None) -> dict:
    """One eval render level + (optionally) the traced reflection below it.
    `normal_noise` (N, 3) perturbs the level-0 normal (roughness);
    `subst_params` / `subst_field` render the level-0 secondary rays in
    the substituted field; `obj_render_fn` composites a guest object at
    `frame_time` into every level. With a `group` the rays are this rank's
    rows of the chunk, and the compaction's slots are the whole chunk's
    (`n_global` rays at this level; `real`, which rows hold one), as in
    `render/tracer.py trace_rays`."""
    if level > 0 and rs_secondary is not None:
        rs = rs_secondary
    results = render_rays(field, params, rays, rs)
    sel = "fine" if rs.fine_pass == "fine" else "coarse"
    results[f"rgb_{sel}_reflect"] = torch.zeros_like(results[f"rgb_{sel}"])
    results[f"depth_{sel}_reflect"] = torch.zeros_like(
        results[f"depth_{sel}"])

    if app.reflect_objects and obj_render_fn is not None:
        results = _composite_object(app, obj_render_fn, rays, results, sel,
                                    frame_time)

    mirror_mask = _resolve_pred_mask(results, sel)
    if mirror_mask is None:
        mirror_mask = torch.zeros(rays.shape[0], dtype=torch.float32,
                                  device=rays.device)
    do_trace = ((trace_secondary_rays or app.place_new_mirror is not None)
                and level < max_recursive_level)
    if not do_trace:
        results["mirror_mask_resolved"] = mirror_mask
        return results

    d = rays[:, 3:6]
    secondary_o = results[f"x_surface_{sel}"]
    normal = _surface_normal_eval(results, sel)
    if app.place_new_mirror is not None and level == 0:
        results, mirror_mask, normal, secondary_o = _inject_plane_mirror(
            app, rays, results, sel, mirror_mask, normal, secondary_o)
    if level == 0:
        # the unperturbed surface normal, for the roughness bundles
        results["_normal_presmooth"] = normal
        if normal_noise is not None:
            normal = normal + normal_noise
    reflect_dir = reflect(d, l2_normalize(normal))
    results["reflect_direction"] = reflect_dir
    results["secondary_rays_o"] = secondary_o
    secondary = _secondary_rays(secondary_o, reflect_dir, rays)

    def _trace_bundle(bundle):
        """Render a secondary-ray bundle: substitution field or recursion."""
        if app.substitution and subst_params is not None:
            return _render_substituted(
                subst_field, subst_params, bundle,
                rs_secondary if rs_secondary is not None else rs)
        return eval_trace(field, params, bundle, rs, app,
                          max_recursive_level, trace_secondary_rays,
                          level + 1, compact_frac, compact_from_level,
                          rs_secondary, subst_params=subst_params,
                          subst_field=subst_field,
                          obj_render_fn=obj_render_fn, frame_time=frame_time,
                          group=group, n_global=n_next, real=real_next)

    n = rays.shape[0]
    n_all = n if group is None else (n_global or n * group.world)
    n_next, real_next = n_all, real
    if (compact_frac < 1.0 and level >= compact_from_level
            and int(n_all * compact_frac) < n_all):
        # fixed-capacity compaction: mirror rays land in cumsum-assigned
        # slots (slot `size` takes the overflow and is dropped), results
        # scatter back; non-mirror rays are never traced (blend weight 0)
        cap = min(max((int(n_all * compact_frac) + 127) // 128 * 128, 128),
                  n_all)
        keep = mirror_mask > 0.5
        if real is not None:
            keep = keep & real
        pos, valid, size, real_next = compact_slots(keep, cap, group)
        n_next = cap
        slot = torch.where(valid, pos, torch.full_like(pos, size))
        buf = torch.zeros((size + 1,) + secondary.shape[1:],
                          dtype=secondary.dtype, device=secondary.device)
        buf[slot] = secondary
        sec_sub = _trace_bundle(buf[:size])
        pos_c = torch.clamp(pos, 0, size - 1)

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
    results["_sec_rgb"] = sec[f"rgb_{sel}"]  # for roughness averaging
    return results


def eval_trace_deep(field, params: dict, rays: torch.Tensor,
                    rs: RenderSettings, app: EvalAppFlags,
                    max_recursive_level: int, trace_secondary_rays: bool,
                    rs_secondary: Optional[RenderSettings] = None,
                    levels: Optional[list] = None, group=None) -> dict:
    """The deep Whitted trace (e.g. the new-mirror app's 50 levels,
    run.sh mode 3), front to back: carry the rays, the throughput T = Π of
    the mirror masks so far and the accumulated rgb; each level renders the
    whole chunk once, adds T·(1 − m)·base, multiplies T by m and reflects
    the rays, until no throughput is left (one host read a level, as the
    reference's `mirror_mask.any()`, eval.py:312-319) or the last level,
    which contributes unblended (m forced to 0). This equals the
    recursive blend (1−m0)b0 + m0[(1−m1)b1 + m1[…]].

    Level 0 renders at `rs`, every later level at `rs_secondary` (same key
    structure, `check_secondary_render`). The new mirror is injected at
    every level, so inter-reflections happen. The reflect outputs are the
    blended secondary colour and the level-1 depth, both masked by the
    level-0 mirror mask; `_deep_levels` the deepest level rendered (guest
    objects never take this trace). `levels`, a list, receives each
    level's (T after it, its rendered rgb), level 0 first. With a `group`
    the rays are this rank's rows of the chunk, and the trace goes on while
    any rank's rays have throughput."""
    check_secondary_render(rs, rs_secondary)
    sel = "fine" if rs.fine_pass == "fine" else "coarse"
    n = rays.shape[0]

    def render_level(rays_l, rs_l):
        res = render_rays(field, params, rays_l, rs_l)
        mask = _resolve_pred_mask(res, sel)
        if mask is None:
            mask = torch.zeros(n, dtype=torch.float32, device=rays_l.device)
        secondary_o = res[f"x_surface_{sel}"]
        normal = _surface_normal_eval(res, sel)
        if app.place_new_mirror is not None:
            res, mask, normal, secondary_o = _inject_plane_mirror(
                app, rays_l, res, sel, mask, normal, secondary_o)
        reflect_dir = reflect(rays_l[:, 3:6], l2_normalize(normal))
        nxt = _secondary_rays(secondary_o, reflect_dir, rays_l)
        return res, mask, nxt, secondary_o, reflect_dir

    res0, m0, rays_l, sec_o0, refl0 = render_level(rays, rs)
    results = dict(res0)
    results["secondary_rays_o"] = sec_o0
    results["reflect_direction"] = refl0
    base0 = res0[f"rgb_{sel}"]
    if levels is not None:
        levels.append((m0, base0))

    if not ((trace_secondary_rays or app.place_new_mirror is not None)
            and max_recursive_level > 0):
        results[f"rgb_{sel}_reflect"] = torch.zeros_like(base0)
        results[f"depth_{sel}_reflect"] = torch.zeros_like(
            res0[f"depth_{sel}"])
        results["mirror_mask_resolved"] = m0
        results["_deep_levels"] = 0
        return results

    rs_loop = rs_secondary if rs_secondary is not None else rs
    T = m0
    rgb_acc = (1.0 - m0[:, None]) * base0
    ref_depth = torch.zeros_like(m0)
    level = 1

    def alive():
        left = (T > 0.0).any()
        return bool(left if group is None else group.any(left))

    while level <= max_recursive_level and alive():
        res, m, nxt, _, _ = render_level(rays_l, rs_loop)
        if level >= max_recursive_level:
            m = torch.zeros_like(m)  # cutoff: contributes unblended
        rgb_acc = rgb_acc + T[:, None] * (1.0 - m[:, None]) * res[f"rgb_{sel}"]
        if level == 1:  # the level-1 depth feeds the reflect visualization
            ref_depth = res[f"depth_{sel}"]
        T = T * m
        if levels is not None:
            levels.append((T, res[f"rgb_{sel}"]))
        rays_l = nxt
        level += 1

    results[f"rgb_{sel}_direct"] = base0
    results[f"rgb_{sel}"] = rgb_acc
    # the fully blended secondary colour, masked to the mirror
    results[f"rgb_{sel}_reflect"] = rgb_acc - (1.0 - m0[:, None]) * base0
    results[f"depth_{sel}_reflect"] = m0 * ref_depth
    results["mirror_mask_resolved"] = m0
    results["_deep_levels"] = level - 1
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
    # the eval CLI's namespace: the roughness app's trace_ray_times and
    # normal_noise_std(_changes)
    args: object = None
    subst_field: Optional[SubstitutedField] = None
    subst_params: Optional[dict] = None
    obj_render_fn: Optional[Callable] = None
    # the deepest level `eval_trace_deep` rendered in this context's views
    deep_levels: int = 0
    # the data-parallel group whose ranks render a view's chunks together
    # (parallel/mesh.py), None on one device
    group: object = None

    @property
    def deep(self) -> bool:
        """Whether a view takes `eval_trace_deep`: above 3 levels, without
        substitution, guest objects or roughness noise (the JAX package's
        `AppContext.traced`)."""
        return self.cfg.max_recursive_level > 3 and not (
            self.app.substitution or self.app.reflect_objects
            or self.app.roughness)

    @classmethod
    def build(cls, cfg, args, field, params, device,
              group=None) -> "AppContext":
        """The context of an eval run; with a `group` of more than one
        rank every view is rendered by all of them (`run_view`)."""
        compute_normal = cfg.trace_secondary_rays and not cfg.predict_normal
        rs = RenderSettings(
            N_samples=cfg.N_samples, N_importance=cfg.N_importance,
            use_disp=cfg.use_disp, perturb=0.0, noise_std=0.0,
            white_back=False, test_time=not args.render_coarse_rgb,
            compute_normal=compute_normal,
            fine_pass=("fine" if cfg.N_importance > 0
                       and not cfg.only_one_field
                       else ("coarse" if cfg.N_importance > 0 else "none")),
            fused_field=args.fused_field,
            proposal_skip=args.proposal_skip,
            sigma_activation=cfg.sigma_activation,
            # the σ-gradient normal on the card (∇σ under no_grad): the
            # renderer takes the CP grid's train kernel forward for the
            # fields that support it (`supports_fused_train`); the hash
            # grid goes through ENCODE and BWD, the flagship through
            # autograd of its cuBLAS products
            fused_density=(compute_normal
                           and torch.device(device).type == "cuda"),
        )
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
        app = EvalAppFlags(
            place_new_mirror=(plane_preset(args.plane_pos, cfg.root_dir)
                              if args.app_place_new_mirror else None),
            roughness=args.app_control_mirror_roughness,
            substitution=args.app_reflection_substitution,
            reflect_objects=args.app_reflect_newly_placed_objects,
            near=cfg.near,
        )
        if app.roughness and not (cfg.trace_secondary_rays
                                  and cfg.max_recursive_level > 0):
            raise ValueError("--app_control_mirror_roughness traces the "
                             "mirror rays: add --trace_secondary_rays and "
                             "--max_recursive_level >= 1")
        ctx = cls(cfg=cfg, field=field, params=params, rs=rs, app=app,
                  device=torch.device(device), rs_sec=rs_sec, args=args,
                  group=group if group is not None and group.world > 1
                  else None)
        if app.substitution:
            if not args.substitution_ckpt_path:
                raise SystemExit("[Error] substitution_ckpt_path required "
                                 "for app_reflection_substitution.")
            from ..models.fields import make_field
            from ..train.checkpoints import load_params_any

            sub_field = make_field(cfg.replace(bound=6.0))  # the reference
            # forces bound 6 on the substituted field
            like = {"coarse": sub_field.init(
                torch.Generator().manual_seed(0), device)}
            if cfg.N_importance > 0 and not cfg.only_one_field:
                like["fine"] = sub_field.init(
                    torch.Generator().manual_seed(1), device)
            ctx.subst_field = SubstitutedField(
                sub_field, substitution_transform(cfg.root_dir))
            ctx.subst_params = load_params_any(args.substitution_ckpt_path,
                                               like, sub_field)
        if app.reflect_objects:
            if not args.obj_ckpt_path:
                raise SystemExit("[Error] obj_ckpt_path required for "
                                 "app_reflect_newly_placed_objects.")
            from ..models.guests import make_object_render_fn

            ctx.obj_render_fn = make_object_render_fn(
                args.obj_model_type, args.obj_ckpt_path,
                transform=object_transform(cfg.root_dir), device=device)
        return ctx


def _pad(arr: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return torch.cat([arr, arr[-1:].expand(pad, -1)], dim=0)


CAPACITY_BUCKETS = (0.125, 0.25, 0.5, 1.0)


def _keep_eval_key(kk: str) -> bool:
    """Eval output filter: drop per-sample buffers the writers never read
    and the tracer's internal (`_`-prefixed) keys."""
    return not (kk.startswith(("weights_", "z_vals_", "normal_",
                               "pred_normal_", "_"))
                and kk != "normal_dif_fine")


@torch.no_grad()
def estimate_mirror_fraction(ctx: AppContext, rays_all: torch.Tensor) -> float:
    """Cheap low-res prepass: the level-0 mirror-mask fraction of this view
    over 2048 strided rays (a guest object composited in at time 0), used
    to pick the secondary-ray capacity."""
    n = rays_all.shape[0]
    stride = max(n // 2048, 1)
    sub = _pad(rays_all[::stride][:2048], 2048)
    mask = eval_trace(ctx.field, ctx.params, sub, ctx.rs, ctx.app,
                      max_recursive_level=0, trace_secondary_rays=False,
                      obj_render_fn=ctx.obj_render_fn)["mirror_mask_resolved"]
    return float(mask.mean())


def pick_capacity(frac: float) -> float:
    """Smallest capacity bucket covering the estimate with safety margin."""
    need = min(frac * 1.3 + 0.03, 1.0)
    for b in CAPACITY_BUCKETS:
        if b >= need:
            return b
    return 1.0


def _trace_chunk(ctx: AppContext, rays: torch.Tensor, compact_frac: float,
                 frame_time: float, normal_noise=None) -> dict:
    """One chunk through `eval_trace` with the context's applications."""
    cfg = ctx.cfg
    return eval_trace(ctx.field, ctx.params, rays, ctx.rs, ctx.app,
                      cfg.max_recursive_level, cfg.trace_secondary_rays,
                      compact_frac=compact_frac, compact_from_level=1,
                      rs_secondary=ctx.rs_sec, subst_params=ctx.subst_params,
                      subst_field=ctx.subst_field,
                      obj_render_fn=ctx.obj_render_fn, frame_time=frame_time,
                      normal_noise=normal_noise, group=ctx.group)


def roughness_bundle(ctx: AppContext, secondary_o: torch.Tensor,
                     normal_base: torch.Tensor, rays: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """One glossy bundle: the normal perturbed by `noise` (N, 3, already ×
    its standard deviation), the reflected rays traced from level 1;
    returns their rgb."""
    sel = "fine" if ctx.rs.fine_pass == "fine" else "coarse"
    reflect_dir = reflect(rays[:, 3:6], l2_normalize(normal_base + noise))
    res = eval_trace(ctx.field, ctx.params,
                     _secondary_rays(secondary_o, reflect_dir, rays), ctx.rs,
                     ctx.app, ctx.cfg.max_recursive_level,
                     ctx.cfg.trace_secondary_rays, level=1,
                     rs_secondary=ctx.rs_sec)
    return res[f"rgb_{sel}"]


def roughness_average(ctx: AppContext, base: dict, rays: torch.Tensor,
                      noises) -> dict:
    """Monte-Carlo glossy reflection of one chunk: `base` the chunk's
    noise-free trace, `noises` one (N, 3) normal perturbation a bundle. The
    bundles' mean rgb is blended by the level-0 mirror mask into `rgb_*`
    and is `rgb_*_reflect`."""
    sel = "fine" if ctx.rs.fine_pass == "fine" else "coarse"
    acc, count = None, 0
    for noise in noises:
        rgb = roughness_bundle(ctx, base["secondary_rays_o"],
                               base["_normal_presmooth"], rays, noise)
        acc = rgb if acc is None else acc + rgb
        count += 1
    sec_mean = acc / count
    m = base["mirror_mask_resolved"][:, None]
    base[f"rgb_{sel}"] = m * sec_mean + (1 - m) * base[f"rgb_{sel}_direct"]
    base[f"rgb_{sel}_reflect"] = sec_mean
    return base


def roughness_noises(n: int, count: int, std: float,
                     generator: torch.Generator, device):
    """`count` normal perturbations (n, 3) × `std`, drawn in turn."""
    for _ in range(count):
        yield torch.randn((n, 3), generator=generator, device=device) * std


def render_chunk(ctx: AppContext, rays: torch.Tensor,
                 compact_frac: float = 1.0, frame_time: float = 0.0,
                 noises=None) -> dict:
    """One chunk of a view through the context's trace: the roughness
    bundles' mean (`noises`, one (N, 3) normal perturbation a bundle), the
    deep trace, or `eval_trace` with the context's applications. With the
    context's group, `rays` (and `noises`) are this rank's rows of the
    chunk."""
    cfg = ctx.cfg
    if ctx.app.roughness:
        # the base chunk once, then the perturbed-normal bundles from
        # level 1, averaged
        return roughness_average(
            ctx, _trace_chunk(ctx, rays, compact_frac, frame_time), rays,
            noises)
    if ctx.deep:
        res = eval_trace_deep(ctx.field, ctx.params, rays, ctx.rs, ctx.app,
                              cfg.max_recursive_level,
                              cfg.trace_secondary_rays,
                              rs_secondary=ctx.rs_sec, group=ctx.group)
        ctx.deep_levels = max(ctx.deep_levels, res["_deep_levels"])
        return res
    return _trace_chunk(ctx, rays, compact_frac, frame_time)


@torch.no_grad()
def run_view(ctx: AppContext, sample: dict, progress: float = 0.0,
             view_index: int = 0) -> dict:
    """Render one full view through fixed-size chunks; returns numpy dict.
    `progress` (the view's index over the split's size) is the guest
    objects' frame time and sets the roughness with
    `--normal_noise_std_changes`; the roughness noise of a chunk is drawn
    from a generator seeded from `view_index` and the chunk's start. With
    the context's group every rank renders its rows of each chunk (the
    chunk rounded up to a multiple of the ranks, as the JAX package's
    sharded chunks are) and every rank gets the whole view."""
    cfg, args, group = ctx.cfg, ctx.args, ctx.group
    rays_all = torch.as_tensor(np.asarray(sample["rays"], np.float32),
                               device=ctx.device)
    n = rays_all.shape[0]
    chunk = min(cfg.chunk, n)
    if group is not None:
        chunk = pad_to_multiple(chunk, group.world)
    # adaptive secondary-ray capacity (exact while mirror pixels fit; the
    # new-mirror app changes the mask after level 0, so it traces
    # everything; the deep trace does not compact)
    if (cfg.trace_secondary_rays and ctx.app.place_new_mirror is None
            and cfg.max_recursive_level > 0 and not ctx.deep):
        compact_frac = pick_capacity(estimate_mirror_fraction(ctx, rays_all))
    else:
        compact_frac = 1.0
    if ctx.app.roughness:
        cycle = progress * 2 if progress < 0.5 else 1 - (progress - 0.5) * 2
        noise_std = (args.normal_noise_std * cycle
                     if args.normal_noise_std_changes
                     else args.normal_noise_std)

    outs: dict = {}
    for start in range(0, n, chunk):
        noises = None
        if ctx.app.roughness:
            gen = torch.Generator(device=ctx.device)
            gen.manual_seed(int(np.random.SeedSequence(
                [view_index, start]).generate_state(1)[0]))
            noises = roughness_noises(chunk, args.trace_ray_times + 1,
                                      noise_std, gen, ctx.device)
        rays = _pad(rays_all[start:start + chunk], chunk)
        if group is not None:
            rays = group.shard_rows(rays)
            if noises is not None:
                noises = (group.shard_rows(z) for z in noises)
        res = render_chunk(ctx, rays, compact_frac, float(progress), noises)
        valid = min(chunk, n - start)
        for kk, vv in res.items():
            if _keep_eval_key(kk):
                if group is not None:
                    vv = group.all_gather(vv)
                outs.setdefault(kk, []).append(vv[:valid])
    return {kk: torch.cat(v, 0).cpu().numpy() for kk, v in outs.items()}
