"""Closed-loop views: one client renders views back to back through the
port's `eval/apps.py run_view`, each call waiting on the one before.

The traffic file gives the mix: the scene (`scene_seed`: the seeded
weights, the same in every run, so that every run does the same work in
another order), the cycle of poses (`poses` of a ring of cameras around the
room, all looking at its mirror wall, the first chosen by the run's seed), the least share of each pose's rays that resolve as mirrors
at level 0 (`min_mirror_share`, set by bisection of the mirror head's bias
on the plain reference), how many rays of each view are checked, and how
many views the traced run profiles. The configuration gives the model, the eval
CLI's flags and the view size.

Set-up: weights drawn on the card from the scene's seed, σ made opaque,
the mirror bias calibrated, every pose's rays made, the context built as
the eval CLI builds it, one warm view. The window: views until `seconds` have passed;
it ends at the first boundary of the cycle of poses after that, so that
every run renders each pose as often, in another order. Each view's latency runs
from the call until its numpy result is back. After the window the
program's state is freed and the plain reference traces each view's
sampled rays; the comparison decides `correct`.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from .. import roof
from .. import trace as tr
from ..reference import common

HALF = 2.5  # the procedural room is the box [-HALF, HALF]³
SPANS = ("view", "between_views")
KEYS = ("rgb_fine", "depth_fine", "depth_fine_reflect",
        "mirror_mask_resolved", "mirror_mask_fine")


def sub_seed(seed: int, tag: int) -> int:
    """An independent stream of the run's seed (any whole number)."""
    return int(np.random.SeedSequence([seed & (2**63 - 1), tag])
               .generate_state(1, np.uint64)[0] >> 1)


def lookat(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(3, 4) camera-to-world, looking along −z."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = (eye - target) / np.linalg.norm(eye - target)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z, eye], 1).astype(np.float32)


def camera_ring(n: int, radius: float = 1.3, height: float = 0.2,
                center_z: float = 1.2) -> np.ndarray:
    """n poses on an arc of ±40° inside the room, all aimed at the mirror
    wall z = −HALF (the port's `data/synthetic.camera_ring`)."""
    poses = []
    for k in range(n):
        ang = (k / max(n, 1)) * 1.4 - 0.7
        eye = [radius * np.sin(ang), height * np.sin(2.1 * k),
               center_z + 0.35 * np.cos(ang)]
        poses.append(lookat(eye, [0.35 * np.sin(ang * 0.5), 0.0, -HALF]))
    return np.stack(poses)


def pose_rays(c2w: np.ndarray, w: int, h: int, near: float,
              far: float) -> np.ndarray:
    """(h·w, 8) [o, d, near, far] rays of a pinhole camera with a 0.9 rad
    field of view across the width, unit directions."""
    focal = 0.5 * w / np.tan(0.45)
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                     -np.ones_like(i)], -1).reshape(-1, 3)
    d = dirs @ c2w[:, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:, 3], d.shape)
    n = d.shape[0]
    return np.concatenate([o, d, np.full((n, 1), near), np.full((n, 1), far)],
                          1).astype(np.float32)


def _flag(flags: list, name: str, default: float) -> float:
    return float(flags[flags.index(name) + 1]) if name in flags else default


def _mirror_affine(params: dict, path: list, gain: float,
                   delta: float) -> dict:
    """Each network's mirror-head last linear at `path` with its weights
    and bias × `gain`, then `delta` added to the bias (copies on the
    way)."""
    def at(node, rest):
        if not rest:
            return {"w": node["w"] * gain, "b": node["b"] * gain + delta}
        k = rest[0]
        if isinstance(node, list):
            return [at(v, rest[1:]) if i == k else v
                    for i, v in enumerate(node)]
        return {**node, k: at(node[k], rest[1:])}
    return {net: at(p, list(path)) for net, p in params.items()}


def crossings(weights: torch.Tensor, logit: torch.Tensor) -> torch.Tensor:
    """Each ray's crossing: the shift Δ of its mirror logits at which its
    mask, Σ w·sigmoid(logit + Δ), reaches 0.5 (by bisection; +inf for a
    ray too transparent to reach it). A ray is a mirror for Δ above it."""
    w = weights
    reach = float(logit.abs().max()) + 60.0
    lo = torch.full((w.shape[0], 1), -reach, device=w.device)
    hi = torch.full_like(lo, reach)

    def mask(delta):
        return (w * torch.sigmoid(logit + delta)).sum(-1, keepdim=True)

    never = mask(hi) <= 0.5
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        up = mask(mid) > 0.5
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    return torch.where(never, torch.full_like(hi, float("inf")), hi)[:, 0]


def shift_for(cross: np.ndarray, share: float, margin: float = 4.0) -> float:
    """The smallest shift (midway between two crossings) at which at least
    a `share` of these rays are mirrors; for share 0, `margin` below the
    first crossing, so that none is."""
    c = np.sort(cross)
    finite = c[np.isfinite(c)]
    if len(finite) == 0:
        return 0.0
    k = int(np.ceil(share * len(c)))
    if k == 0:
        return float(finite[0] - margin)
    if k >= len(finite):
        return float(finite[-1] + margin)
    return float(0.5 * (c[k - 1] + c[k]))


def prepass_rows(n: int) -> np.ndarray:
    """The rows of a view the port's capacity prepass reads
    (`eval/apps.py estimate_mirror_fraction`: 2048 strided rays, a view of
    fewer padded with its last)."""
    idx = np.arange(0, n, max(n // 2048, 1))[:2048]
    return np.concatenate([idx, np.full(2048 - len(idx), idx[-1])])


class Setup:
    """Everything a view run needs, made from the seed: the reference's
    weights with σ opaque and the calibrated mirror bias, the poses' rays,
    the calibration rays."""

    def __init__(self, cell, ref, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        self.flags = list(cell.get("eval_flags"))
        self.w, self.h = cell.get("view_wh")
        near, far = _flag(self.flags, "--near", 0.0), _flag(self.flags,
                                                             "--far", 1.0)
        self.n_samples = int(_flag(self.flags, "--N_samples", 64))
        self.n_importance = int(_flag(self.flags, "--N_importance", 64))
        self.levels = int(_flag(self.flags, "--max_recursive_level", 1))
        self.field = ref.Field(cfg["field"])
        poses = camera_ring(cell.get("poses"))
        self.offset = sub_seed(seed, 1) % len(poses)
        self.rays = [pose_rays(poses[(self.offset + k) % len(poses)], self.w,
                               self.h, near, far)
                     for k in range(len(poses))]

    def weights(self) -> tuple:
        """(params, (gain, Δ)): drawn on the card from the traffic's
        `scene_seed` (every run renders one scene; the run's seed orders
        the poses and picks the checked rays), σ opaque, the mirror
        head's last linear scaled so that the opacity-weighted mirror logit
        of the calibration rays spreads by `mirror_logit_std` (a trained
        head is decisive; a seeded one is flat), and its bias shifted so
        that in every pose at least a `min_mirror_share` of the rays the
        port's capacity prepass reads resolve as mirrors (for 0: none
        does). The calibration rays are those prepass rows of every pose.
        Deterministic: the check draws them again."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.cell.get("scene_seed"), 0))
        params = self.field.init_params(gen, self.device)
        params = self.field.opaque(params, **self.cell.config["opaque"])
        uniq, inv = np.unique(prepass_rows(self.w * self.h),
                              return_inverse=True)
        inv = torch.from_numpy(inv).to(self.device)
        ws, logits = [], []
        for rays in self.rays:
            cal = torch.from_numpy(rays[uniq]).to(self.device)
            r = common.render_eval(self.field, params, cal, self.n_samples,
                                   self.n_importance, "fp32")
            ws.append(r["weights"][inv])
            logits.append(r["logit"][inv])
        w, logit = torch.cat(ws), torch.cat(logits)
        per_ray = (w * logit).sum(-1) / w.sum(-1).clamp_min(1e-6)
        gain = self.cell.get("mirror_logit_std") / float(per_ray.std())
        cross = crossings(w, logit * gain).double().cpu().numpy()
        share = self.cell.get("min_mirror_share")
        per_pose = [shift_for(c, share) for c in
                    np.split(cross, len(self.rays))]
        delta = min(per_pose) if share == 0 else max(per_pose)
        return _mirror_affine(params, self.cell.config["mirror_head"], gain,
                              delta), (gain, delta)


def _sample(seed: int, view: int, n_rays: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([seed & (2**63 - 1), 2, view])
    return np.sort(rng.choice(n_rays, size=min(k, n_rays), replace=False))


def _launches() -> int:
    """The port's launch counters summed over its loaded ops modules."""
    total = 0
    for name, mod in list(sys.modules.items()):
        if name.startswith("mirror_nerf_tpu_torch.ops.") and mod is not None:
            total += sum(v for k, v in vars(mod).items()
                         if k.startswith("launches") and isinstance(v, int))
    return total


def run(cell, ref, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    """One run of a view cell; returns the observations the metric readers
    and the check read."""
    from mirror_nerf_tpu_torch.eval.apps import AppContext, run_view
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    s = Setup(cell, ref, seed, device)
    params, delta = s.weights()
    if device.type == "cuda":  # the peak is the program's, not calibration's
        torch.cuda.reset_peak_memory_stats(device)
    cfg, args = get_opt(s.flags + ["--img_wh", str(s.w), str(s.h),
                                   "--device", str(device)])
    ctx = AppContext.build(cfg, args, make_field(cfg), params, device)
    n_rays = s.w * s.h
    k_check = cell.get("check_rays_per_view")
    run_view(ctx, {"rays": s.rays[0]})  # warm: one view
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    kept, lat, dropped, nonfinite = [], [], 0.0, 0
    n0 = _launches()

    def book(view: int, res: dict):
        nonlocal dropped, nonfinite
        idx = _sample(seed, view, n_rays, k_check)
        kept.append((view % len(s.rays), idx,
                     {k: res[k][idx] for k in KEYS}))
        dropped += float(np.sum(res.get("compact_dropped", 0.0)))
        nonfinite += int(not all(np.isfinite(res[k]).all() for k in KEYS))

    view = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        res = run_view(ctx, {"rays": s.rays[view % len(s.rays)]})
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        book(view, res)
        view += 1
        if t1 - t_start >= seconds and view % len(s.rays) == 0:
            break
    window_s = t1 - t_start
    launches = _launches() - n0
    obs = {"kind": "views", "setup_s": setup_s, "window_s": window_s,
           "latencies": lat, "views": view, "rays_done": view * n_rays,
           "launches_per_view": launches / view}

    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        traced = cell.get("traced_views")
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(traced):
                with torch.profiler.record_function("view"):
                    res = run_view(ctx, {"rays": s.rays[view % len(s.rays)]})
                with torch.profiler.record_function("between_views"):
                    book(view, res)
                view += 1
        obs["trace"] = tr.reduce(tr.export_events(prof), SPANS)
        obs["traced_views"] = traced
    obs["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del ctx, params, res
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, live, figs = check(cell, s, kept, dropped, nonfinite)
    for k, v in figs.items():
        print(f"[views] figure {k} {v!r}", file=sys.stderr)
    obs.update(checks=checks, attempted=view, failed=nonfinite,
               mirror_gain_shift=delta, ambiguous_share=live[2])
    obs.update(work(cell, s, obs, live))
    return obs


def check(cell, s: Setup, kept: list, dropped: float,
          nonfinite: int) -> tuple:
    """The reference, drawn again from the seed, traces every kept ray
    (each pose's once); returns the readings that the configuration's
    limits name, beside their limits; the live shares of levels 1 and 2
    and the share of rays left out as ambiguous among the checked rays;
    and the readings it does not name (figures). `kept` holds (pose, ray
    indices, the outputs at them) of each checked view."""
    params, _ = s.weights()
    by_pose = {}
    for pose, idx, _ in kept:
        by_pose.setdefault(pose, set()).update(idx.tolist())
    ref_out = {}
    for pose, idx in by_pose.items():
        idx = np.array(sorted(idx))
        rays = torch.from_numpy(s.rays[pose][idx]).to(s.device)
        r = common.trace_eval(s.field, params, rays, s.levels, s.n_samples,
                              s.n_importance, "fp32")
        r = {k: v.cpu().numpy() for k, v in r.items()}
        ref_out[pose] = (idx, r)
    margin = cell.get("mask_margin")
    cols = {k: [] for k in ("rgb", "depth", "mask", "refl_rgb", "refl_depth",
                            "m0", "ok", "mismatch", "live2")}
    for pose, idx, out in kept:
        ridx, r = ref_out[pose]
        pos = np.searchsorted(ridx, idx)
        mv = r["mask_value"][:, pos]
        m0 = r["mask"][pos] > 0.5
        amb = np.abs(mv[0] - 0.5) < margin
        if s.levels > 1:
            amb |= m0 & (np.abs(mv[1] - 0.5) < margin)
            cols["live2"].append(m0 & (mv[1] > 0.5))
        rgb = np.abs(out["rgb_fine"] - r["rgb"][pos]).max(-1)
        cols["rgb"].append(rgb)
        cols["depth"].append(np.abs(out["depth_fine"] - r["depth"][pos]))
        cols["mask"].append(np.abs(out["mirror_mask_fine"] - mv[0]))
        cols["refl_depth"].append(np.abs(out["depth_fine_reflect"]
                                         - r["depth_reflect"][pos]))
        cols["m0"].append(m0)
        cols["ok"].append(~amb)
        cols["mismatch"].append((out["mirror_mask_resolved"] > 0.5) != m0)
    c = {k: np.concatenate(v) if v else np.zeros(0) for k, v in cols.items()}
    ok, m0 = c["ok"].astype(bool), c["m0"].astype(bool)
    direct, mirror = ok & ~m0, ok & m0

    def widest(v, sel):
        return float(np.max(v[sel], initial=0.0))

    def mean(v, sel):
        return float(np.mean(v[sel])) if sel.any() else 0.0

    def p99(v, sel):
        return float(np.percentile(v[sel], 99)) if sel.any() else 0.0

    # each gap as its widest, its 99th percentile and, for reflections,
    # its mean over the rays: a configuration's limits name those that
    # separate its sound runs from its control, the others are figures
    gaps = {"rgb_gap": widest(c["rgb"], direct),
            "rgb_p99": p99(c["rgb"], direct),
            "depth_gap": widest(c["depth"], ok),
            "depth_p99": p99(c["depth"], ok),
            "mask_gap": widest(c["mask"], np.ones_like(ok)),
            "reflect_rgb_gap": mean(c["rgb"], mirror),
            "reflect_depth_gap": mean(c["refl_depth"], mirror),
            "reflect_rgb_p99": p99(c["rgb"], mirror),
            "reflect_depth_p99": p99(c["refl_depth"], mirror),
            "reflect_rgb_max": widest(c["rgb"], mirror),
            "reflect_depth_max": widest(c["refl_depth"], mirror)}
    mismatch = int(np.sum(c["mismatch"].astype(bool) & ok))
    ambiguous = int(np.sum(~ok))
    total = len(ok)
    live1, live2 = int(np.sum(m0)), int(np.sum(c["live2"]))
    lim = cell.config["limits"]["views"]
    checks = {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()
              if k in lim}
    checks["mask_mismatch"] = {"value": mismatch,
                               "limit": lim["mask_mismatch"]}
    checks["dropped"] = {"value": dropped, "limit": lim["dropped"]}
    checks["nonfinite_views"] = {"value": nonfinite, "limit": 0}
    figs = {k: v for k, v in gaps.items() if k not in lim}
    return checks, (live1 / max(total, 1), live2 / max(total, 1),
                    ambiguous / max(total, 1)), figs


def work(cell, s: Setup, obs: dict, live: tuple) -> dict:
    """The field work the inputs need, (operations, bytes), in the window
    and in the traced views: every ray at level 0, at levels 1 and 2 the
    live share of them (the rays the reference resolves as mirrors at every
    level before, from the checked sample); a ray's work is its 64 σ-only
    coarse and 128 full fine samples, its bytes the ray, depths and weights
    once and its per-ray results."""
    per = {"mlp": roof.mlp_sample_flop, "hash": roof.hash_sample_flop}[
        cell.config["work"]]
    s_f = s.n_samples + s.n_importance
    flop_ray = s.n_samples * per(True) + s_f * per(False)
    bytes_ray = 32 + 12 + 2 * 4 * (s.n_samples + s_f) + 9 * 4
    rays_view = s.w * s.h * (1.0 + sum(live[:s.levels]))
    out = {"live_shares": live[:2],
           "window_work": (obs["views"] * rays_view * flop_ray,
                           obs["views"] * rays_view * bytes_ray)}
    if "traced_views" in obs:
        out["traced_work"] = (obs["traced_views"] * rays_view * flop_ray,
                              obs["traced_views"] * rays_view * bytes_ray)
    return out


def p90(values) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[8]
