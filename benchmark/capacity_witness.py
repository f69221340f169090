"""The port's level-2 capacity against the plain reference, on the 0.3 mix
(`traffic/view.mirror.json`: at least 0.3 of each pose's rays mirrors, so
that `eval/apps.py pick_capacity` takes a bucket below 1.0 in some poses).

    python3 -m benchmark.capacity_witness --config flagship --seeds 1 2 \
        [--views 4] [--wh 400 300] [--sample 4096] [--device cuda]

Each view is rendered three ways: the program's `run_view` as the cells
run it; the program's own path with the capacity forced to 1.0 (no
compaction: the witness); and the reference, on a sample of the rays drawn
from the seed. The reference also renders every ray's level-1 reflection,
so that it counts the level-1 mirrors among all rays (what the program's
level-1 compaction keeps) and among the level-0 mirrors (the rays whose
level-2 reflection reaches the view). Prints one JSON line a view. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness
from .drivers import views as views_drv
from .reference import common


def witness(config: str, seed: int, n_views: int, wh, n_sample: int,
            device) -> list:
    from mirror_nerf_tpu_torch.eval import apps
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    cell = harness.any_cell(f"{config}.view.mirror")
    if wh:
        cell.overrides["view_wh"] = list(wh)
    s = views_drv.Setup(cell, harness.reference(cell), seed, device)
    params, _ = s.weights()
    cfg, args = get_opt(s.flags + ["--img_wh", str(s.w), str(s.h),
                                   "--device", str(device)])
    ctx = apps.AppContext.build(cfg, args, make_field(cfg), params, device)
    pick = apps.pick_capacity
    rows = []
    for v in range(n_views):
        rays = s.rays[v % len(s.rays)]
        frac = pick(apps.estimate_mirror_fraction(
            ctx, torch.from_numpy(rays).to(device)))
        prog = apps.run_view(ctx, {"rays": rays})
        apps.pick_capacity = lambda f: 1.0
        try:
            full = apps.run_view(ctx, {"rays": rays})
        finally:
            apps.pick_capacity = pick
        n = len(rays)
        idx = np.sort(np.random.default_rng([seed & (2**63 - 1), 7, v])
                      .choice(n, size=min(n_sample, n), replace=False))
        rt = torch.from_numpy(rays[idx]).to(device)
        ref = common.trace_eval(s.field, params, rt, s.levels, s.n_samples,
                                s.n_importance, "fp32")
        r0 = common.render_eval(s.field, params, rt, s.n_samples,
                                s.n_importance, "fp32")
        r1 = common.render_eval(s.field, params, common.secondary(rt, r0),
                                s.n_samples, s.n_importance, "fp32")
        m0 = (r0["mask"] > 0.5).cpu().numpy()
        m1 = (r1["mask"] > 0.5).cpu().numpy()
        drop = prog.get("compact_dropped", np.zeros(n)) > 0
        live = prog["mirror_mask_resolved"] > 0.5
        ref_rgb = ref["rgb"].cpu().numpy()
        gap_p = np.abs(prog["rgb_fine"][idx] - ref_rgb).max(-1)
        gap_f = np.abs(full["rgb_fine"][idx] - ref_rgb).max(-1)
        ld = (drop & live)[idx]

        def stat(g, sel):
            return [float(g[sel].max(initial=0.0)),
                    float(g[sel].mean()) if sel.any() else 0.0]
        rows.append({
            "config": config, "seed": seed, "view": v, "rays": n,
            "chunk": cfg.chunk, "capacity": frac,
            "ref_level0_mirrors": float(m0.mean()),
            "ref_level1_mirrors_all_rays": float(m1.mean()),
            "ref_level1_mirrors_live": float((m0 & m1).mean()),
            "prog_dropped": int(drop.sum()),
            "prog_dropped_live": int((drop & live).sum()),
            "full_dropped": int((full.get("compact_dropped",
                                          np.zeros(n)) > 0).sum()),
            "sample_live_dropped": int(ld.sum()),
            "rgb_gap_live_dropped": stat(gap_p, ld),
            "rgb_gap_live_dropped_full": stat(gap_f, ld),
            "rgb_gap_others": stat(gap_p, ~ld),
            "rgb_gap_full_all": stat(gap_f, np.ones_like(ld))})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--wh", type=int, nargs=2, default=None)
    ap.add_argument("--sample", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    opt = ap.parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("[error] no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in opt.seeds:
        for row in witness(opt.config, seed, opt.views, opt.wh, opt.sample,
                           device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
