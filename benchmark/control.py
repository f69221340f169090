"""The controls that the limits of `correct` are set against: the plain
reference put in the program's place and computed one precision below the
configuration's (TF32 products for an fp32 configuration with TF32 off),
and, for training, the half-batch fault planted in it. Each reads the same
numbers a run of the cell compares, at the cell's own size; a control has
to come out not correct.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \
        [--views 40] [--fault tf32|half_batch|none] [--adam_eps 1e-8]

prints one JSON line a seed. It runs no window and, but for training's
`--fault none` (the program's own readings after set-up's warm steps, the
limits' lower readings), no program kernel; `--adam_eps` sets Adam's eps
on both sides of a training reading. The benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness
from .drivers import train as train_drv
from .drivers import views as views_drv
from .reference import common


def view_control(name: str, seed: int, n_views: int, device,
                 overrides: dict = None) -> tuple:
    """The TF32 reference in the program's place for `n_views` views of a
    run with this seed (the same poses and checked rays); the readings and
    the figures."""
    cell = harness.any_cell(name, overrides=overrides)
    s = views_drv.Setup(cell, harness.reference(cell), seed, device)
    params, _ = s.weights()
    n_rays, k = s.w * s.h, cell.get("check_rays_per_view")
    picks = [(v % len(s.rays), views_drv._sample(seed, v, n_rays, k))
             for v in range(n_views)]
    by_pose = {}
    for pose, idx in picks:
        by_pose.setdefault(pose, set()).update(idx.tolist())
    outs = {}
    for pose, idx in by_pose.items():
        idx = np.array(sorted(idx))
        rays = torch.from_numpy(s.rays[pose][idx]).to(device)
        r = common.trace_eval(s.field, params, rays, s.levels, s.n_samples,
                              s.n_importance, "tf32")
        outs[pose] = (idx, {k2: v.cpu().numpy() for k2, v in r.items()})
    kept = []
    for pose, idx in picks:
        ridx, r = outs[pose]
        pos = np.searchsorted(ridx, idx)
        kept.append((pose, idx, {
            "rgb_fine": r["rgb"][pos], "depth_fine": r["depth"][pos],
            "depth_fine_reflect": r["depth_reflect"][pos],
            "mirror_mask_resolved": r["mask"][pos],
            "mirror_mask_fine": r["mask_value"][0][pos]}))
    checks, _, figs = views_drv.check(cell, s, kept, 0.0, 0)
    return checks, figs


def train_control(name: str, seed: int, fault: str, device,
                  overrides: dict = None) -> tuple:
    """The reference with `fault` planted (TF32 products, or each batch's
    loss over its first half) in the program's place, or for `none` the
    program itself; the readings and the figures."""
    cell = harness.any_cell(name, overrides=overrides)
    ref = harness.reference(cell)
    if fault == "none":
        return train_drv.readings(cell, ref, seed, device)
    data, field, params0, cfg, warm_rows = train_drv.setup(cell, ref, seed,
                                                           device)
    planted = train_drv.reference_steps(
        field, data, params0, cfg, seed, warm_rows, device,
        prec="tf32" if fault == "tf32" else "fp32",
        rows_kept=0.5 if fault == "half_batch" else 1.0)
    r = train_drv.reference_steps(field, data, params0, cfg, seed,
                                  warm_rows, device)
    return (train_drv.compare(planted, r, params0,
                              cell.config["limits"]["train"]),
            train_drv.figures(planted, r, params0))


def _with_eps(name: str, eps: str) -> dict:
    """A training cell's flags with Adam's eps set to `eps`."""
    flags = list(harness.any_cell(name).config["train_flags"])
    flags[flags.index("--adam_eps") + 1] = eps
    return {"train_flags": flags}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--views", type=int, default=40)
    ap.add_argument("--fault", default="tf32",
                    choices=("tf32", "half_batch", "none"))
    ap.add_argument("--adam_eps", default=None)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[error] the controls are read on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.any_cell(opt.workload)
    over = _with_eps(opt.workload, opt.adam_eps) if opt.adam_eps else None
    for seed in opt.seeds:
        figs = {}
        if cell.traffic["driver"] == "train":
            checks, figs = train_control(opt.workload, seed, opt.fault,
                                         device, overrides=over)
        else:
            checks, figs = view_control(opt.workload, seed, opt.views,
                                        device)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": opt.workload, "seed": seed,
                          "fault": opt.fault, "adam_eps": opt.adam_eps,
                          "correct": correct, "checks": checks,
                          "figures": figs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
