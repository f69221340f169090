#!/usr/bin/env python
"""Why `chip_smoke.py` phase 19's C1 check passes in some runs and fails in
others: the run-to-run spread of mode 3's 50-level trace on the card.

    python3 tools/c1_deep_trace_probe.py [--checkpoints 4] [--rays 256]

On a CUDA card. Trains `--checkpoints` checkpoints with phase 7's train CLI
run (`chip_smoke.phase_train_path`: the same flags, scene and seed, each in
a directory of its own under build/c1_probe/), then:

  * how far each checkpoint is from the first, leaf by leaf (the train
    kernels' backward sums with atomics in an order that changes from run
    to run);
  * whether the card renders one checkpoint bit for bit alike twice;
  * for each checkpoint, phase 19's C1 numbers on the same strided rays of
    the 800×800 view: the rgb_fine of mode 3 traced to level 50 on the card
    (fp32 kernels) and by the plain version on the CPU in fp32, each one's
    distance to the plain version in float64; the largest over the rays
    (what C1 holds), its quantiles, and C1's verdict on that checkpoint.

Prints one line per finding and, last, one JSON object with the numbers.
Imports only the port and `chip_smoke.py`, never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

QUANTILES = (0.5, 0.9, 0.99)


def _deep(torch, cs, flags, sub, dev, dtype):
    """rgb per level and the final rgb_fine of mode 3's deep trace of `sub`
    on `dev` in `dtype`, as float64 numpy arrays."""
    from mirror_nerf_tpu_torch.eval.apps import eval_trace_deep

    ctx = cs._app_ctx(torch, flags, dev)
    levels = []
    with torch.no_grad():
        res = eval_trace_deep(
            ctx.field, {k: cs._cast_tree(torch, v, dtype)
                        for k, v in ctx.params.items()},
            sub.to(dev, dtype), ctx.rs, ctx.app,
            ctx.cfg.max_recursive_level, ctx.cfg.trace_secondary_rays,
            rs_secondary=ctx.rs_sec, levels=levels)
    return ([r.double().cpu().numpy() for _, r in levels],
            res["rgb_fine"].double().cpu().numpy())


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoints", type=int, default=4)
    ap.add_argument("--rays", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c1_deep_trace_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_environment(torch)
    cs.phase_build()

    base = ROOT / "build" / "c1_probe"
    rays_np = cs._view_rays(800)
    n = args.rays
    sub = torch.from_numpy(rays_np[::len(rays_np) // n][:n].copy())
    out = {"card": card, "checkpoints": []}
    first = None
    for i in range(args.checkpoints):
        cs.WORK = base / f"run{i}"
        t0 = time.perf_counter()
        cs.phase_train_path(torch, card)
        train_dir = cs.WORK / "train"
        ckpt = str(next(train_dir.glob("logs/*_smoke/last.ckpt.npz")))
        with np.load(ckpt) as data:
            leaves = {k: np.asarray(data[k]) for k in data.files
                      if np.asarray(data[k]).dtype.kind == "f"}
        rec = {"train_s": time.perf_counter() - t0}
        if first is None:
            first = leaves
        else:
            diff = {k: float(np.abs(leaves[k].astype(np.float64)
                                    - first[k].astype(np.float64)).max())
                    for k in first}
            rec["max_leaf_diff_from_first"] = max(diff.values())
            rec["leaves_differing_from_first"] = sum(v > 0
                                                     for v in diff.values())
            cs.log(f"[c1] checkpoint {i} against checkpoint 0: "
                   f"{rec['leaves_differing_from_first']} of {len(diff)} "
                   f"leaves differ, largest |Δ| "
                   f"{rec['max_leaf_diff_from_first']:.3e}")
        # the scene under run.sh's default scene name, whose presets mode 3
        # takes (the new mirror the plane x = 0), as phase 19 links it
        scene = cs.WORK / "livingroom"
        scene.symlink_to(train_dir / "scene", target_is_directory=True)
        flags = (cs.EVAL_FLAGS + cs.APP_MODES["3"]
                 + ["--ckpt_path", ckpt, "--root_dir", str(scene)])
        card_a = _deep(torch, cs, flags, sub, "cuda", torch.float32)
        if i == 0:
            card_b = _deep(torch, cs, flags, sub, "cuda", torch.float32)
            same = bool(np.array_equal(card_a[1], card_b[1]))
            out["card_repeat_bitwise_equal"] = same
            cs.log(f"[c1] checkpoint 0 rendered twice on the card to level "
                   f"50: rgb_fine bit for bit equal: {same} (largest |Δ| "
                   f"{float(np.abs(card_a[1] - card_b[1]).max()):.3e})")
        cpu = _deep(torch, cs, flags, sub, "cpu", torch.float32)
        f64 = _deep(torch, cs, flags, sub, "cpu", torch.float64)
        for name, run in (("card", card_a), ("cpu", cpu)):
            e = np.abs(run[1] - f64[1]).max(-1)
            rec[name] = {"max": float(e.max()),
                         **{f"q{q}": float(np.quantile(e, q))
                            for q in QUANTILES}}
            rec[name]["level0_max"] = float(np.abs(run[0][0]
                                                   - f64[0][0]).max())
        ratio0 = rec["card"]["level0_max"] / max(rec["cpu"]["level0_max"],
                                                 1e-12)
        allowed = max(ratio0, 1.0) * 1.5 * rec["cpu"]["max"]
        rec["ratio0"] = ratio0
        rec["c1_passes"] = rec["card"]["max"] <= allowed
        cs.log(f"[c1] checkpoint {i}: rgb_fine at level 50 from float64, "
               f"{n} rays, card / CPU fp32: max {rec['card']['max']:.3e} / "
               f"{rec['cpu']['max']:.3e} (C1 allows {allowed:.3e}: "
               f"{'pass' if rec['c1_passes'] else 'FAIL'}); "
               + ", ".join(f"q{q} {rec['card'][f'q{q}']:.2e} / "
                           f"{rec['cpu'][f'q{q}']:.2e}" for q in QUANTILES)
               + f"; level 0 max {rec['card']['level0_max']:.2e} / "
               f"{rec['cpu']['level0_max']:.2e} ({card})")
        out["checkpoints"].append(rec)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
