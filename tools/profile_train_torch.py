#!/usr/bin/env python
"""Profile reflection-stage train steps of the PyTorch + CUDA port.

    python3 tools/profile_train_torch.py            # on a CUDA card
    python3 tools/profile_train_torch.py --cpu      # CPU rehearsal

Builds the `chip_smoke.py` training configuration (run.sh mode-0 nerf_tpu
flags, full width, batch 1024, novel-ray reg on) on a generated 64×64
procedural scene, takes reflection-stage steps through `Trainer.train_step`:
three warm steps, ten timed ones (host clock, synchronized), then three
under `torch.profiler`. From the exported trace it prints the trace span,
the device busy time (union of kernel, memcpy and memset intervals), the
idle share 1 − busy / span, and device time and calls by kernel name.

Imports only the port (`mirror_nerf_tpu_torch`), never JAX. The CPU
rehearsal uses small CP levels and reports no device numbers.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU with small levels")
    opt = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.train.cli import get_opt
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer
    from profile_view_torch import busy_union, profile

    dev = "cpu" if opt.cpu else "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if opt.cpu:
        card = "CPU rehearsal (no device numbers)"
    else:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        torch.backends.cuda.matmul.allow_tf32 = False
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    print(card, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "scene")
        generate_scene(root, n_train=6, n_val=1, n_test=1, img_wh=(64, 64))
        flags = cs.TRAIN_FLAGS + ["--root_dir", root, "--img_wh", "64", "64",
                                  "--device", dev]
        if opt.cpu:
            flags += ["--grid_levels", "16:8,32:8", "--batch_size", "256"]
        cfg, _ = get_opt(flags)
        ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
        ds.train_geometry_stage = False
        trainer = Trainer(cfg, ds, str(Path(tmp) / "run"), dev)
        statics = EpochStatics.of(cfg, cfg.train_geometry_stage_end_epoch,
                                  False)
        rays, rgbs, masks = (torch.from_numpy(a).to(dev)
                             for a in ds.train_buffers())
        perm = np.random.default_rng(0).permutation(rays.shape[0])
        bs = cfg.batch_size
        step_i = [0]

        def step():
            i = step_i[0] % (rays.shape[0] // bs)
            idx = torch.from_numpy(perm[i * bs:(i + 1) * bs]).to(dev)
            step_i[0] += 1
            aux = trainer.train_step(statics, {"rays": rays[idx],
                                               "rgbs": rgbs[idx],
                                               "mirror_mask": masks[idx]})
            return float(aux["loss"])  # waits for the step

        for _ in range(3):
            step()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        per_step = (time.perf_counter() - t0) / 10
        n0 = (fct.launches_fwd, fct.launches_bwd)
        wall, events = profile(lambda: [step() for _ in range(3)], acts)
        launches = (fct.launches_fwd - n0[0], fct.launches_bwd - n0[1])

    dev_ev = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    cpu_ev = [e for e in events if e.get("cat") in
              ("cpu_op", "user_annotation", "python_function",
               "cuda_runtime")]
    span_lo = min(e["ts"] for e in cpu_ev + dev_ev)
    span = max(e["ts"] + e["dur"] for e in cpu_ev + dev_ev) - span_lo
    busy = busy_union([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev])
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_ev:
        by_name[e["name"][:70]][0] += 1
        by_name[e["name"][:70]][1] += e["dur"]
    device = ("device: not measured" if opt.cpu else
              f"device busy (union) {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / span:.4f}")
    print(f"=== reflection-stage steps, batch {bs}: unprofiled "
          f"{per_step * 1e3:.1f} ms/step -> {bs / per_step:.1f} rays/s; "
          f"3 profiled steps {wall * 1e3:.1f} ms, trace span "
          f"{span / 1e3:.1f} ms, {device}; train kernel launches fwd "
          f"{launches[0]}, bwd {launches[1]}; device events {len(dev_ev)} "
          f"({card})", flush=True)
    for name, (cnt, dur) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:16]:
        print(f"  {dur / 1e3:9.2f} ms {100 * dur / max(span, 1):5.1f}% "
              f"x{cnt:5d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
