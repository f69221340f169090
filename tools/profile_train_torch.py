#!/usr/bin/env python
"""Profile reflection-stage train steps of the PyTorch + CUDA port.

    python3 tools/profile_train_torch.py            # on a CUDA card
    python3 tools/profile_train_torch.py --cpu      # CPU rehearsal
    python3 tools/profile_train_torch.py --other build/other  # in turns
    python3 tools/profile_train_torch.py --model_type nerf_tcnn --other DIR

Builds the `chip_smoke.py` training configuration (run.sh mode-0 nerf_tpu
flags, full width, batch 1024, novel-ray reg on; with `--model_type
nerf_tcnn` or `nerf` that model's, as chip_smoke.py phase 17 trains it:
its own `--decay_step 2 4 8`, no `--grid_lr_mult`) on a generated 64×64
procedural scene, takes reflection-stage steps through `Trainer.train_step`:
three warm steps, ten timed ones (host clock, synchronized), then three
under `torch.profiler` (`step_profile`, which chip_smoke.py phase 7 uses
too). With `--other DIR`, this checkout's step and DIR's from the same
initial weights, timed in turns (`step_ab`). From the exported trace it prints the trace span, the summed device
time of one step and the train kernels' share of it, the device busy time
(union of kernel, memcpy and memset intervals), the idle share 1 − busy /
span, and device time and calls by kernel name.

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

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from profile_view_torch import busy_union, profile  # noqa: E402

TRAIN_KERNELS = ("fwd_kernel", "bwd_kernel")  # csrc/fused_cp_train.cu
# the hash grid's kernels (csrc/hashgrid.cu), each share printed
HASH_KERNELS = (("BWD", "hash_backward_kernel"),
                ("BWD2", "hash_backward2_kernel"),
                ("ENCODE", "hash_encode_kernel"))


def step_breakdown(events, steps: int) -> dict:
    """A trace of `steps` train steps → its span, the summed device time of
    one step (kernels, copies, sets), the train kernels' share of it, the
    device's busy time (the union of those intervals) and idle share
    (1 − busy / span), device events a step, and device time and calls by
    kernel name (ms, all steps)."""
    dev_ev = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    cpu_ev = [e for e in events if e.get("cat") in
              ("cpu_op", "user_annotation", "python_function",
               "cuda_runtime")]
    span_lo = min(e["ts"] for e in cpu_ev + dev_ev)
    span = max(e["ts"] + e["dur"] for e in cpu_ev + dev_ev) - span_lo
    busy = busy_union([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev])
    summed = sum(e["dur"] for e in dev_ev)
    train = sum(e["dur"] for e in dev_ev
                if any(k in e.get("name", "") for k in TRAIN_KERNELS))
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_ev:
        by_name[e["name"][:70]][0] += 1
        by_name[e["name"][:70]][1] += e["dur"] / 1e3
    return {"span_ms": span / 1e3, "device_ms_per_step": summed / 1e3 / steps,
            "train_kernel_share": train / max(summed, 1e-9),
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
            "events_per_step": len(dev_ev) / steps, "by_name": dict(by_name)}


def kernel_ms(r: dict, key: str) -> float:
    """The device ms of the kernels whose name holds `key`, over a
    breakdown's steps."""
    return sum(ms for name, (_, ms) in r["by_name"].items() if key in name)


def stepper(trainer, cfg, dev: str, loop=None):
    """One reflection-stage step of `trainer` a call, on its dataset's rays
    (batch cfg.batch_size, a seeded permutation); returns the loss, which
    waits for the step. `loop`: the train.loop module of the trainer's
    tree (default this checkout's)."""
    import torch

    if loop is None:
        from mirror_nerf_tpu_torch.train import loop
    ds = trainer.dataset
    ds.train_geometry_stage = False
    statics = loop.EpochStatics.of(cfg, cfg.train_geometry_stage_end_epoch,
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
        return float(aux["loss"])
    return step


def step_profile(trainer, cfg, dev: str, activities, steps: int = 3,
                 timed: int = 10) -> dict:
    """Reflection-stage steps of `trainer` (`stepper`): three warm steps,
    `timed` synchronized ones on the host clock (ms a step, rays/s), then
    `steps` under torch.profiler (`step_breakdown`), with the train
    kernels' launches in those steps."""
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct

    step = stepper(trainer, cfg, dev)
    bs = cfg.batch_size
    for _ in range(3):
        step()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    per_step = (time.perf_counter() - t0) / timed
    n0 = (fct.launches_fwd, fct.launches_bwd)
    wall, events = profile(lambda: [step() for _ in range(steps)],
                           activities)
    out = step_breakdown(events, steps)
    out.update(ms_per_step=per_step * 1e3, rays_per_s=bs / per_step,
               profiled_wall_ms=wall * 1e3, batch=bs,
               launches=(fct.launches_fwd - n0[0], fct.launches_bwd - n0[1]))
    return out


def step_ab(other_root: str, cfg, root: str, workdir: str, dev: str,
            rounds: int = 5, steps: int = 10, activities=None) -> dict:
    """This checkout's and another's (`exp_launch_ab.load_other`) Trainer
    on the same scene and initial weights, their reflection-stage steps
    timed in turns: `rounds` rounds of `steps` synchronized steps each
    (the order reversed every other round), after three warm steps; ms a
    step of each round, the best and the median, and for this tree each
    round's difference from the other's (this − other). With `activities`, then three steps
    of each tree under torch.profiler (`step_breakdown`): the summed
    device time of a step, the idle share and the hash grid's kernels'
    shares."""
    import importlib

    from mirror_nerf_tpu_torch.tools.exp_launch_ab import OTHER, load_other

    load_other(other_root)
    steps_of, params = {}, None
    for tree, prefix in (("this", "mirror_nerf_tpu_torch"),
                         ("other", OTHER)):
        data = importlib.import_module(f"{prefix}.data.blender")
        loop = importlib.import_module(f"{prefix}.train.loop")
        ds = data.BlenderDataset(root, "train", cfg.img_wh, cfg)
        tr = loop.Trainer(cfg, ds, str(Path(workdir) / tree), dev,
                          params=params)
        if params is None:  # the other tree starts from a copy of these
            from mirror_nerf_tpu_torch.train.checkpoints import _map
            params = _map(tr.params, lambda _, v: v.detach().clone())
        steps_of[tree] = stepper(tr, cfg, dev, loop)
        for _ in range(3):
            steps_of[tree]()
    runs = {tree: [] for tree in steps_of}
    for r in range(rounds):
        for tree in (("this", "other") if r % 2 == 0 else ("other", "this")):
            t0 = time.perf_counter()
            for _ in range(steps):
                steps_of[tree]()
            runs[tree].append((time.perf_counter() - t0) / steps * 1e3)
    out = {tree: {"ms": ms, "best_ms": min(ms),
                  "median_ms": float(np.median(ms)),
                  "rays_per_s": cfg.batch_size / min(ms) * 1e3}
           for tree, ms in runs.items()}
    out["this"]["minus_other_ms"] = [a - b for a, b in zip(runs["this"],
                                                            runs["other"])]
    for tree in (steps_of if activities else ()):
        _, events = profile(lambda t=tree: [steps_of[t]() for _ in range(3)],
                            activities)
        b = step_breakdown(events, 3)
        out[tree].update(
            device_ms_per_step=b["device_ms_per_step"],
            idle_share=b["idle_share"],
            shares={label: kernel_ms(b, key)
                    / max(3 * b["device_ms_per_step"], 1e-9)
                    for label, key in HASH_KERNELS})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU with small levels")
    ap.add_argument("--other", help="another checkout of the repository: "
                    "its step and this one's, timed in turns")
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds in turns with --other (10 steps each)")
    ap.add_argument("--model_type", default="nerf_tpu",
                    choices=("nerf_tpu", "nerf_tcnn", "nerf"),
                    help="the model trained (default the CP grid)")
    opt = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.train.cli import get_opt
    from mirror_nerf_tpu_torch.train.loop import Trainer

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
        flags = (cs.TRAIN_FLAGS if opt.model_type == "nerf_tpu" else
                 cs._model_train_flags(opt.model_type)) + [
            "--root_dir", root, "--img_wh", "64", "64", "--device", dev]
        if opt.cpu:
            flags += ["--batch_size", "256"]
            if opt.model_type == "nerf_tpu":
                flags += ["--grid_levels", "16:8,32:8"]
        cfg, _ = get_opt(flags)
        ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
        trainer = Trainer(cfg, ds, str(Path(tmp) / "run"), dev)
        r = step_profile(trainer, cfg, dev, acts)
        ab = (step_ab(opt.other, cfg, root, str(Path(tmp) / "ab"), dev,
                      rounds=opt.rounds,
                      activities=None if opt.cpu else acts)
              if opt.other else None)

    device = ("device: not measured" if opt.cpu else
              f"summed device time {r['device_ms_per_step']:.2f} ms a step, "
              f"train kernels {100 * r['train_kernel_share']:.1f} % of it; "
              f"device busy (union) {r['busy_ms']:.1f} ms, idle share "
              f"{r['idle_share']:.4f}")
    print(f"=== reflection-stage steps, batch {r['batch']}: unprofiled "
          f"{r['ms_per_step']:.1f} ms/step -> {r['rays_per_s']:.1f} rays/s; "
          f"3 profiled steps {r['profiled_wall_ms']:.1f} ms, trace span "
          f"{r['span_ms']:.1f} ms, {device}; train kernel launches fwd "
          f"{r['launches'][0]}, bwd {r['launches'][1]}; device events "
          f"{r['events_per_step']:.0f} a step ({card})", flush=True)
    if opt.model_type == "nerf_tcnn" and not opt.cpu:
        dev_ms = r["device_ms_per_step"] * 3  # the 3 profiled steps
        print("=== the hash grid's kernels' shares of the summed device "
              "time: " + ", ".join(
                  f"{label} {100 * kernel_ms(r, key) / dev_ms:.1f} %"
                  for label, key in HASH_KERNELS) + f" ({card})", flush=True)
    for name, (cnt, ms) in sorted(r["by_name"].items(),
                                  key=lambda kv: -kv[1][1])[:16]:
        print(f"  {ms:9.2f} ms {100 * ms / max(r['span_ms'], 1e-9):5.1f}% "
              f"x{cnt:5d}  {name}")
    if ab:
        for tree, v in ab.items():
            print(f"=== in turns, {tree} tree"
                  + (f" ({opt.other})" if tree == "other" else "")
                  + f": ms a step by round {[round(m, 2) for m in v['ms']]}"
                  f", best {v['best_ms']:.2f} -> {v['rays_per_s']:.1f} rays/s"
                  f", median {v['median_ms']:.2f}, range "
                  f"{min(v['ms']):.2f}–{max(v['ms']):.2f}"
                  + ("" if "minus_other_ms" not in v else
                     f"; this − other by round "
                     f"{[round(d, 2) for d in v['minus_other_ms']]}, median "
                     f"{float(np.median(v['minus_other_ms'])):.2f}, slower "
                     f"in {sum(d > 0 for d in v['minus_other_ms'])} of "
                     f"{len(v['minus_other_ms'])}")
                  + ("" if "device_ms_per_step" not in v else
                     f"; traced after the rounds: summed device time "
                     f"{v['device_ms_per_step']:.3f} ms a step, idle share "
                     f"{v['idle_share']:.4f}, " + ", ".join(
                         f"{k} {100 * x:.1f} %" for k, x in
                         v["shares"].items()))
                  + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
