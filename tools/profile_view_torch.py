#!/usr/bin/env python
"""Profile one level-2 view of the PyTorch + CUDA port.

    python3 tools/profile_view_torch.py                     # CP grid, 800×800
    python3 tools/profile_view_torch.py --model_type nerf   # flagship, 400×300
    python3 tools/profile_view_torch.py --model_type nerf --noise_std 1
    python3 tools/profile_view_torch.py --model_type nerf_tcnn  # 800×800
    python3 tools/profile_view_torch.py --model_type nerf_tcnn --fused_field
    python3 tools/profile_view_torch.py --cpu 48            # CPU rehearsal

Renders the `chip_smoke.py` view (bench camera, run.sh mode-1 flags of the
model, seeded and all-mirror weights) through `run_view`: one warm view,
three timed ones, then one under `torch.profiler`. The CP grid (nerf_tpu)
and the hash-grid model (nerf_tcnn; its all-mirror weights also scale the
table's dense levels ×1e4, chip_smoke's `_dense_scaled`) render 800×800,
the flagship PE-MLP (nerf) the livingroom preset's 400×300. From the
exported trace it prints, per weight set:

  * the trace span: first to last CPU-op or device event;
  * device busy time: the union of the kernel, memcpy and memset intervals;
  * the idle share, 1 − busy / span;
  * device time and call count by kernel name;
  * the port kernel's launches in the profiled view and its share of the
    span, and the share of every other device event (the PyTorch
    compositing, sampling and copies); for nerf_tcnn also the share of the
    PyTorch nets (cuBLAS/CUTLASS GEMM kernels), since its kernel is the
    encoder alone.

With `--fused_field` the hash-grid model renders through the fused NGP
composite (`hash_field_kernel`, ops/fused_hash.py) in place of ENCODE and
the PyTorch nets; its launches and share are the kernel's, and ENCODE's
launches in the profiled view are printed beside them (the other two
models' flags always carry --fused_field).

With `--noise_std` > 0 every pass draws σ noise, so the fused passes run
the per-sample rows mode of the kernel and composite in PyTorch (the eval
CLI pins noise 0; no CLI reaches this path).

Imports only the port (`mirror_nerf_tpu_torch`), never JAX. The CPU
rehearsal (SIZE×SIZE; small CP levels for nerf_tpu) reports no device
numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def busy_union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(run, activities):
    """Run `run()` under torch.profiler; return its wall (s) and the trace's
    complete ("X") events."""
    import torch

    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall, [e for e in events if e.get("ph") == "X"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, metavar="SIZE", default=0,
                    help="rehearse on the CPU at SIZE×SIZE with small levels")
    ap.add_argument("--model_type", default="nerf_tpu",
                    choices=["nerf_tpu", "nerf", "nerf_tcnn"])
    ap.add_argument("--noise_std", type=float, default=0.0,
                    help="σ noise of every pass (> 0: the rows kernels)")
    ap.add_argument("--fused_field", action="store_true",
                    help="nerf_tcnn: the fused NGP composite")
    opt = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from mirror_nerf_tpu_torch.eval import get_opt
    from mirror_nerf_tpu_torch.eval.apps import AppContext, run_view
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import (fused_cp, fused_hash, fused_mlp,
                                           fused_mlp_t, hashgrid)

    nerf = opt.model_type == "nerf"
    ngp = opt.model_type == "nerf_tcnn"
    ngp_fused = ngp and opt.fused_field
    noisy = opt.noise_std > 0
    kernel_name = {"nerf": "mlp_field_kernel", "nerf_tcnn":
                   "hash_encode_kernel"}.get(opt.model_type, "cp_field_kernel")
    if ngp_fused:
        kernel_name = "hash_field_kernel"

    def launches() -> int:
        if ngp_fused:
            return fused_hash.launches
        if ngp:
            return hashgrid.launches_encode
        if nerf:
            return (fused_mlp.launches_general_rays if noisy
                    else fused_mlp_t.launches)
        return fused_cp.launches_rows if noisy else fused_cp.launches
    w, h = (opt.cpu, opt.cpu) if opt.cpu else ((400, 300) if nerf
                                               else (800, 800))
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

    flags = ({"nerf": cs.NERF_EVAL_FLAGS, "nerf_tcnn": cs.NGP_EVAL_FLAGS}
             .get(opt.model_type, cs.EVAL_FLAGS)
             + ["--img_wh", str(w), str(h)]
             + (["--fused_field"] if ngp_fused else []))
    if opt.cpu:
        flags += ["--chunk", "1024"] + (
            ["--grid_levels", "16:8,32:8"] if opt.model_type == "nerf_tpu"
            else [])
    cfg, args = get_opt(flags)
    field = make_field(cfg)
    ctx = AppContext.build(cfg, args, field, init_params(field, cfg, dev),
                           dev)
    if noisy:
        ctx = replace(ctx, rs=replace(ctx.rs, noise_std=opt.noise_std),
                      rs_sec=None if ctx.rs_sec is None else replace(
                          ctx.rs_sec, noise_std=opt.noise_std))
    rays_np = cs._view_rays(w, h)
    sample = {"rays": rays_np}
    def all_mirror(p):
        return cs._dense_scaled(field, cs._all_mirror(p)) if ngp \
            else cs._all_mirror(p)

    mirror_ctx = replace(ctx, params={k: all_mirror(v)
                                      for k, v in ctx.params.items()})

    for label, c in (("seeded", ctx), ("all-mirror", mirror_ctx)):
        run_view(c, sample)  # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run_view(c, sample)
            walls.append(time.perf_counter() - t0)
        n0, e0 = launches(), hashgrid.launches_encode
        wall_prof, events = profile(lambda: run_view(c, sample), acts)
        n_launches = launches() - n0
        n_encode = hashgrid.launches_encode - e0
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
        k_dur = sum(e["dur"] for e in dev_ev if kernel_name in e["name"])
        nets = sum(e["dur"] for e in dev_ev if any(
            t in e["name"].lower() for t in ("gemm", "cutlass", "xmma")))
        o_dur = sum(e["dur"] for e in dev_ev) - k_dur - (nets if ngp else 0)
        device = ("device: not measured" if opt.cpu else
                  f"device busy (union) {busy / 1e3:.1f} ms, idle share "
                  f"{1 - busy / span:.4f}, {kernel_name} "
                  f"{k_dur / 1e3:.1f} ms = {k_dur / span:.4f} of the span, "
                  + (f"PyTorch nets (GEMM kernels) {nets / 1e3:.1f} ms = "
                     f"{nets / span:.4f}, " if ngp else "")
                  + f"other device events {o_dur / 1e3:.1f} ms = "
                  f"{o_dur / span:.4f}")
        print(f"=== {opt.model_type} {w}x{h} {label}, noise_std "
              f"{opt.noise_std}: unprofiled walls "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms -> "
              f"{len(rays_np) / min(walls):.1f} rays/s; profiled wall "
              f"{wall_prof * 1e3:.1f} ms, trace span {span / 1e3:.1f} ms, "
              f"{device}; kernel launches {n_launches}"
              + (f", ENCODE launches {n_encode}" if ngp_fused else "")
              + "; device events "
              f"{len(dev_ev)} ({card})", flush=True)
        for name, (cnt, dur) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:14]:
            print(f"  {dur / 1e3:9.2f} ms {100 * dur / max(span, 1):5.1f}% "
                  f"x{cnt:5d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
