#!/usr/bin/env python
"""GPU smoke test of the PyTorch + CUDA port (`mirror_nerf_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernel is built from `mirror_nerf_tpu_torch/
csrc/` at first use) and this checkout; it imports nothing of JAX. Phases,
each fatal on failure:

  1. environment: torch/CUDA versions, the card's name and power limit,
     whether nvcc and triton are present; TF32 off for the plain versions;
  2. build the fused CP composite kernel, print the build seconds and the
     compiler's register/spill report;
  3. kernel vs plain PyTorch version on the card, default CP field
     (levels 64:64,256:64,512:64, bound 6, seeded weights), 16384 rays:
     S=128 full and S=64 σ-only, relu and softplus, plus a saturating field
     (σ ≳ 1e3); max abs error per output, per-ray Σw ≤ 1 + 1e-5, times;
  4. the main path: the port's eval CLI on a generated 64×64 mirror scene
     (run.sh mode-1 nerf_tpu flags, with and without --proposal_skip), then
     one 800×800 view through run_view with a level-2 trace; the launch
     counter is reset before the CLI and read right after the timed run_view
     calls, before any diagnostic render; outputs checked finite, on the
     card, and against the plain version on a small input.

It prints one JSON line with the kernel's numbers, the nvidia-smi name and
power limit, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# fp32 kernel against the fp32 plain version: other summation orders only
KERNEL_ATOL = 1e-4
# the whole render on the card against the plain version on the CPU:
# samples and compaction compound the summation-order differences
RENDER_ATOL = 1e-3
EVAL_FLAGS = ["--dataset_name", "blender", "--near", "0.05", "--far", "8",
              "--model_type", "nerf_tpu", "--predict_normal",
              "--predict_mirror_mask", "--trace_secondary_rays",
              "--bound", "6", "--N_importance", "64", "--chunk", "16384",
              "--fused_field", "--max_recursive_level", "2"]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment(torch):
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    log(f"[env] nvcc: {nvcc or 'absent'}; triton: {triton_v or 'absent'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from mirror_nerf_tpu_torch.ops import _build, fused_cp

    fused_cp._library()
    secs = _build.build_seconds[fused_cp._LIB]
    log(f"[build] {fused_cp._LIB}: {secs:.1f} s"
        + (" (cached library)" if secs == 0.0 else ""))
    for line in _build.build_log.get(fused_cp._LIB, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    return secs


def _time_ms(torch, fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _view_rays(size: int):
    """The bench camera (first pose of the procedural ring, 0.9 rad fov)."""
    import numpy as np

    from mirror_nerf_tpu_torch.core.rays import (get_ray_directions,
                                                 get_rays, make_ray_buffer)
    from mirror_nerf_tpu_torch.data.synthetic import camera_ring

    focal = 0.5 * size / np.tan(0.5 * 0.9)
    o, d = get_rays(get_ray_directions(size, size, focal), camera_ring(1)[0])
    return make_ray_buffer(o, d, 0.05, 8.0)


def phase_kernel(torch, card: str) -> dict:
    """Kernel vs plain at the main path's shapes. Returns the JSON entry."""
    from mirror_nerf_tpu_torch.core.sampling import (merge_fine_z_vals,
                                                     stratified_z_vals)
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import fused_cp

    dev = torch.device("cuda")
    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    seeded = field.init(torch.Generator().manual_seed(0), dev)
    saturating = dict(seeded)
    s2 = seeded["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 2000.0
    saturating["sigma_net"] = [seeded["sigma_net"][0], {"w": s2}]

    n = 16384
    rays_np = _view_rays(800)
    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).to(dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    z64 = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 64).contiguous()

    worst = 0.0
    entry_ms = entry_plain = None
    for pname, params in (("seeded", seeded), ("saturating", saturating)):
        for act in (("relu", "softplus") if pname == "seeded" else ("relu",)):
            coarse = fused_cp.cp_rays_composite_reference(
                field, params, o, d, d, z64, sigma_only=True, sigma_act=act)
            z128 = merge_fine_z_vals(z64, coarse["weights"], 64,
                                     0.0).contiguous()
            for sigma_only, z in ((False, z128), (True, z64)):
                def kern():
                    return fused_cp.fused_cp_rays_composite(
                        field, params, o, d, d, z, sigma_only=sigma_only,
                        sigma_act=act)

                def plain():
                    return fused_cp.cp_rays_composite_reference(
                        field, params, o, d, d, z, sigma_only=sigma_only,
                        sigma_act=act)

                got, ref = kern(), plain()
                torch.cuda.synchronize()
                errs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
                wsum = float(got["weights"].sum(-1).max())
                for k, v in got.items():
                    assert v.is_cuda and bool(torch.isfinite(v).all()), k
                ms = _time_ms(torch, kern, reps=20, warmup=3)
                plain_ms = _time_ms(torch, plain, reps=3, warmup=1)
                tag = (f"{pname} {act} S={z.shape[1]} "
                       f"{'sigma-only' if sigma_only else 'full'}")
                log(f"[kernel] {tag}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms ({n} rays, {card}); max w "
                    f"{float(got['weights'].max()):.4f}, max Σw {wsum:.6f}; "
                    "max abs err " + ", ".join(
                        f"{k} {v:.3e}" for k, v in errs.items()))
                assert max(errs.values()) <= KERNEL_ATOL, (tag, errs)
                assert wsum <= 1.0 + 1e-5, (tag, wsum)
                worst = max(worst, max(errs.values()))
                if (pname, act, sigma_only) == ("seeded", "relu", False):
                    entry_ms, entry_plain = ms, plain_ms
    return {"name": "fused_cp_composite", "route": "cuda",
            "source": "mirror_nerf_tpu_torch/csrc/fused_cp_composite.cu",
            "replaces": "mirror_nerf_tpu/ops/pallas/fused_cp.py:363",
            "launches": 0, "max_abs_err": worst, "ms": entry_ms,
            "plain_ms": entry_plain}


def _check_against_plain(torch, ctx, rays_np):
    """The main path on the card vs the plain version on the CPU, 1024 rays."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import eval_trace
    from mirror_nerf_tpu_torch.render.renderer import render_rays
    from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                         params_to_numpy)

    cpu_params = params_from_numpy(params_to_numpy(ctx.params))
    sub = rays_np[::len(rays_np) // 1024][:1024]
    with torch.no_grad():
        g = render_rays(ctx.field, ctx.params,
                        torch.from_numpy(sub).cuda(), ctx.rs)
        c = render_rays(ctx.field, cpu_params, torch.from_numpy(sub), ctx.rs)
        errs = {k: float((g[k].cpu() - c[k]).abs().max())
                for k in ("rgb_fine", "depth_fine", "opacity_fine",
                          "mirror_mask_fine", "surface_normal_fine")}
        log("[main] render_rays card vs plain CPU, 1024 rays, all-mirror "
            f"weights (mean opacity {float(c['opacity_fine'].mean()):.3f}, "
            f"mean depth {float(c['depth_fine'].mean()):.3f}): max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        assert max(errs.values()) <= RENDER_ATOL, errs
        args = (ctx.rs, ctx.app, 2, True)
        gt = eval_trace(ctx.field, ctx.params, torch.from_numpy(sub).cuda(),
                        *args, compact_frac=0.5)
        ct = eval_trace(ctx.field, cpu_params, torch.from_numpy(sub), *args,
                        compact_frac=0.5)
        for k, v in gt.items():
            assert v.is_cuda, k
        same = (gt["mirror_mask_resolved"].cpu()
                == ct["mirror_mask_resolved"]).numpy()
        err = float(np.abs(gt["rgb_fine"].cpu().numpy()
                           - ct["rgb_fine"].numpy())[same].max())
        log(f"[main] eval_trace level 2 card vs plain CPU: mirror mask "
            f"agrees on {same.mean() * 100:.2f}% of rays (mirror fraction "
            f"{float(ct['mirror_mask_resolved'].mean()):.3f}, overflow "
            f"{float(ct['compact_dropped'].sum()):.0f} rays), max abs rgb "
            f"err {err:.2e} there")
        assert same.mean() >= 0.99 and err <= RENDER_ATOL, (same.mean(), err)


def _all_mirror(params: dict) -> dict:
    """Seeded weights with σ ≥ 0 everywhere and the mirror head biased on:
    every ray is an opaque mirror at every level, the heaviest trace."""
    out = dict(params)
    s2 = params["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 5.0
    out["sigma_net"] = [params["sigma_net"][0], {"w": s2}]
    m2 = dict(params["is_mirror"][1])
    m2["b"] = m2["b"] + 5.0
    out["is_mirror"] = [params["is_mirror"][0], m2]
    return out


def _time_view(ctx, rays_np):
    """Time one 800×800 view through run_view (after one warm view).
    Returns the last result and the walls in seconds."""
    from mirror_nerf_tpu_torch.eval.apps import run_view

    sample = {"rays": rays_np}
    run_view(ctx, sample)  # warm: allocator, cuBLAS handles
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = run_view(ctx, sample)
        times.append(time.perf_counter() - t0)
    return res, times


def _report_view(torch, ctx, rays_np, res, times, label: str,
                 card: str) -> None:
    """Check a timed view's outputs and print its rate and mirror fractions
    (these diagnostics launch the kernel too: call after reading the
    main path's launch count)."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import (estimate_mirror_fraction,
                                                 pick_capacity)

    n = rays_np.shape[0]
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved"):
        assert res[k].shape[0] == n and np.isfinite(res[k]).all(), k
    rays = torch.from_numpy(rays_np).cuda()
    est = estimate_mirror_fraction(ctx, rays)
    f0, f1 = _mirror_fractions(torch, ctx, rays[::16])
    dropped = float(res.get("compact_dropped", np.zeros(1)).sum())
    log(f"[main] 800x800 level-2 view, {label}: {min(times):.3f} s best of "
        f"{len(times)} ({', '.join(f'{t:.3f}' for t in times)}) -> "
        f"{n / min(times):.1f} rays/s ({card}); mirror fraction level 0 "
        f"{f0:.4f}, levels 0+1 {f1:.4f} (1/16 of the rays), prepass "
        f"estimate {est:.4f} -> capacity {pick_capacity(est)}, dropped "
        f"{dropped:.0f}")


def _mirror_fractions(torch, ctx, rays: "torch.Tensor"):
    """Fraction of rays that are mirrors at level 0, and at levels 0 and 1."""
    from mirror_nerf_tpu_torch.core.mathutil import l2_normalize, reflect
    from mirror_nerf_tpu_torch.render.renderer import render_rays
    from mirror_nerf_tpu_torch.render.tracer import RAY_FORWARD_OFFSET

    with torch.no_grad():
        r0 = render_rays(ctx.field, ctx.params, rays, ctx.rs)
        m0 = r0["mirror_mask_fine"] > 0.5
        sec = torch.cat([r0["x_surface_fine"],
                         reflect(rays[:, 3:6],
                                 l2_normalize(r0["surface_normal_fine"])),
                         torch.full_like(rays[:, 7:8], RAY_FORWARD_OFFSET),
                         rays[:, 7:8]], dim=-1)
        m1 = render_rays(ctx.field, ctx.params, sec,
                         ctx.rs)["mirror_mask_fine"] > 0.5
    return float(m0.float().mean()), float((m0 & m1).float().mean())


def phase_main_path(torch, card: str) -> int:
    import numpy as np

    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import get_opt, main
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import fused_cp

    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        generate_scene("scene", n_train=1, n_val=1, n_test=2,
                       img_wh=(64, 64))
        fused_cp.launches = 0
        for tag, extra in (("proposal", []), ("skip", ["--proposal_skip"])):
            t0 = time.perf_counter()
            out = main(EVAL_FLAGS + ["--root_dir", "scene", "--img_wh", "64",
                                     "64", "--split", "test",
                                     "--exp_name", f"smoke_{tag}"] + extra)
            files = os.listdir(out)
            for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                         f"smoke_{tag}_rgb_fine.gif"):
                assert name in files, (tag, name, files)
            with open(os.path.join(out, "psnr.json")) as f:
                table = json.load(f)
            assert np.isfinite(table["mean_psnr"]), table
            log(f"[main] eval CLI ({tag}) wrote {out}: "
                f"{len(files)} entries, mean PSNR {table['mean_psnr']:.2f} "
                f"(seeded weights), {time.perf_counter() - t0:.1f} s")
        cli_launches = fused_cp.launches
        assert cli_launches > 0, "the eval CLI never launched the kernel"

        cfg, args = get_opt(EVAL_FLAGS + ["--img_wh", "800", "800"])
        field = make_field(cfg)
        ctx = AppContext.build(cfg, args, field,
                               init_params(field, cfg, "cuda"), "cuda")
        for side in ctx.params.values():
            for leaf in (side["grid"]["fold"], side["sigma_net"][0]["w"]):
                assert leaf.is_cuda
        rays_np = _view_rays(800)
        mirror_ctx = replace(ctx, params={k: _all_mirror(v)
                                          for k, v in ctx.params.items()})
        views = [(label, c, *_time_view(c, rays_np))
                 for label, c in (("seeded weights", ctx),
                                  ("all-mirror weights", mirror_ctx))]
        # the main path's count ends here: the diagnostics below launch too
        launches = fused_cp.launches
        assert launches > cli_launches, "run_view never launched the kernel"
        log(f"[main] kernel launches on the main path: {launches} "
            f"({cli_launches} in the eval CLI, {launches - cli_launches} in "
            "the timed run_view calls)")
        for label, c, res, times in views:
            _report_view(torch, c, rays_np, res, times, label, card)
        _check_against_plain(torch, mirror_ctx, rays_np)
        return launches
    finally:
        os.chdir(cwd)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mirror_nerf_tpu_torch

    if Path(mirror_nerf_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print("chip_smoke: mirror_nerf_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 1
    card = phase_environment(torch)
    phase_build()
    entry = phase_kernel(torch, card)
    entry["launches"] = phase_main_path(torch, card)
    assert "jax" not in sys.modules and "mirror_nerf_tpu" not in sys.modules
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
