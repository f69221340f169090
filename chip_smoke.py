#!/usr/bin/env python
"""GPU smoke test of the PyTorch + CUDA port (`mirror_nerf_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from `mirror_nerf_tpu_torch/
csrc/` at first use) and this checkout; it imports nothing of JAX. Phases,
each fatal on failure:

  1. environment: torch/CUDA versions, the card's name and power limit,
     whether nvcc and triton are present; TF32 off for the plain versions;
  2. build both kernel libraries at once (one nvcc each), print the build
     seconds and the compiler's register/spill report;
  3. the composite kernel vs its plain PyTorch version on the card, default
     CP field (levels 64:64,256:64,512:64, bound 6, seeded weights), 16384
     rays: S=128 full and S=64 σ-only, relu and softplus, plus a saturating
     field (σ ≳ 1e3); max abs error per output, per-ray Σw ≤ 1 + 1e-5, times;
  4. the training kernels vs their plain versions at the training path's
     shapes (T = 131072 and 65536 + 37, ~2 % of the points outside the
     bound): forward with tangents and density-only; backward under random
     cotangents on σ, geo and tanh(∇σ), density-only with and without d_x,
     and a saturating σ field; the backward twice for the run-to-run spread
     of its atomics; kernel and plain times, forward and forward+backward;
  5. the composite kernel's gradient guard: it raises on parameters that
     require grad;
  6. the eval path: the port's eval CLI on a generated 64×64 mirror scene
     (run.sh mode-1 nerf_tpu flags, with and without --proposal_skip), then
     one 800×800 view through run_view with a level-2 trace; the launch
     counter is reset before the CLI and read right after the timed run_view
     calls, before any diagnostic render; outputs checked finite, on the
     card, and against the plain version on a small input;
  7. the training path: the port's train CLI (run.sh mode-0 nerf_tpu
     flags, full width, a geometry epoch and a reflection epoch with
     novel-ray reg) on a generated 64×64 scene, the train launch counters
     reset before it and read after; finite losses, parameters and optimizer
     state on the card, the reflection-stage train-step rate at batch 1024;
     its last.ckpt.npz rendered through the eval CLI;
  8. one reflection-stage loss and backward on the card against the plain
     version on the CPU, from the same parameters: the loss and every
     gradient leaf.

It prints one JSON line with the three kernels' numbers, the nvidia-smi name
and power limit, and last `{"ok": true, "device": {...}}`.
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
# the training kernels: fp32 forward values against the fp32 plain version
# (abs, relative to the magnitude above 1: the saturating field's σ ~1e3)
TRAIN_FWD_ATOL = 1e-4
# gradients, max|a − b| / max|a|: the backward sums with atomics, in an
# order that changes from run to run
TRAIN_GRAD_RTOL = 1e-3
TRAIN_FLAGS = ["--dataset_name", "blender", "--near", "0.05", "--far", "8",
               "--model_type", "nerf_tpu", "--predict_normal",
               "--predict_mirror_mask", "--trace_secondary_rays",
               "--bound", "6", "--N_importance", "64", "--noise_std", "1",
               "--batch_size", "1024", "--optimizer", "adam", "--lr", "5e-4",
               "--lr_scheduler", "steplr", "--decay_step", "8", "14", "18",
               "--decay_gamma", "0.5", "--chunk", "8192",
               "--train_geometry_stage", "--use_plane_consistent_loss",
               "--only_trace_rays_in_mirrors", "--train_skip_step", "1",
               "--novel_ray_batch", "512", "--novel_pose_jitter", "0.2",
               "--novel_ray_loss_weight", "3e-3", "--grid_lr_mult", "20",
               "--adam_eps", "1e-15",
               # shortened schedule: a geometry epoch, then a reflection
               # epoch with the novel-ray reg
               "--num_epochs", "2", "--train_geometry_stage_end_epoch", "1",
               "--novel_ray_start_epoch", "1"]
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
    from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_cp_train

    names = (fused_cp._LIB, fused_cp_train._LIB)
    t0 = time.perf_counter()
    _build.build_libraries(names)
    fused_cp._library()
    fused_cp_train._library()
    log(f"[build] both libraries in {time.perf_counter() - t0:.1f} s wall")
    for name in names:
        secs = _build.build_seconds[name]
        log(f"[build] {name}: {secs:.1f} s"
            + (" (cached library)" if secs == 0.0 else ""))
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build] {line.strip()}")


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


def _rel(a, b) -> float:
    """max|a − b| / max|a| (a: the plain version)."""
    return float((a - b).abs().max()) / (float(a.abs().max()) + 1e-30)


def _train_case(torch, params, t: int, seed: int):
    """T points, ~2 % of them outside the bound (each axis uniform over
    ±1.0068·bound), and cotangents on σ, geo and ∇σ, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.rand((t, 3), generator=g, device="cuda") * 2 - 1) * 6.0408
    cots = [torch.randn(s, generator=g, device="cuda")
            for s in ((t,), (t, 15), (t, 3))]
    return x.contiguous(), cots


def _train_grads(torch, fn, field, params, x, cots, tangents: bool,
                 need_dx: bool = True, nscale: float = 1.0):
    """Outputs and the grads (param leaves, then x) of the cotangent loss
    Σ σ·a + Σ geo·b [+ Σ tanh(nscale·∇σ)·c] through `fn`. On a field whose
    σ is scaled up, nscale scales ∇σ back: tanh saturates above ~9, where
    1 − tanh² cancels, and two ∇σ that agree to 1e-7 would give cotangents
    that differ by ~1e-3."""
    from mirror_nerf_tpu_torch.ops.fused_cp_train import _param_args

    leaves = [p.detach().requires_grad_(True) for p in _param_args(params)]
    p = {"grid": {"fold": leaves[0],
                  "axes": [[leaves[3 + li * 3 + a]
                            for li in range(len(field.grid_levels))]
                           for a in range(3)]},
         "sigma_net": [{"w": leaves[1]}, {"w": leaves[2]}]}
    xr = x.detach().requires_grad_(True)
    out = fn(field, p, xr) if tangents else fn(field, p, xr, need_dx)
    loss = (out[0] * cots[0]).sum() + (out[1] * cots[1]).sum()
    if tangents:
        loss = loss + (torch.tanh(out[2] * nscale) * cots[2]).sum()
    grads = torch.autograd.grad(loss, leaves + [xr], allow_unused=True)
    grads = [torch.zeros_like(v) if gr is None else gr
             for v, gr in zip(leaves + [xr], grads)]
    return [o.detach() for o in out], grads


def phase_train_kernels(torch, card: str):
    """The training kernels vs their plain versions at the main path's
    shapes. Returns the JSON entries (fwd, bwd) without launch counts."""
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct

    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    seeded = field.init(torch.Generator().manual_seed(0), "cuda")
    saturating = dict(seeded)
    s2 = seeded["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 2000.0
    saturating["sigma_net"] = [seeded["sigma_net"][0], {"w": s2}]

    def plain_density(f, p, x, need_dx=True):
        return fct.density_reference(f, p, x if need_dx else x.detach())

    variants = {
        "tangents": (fct.density_with_grad_fused,
                     fct.density_with_grad_reference, True, True),
        "density": (fct.density_fused, plain_density, False, True),
        "density_no_dx": (fct.density_fused, plain_density, False, False)}
    # the JSON line's max_abs_err: plain max |kernel − plain| over outputs
    # (forward) and over every gradient leaf and d_x (backward)
    abs_fwd = abs_bwd = 0.0
    for pname, params, nscale in (("seeded", seeded, 1.0),
                                  ("saturating", saturating, 1 / 2000)):
        for t in (131072, 65536 + 37):
            x, cots = _train_case(torch, params, t, seed=t)
            out_frac = float((x.abs() > 6.0).any(-1).float().mean())
            for vname, (kern, plain, tangents, need_dx) in variants.items():
                got, g1 = _train_grads(torch, kern, field, params, x, cots,
                                       tangents, need_dx, nscale)
                _, g2 = _train_grads(torch, kern, field, params, x, cots,
                                     tangents, need_dx, nscale)
                ref, g0 = _train_grads(torch, plain, field, params, x, cots,
                                       tangents, need_dx, nscale)
                torch.cuda.synchronize()
                fwd = {k: float((a - b).abs().max())
                       / max(1.0, float(b.abs().max()))
                       for k, a, b in zip(("sigma", "geo", "grad"), got, ref)}
                bwd = [_rel(a, b) for a, b in zip(g0[:-1], g1[:-1])]
                dx = _rel(g0[-1], g1[-1]) if need_dx else float(
                    g1[-1].abs().max())
                spread = max(_rel(a, b) for a, b in zip(g1, g2))
                oob = (x.abs() > 6.0).any(-1)
                if tangents:  # no slope along an axis outside the bound
                    assert float(got[2][x.abs() > 6.0].abs().max()) == 0.0
                if need_dx:
                    assert float(g1[-1][(x.abs() > 6.0)].abs().max()) == 0.0
                tag = f"{pname} {vname} T={t}"
                log(f"[train-kernels] {tag} ({out_frac * 100:.2f} % out of "
                    f"bound, {int(oob.sum())} points): fwd err "
                    + ", ".join(f"{k} {v:.2e}" for k, v in fwd.items())
                    + f"; grad rel err max {max(bwd):.2e} (fold "
                    f"{bwd[0]:.2e}, s1 {bwd[1]:.2e}, s2 {bwd[2]:.2e}, "
                    f"tables {max(bwd[3:]):.2e}), d_x "
                    f"{'rel err' if need_dx else 'max (must be 0)'} "
                    f"{dx:.2e}; run-to-run spread {spread:.2e}")
                assert max(fwd.values()) <= TRAIN_FWD_ATOL, (tag, fwd)
                assert max(bwd) <= TRAIN_GRAD_RTOL, (tag, bwd)
                assert (dx <= TRAIN_GRAD_RTOL) if need_dx else dx == 0.0, tag
                abs_fwd = max([abs_fwd] + [float((a - b).abs().max())
                                           for a, b in zip(got, ref)])
                abs_bwd = max([abs_bwd] + [float((a - b).abs().max())
                                           for a, b in zip(g0, g1)])
                del got, g1, g2, ref, g0

    # times at the main path's shapes, seeded weights
    t = 131072
    x, cots = _train_case(torch, seeded, t, seed=1)
    times = {}
    for vname in ("tangents", "density"):
        kern, plain, tangents, _ = variants[vname]
        for label, fn in (("kernel", kern), ("plain", plain)):
            def fwd_only():
                with torch.no_grad():
                    return fn(field, seeded, x)

            def fwd_bwd():
                return _train_grads(torch, fn, field, seeded, x, cots,
                                    tangents)

            reps = 20 if label == "kernel" else 5
            times[(vname, label, "fwd")] = _time_ms(torch, fwd_only, reps, 2)
            times[(vname, label, "fwd+bwd")] = _time_ms(torch, fwd_bwd,
                                                        reps, 2)
        log(f"[train-kernels] {vname} T={t} ({card}): forward kernel "
            f"{times[(vname, 'kernel', 'fwd')]:.3f} ms, plain "
            f"{times[(vname, 'plain', 'fwd')]:.3f} ms; forward+backward "
            f"kernels {times[(vname, 'kernel', 'fwd+bwd')]:.3f} ms, plain "
            f"{times[(vname, 'plain', 'fwd+bwd')]:.3f} ms")
    k_bwd = (times[("tangents", "kernel", "fwd+bwd")]
             - times[("tangents", "kernel", "fwd")])
    p_bwd = (times[("tangents", "plain", "fwd+bwd")]
             - times[("tangents", "plain", "fwd")])
    src = "mirror_nerf_tpu_torch/csrc/fused_cp_train.cu"
    fwd_entry = {"name": "fused_cp_train_fwd", "route": "cuda",
                 "source": src,
                 "replaces": "mirror_nerf_tpu/ops/pallas/fused_cp_train.py:248",
                 "launches": 0, "max_abs_err": abs_fwd,
                 "ms": times[("tangents", "kernel", "fwd")],
                 "plain_ms": times[("tangents", "plain", "fwd")]}
    bwd_entry = {"name": "fused_cp_train_bwd", "route": "cuda",
                 "source": src,
                 "replaces": "mirror_nerf_tpu/ops/pallas/fused_cp_train.py:257",
                 "launches": 0, "max_abs_err": abs_bwd,
                 "ms": k_bwd, "plain_ms": p_bwd}
    return fwd_entry, bwd_entry


def phase_grad_guard(torch) -> None:
    """The forward-only composite kernel refuses parameters that require
    grad under grad mode (else its outputs carry no graph)."""
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import fused_cp

    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    params = field.init(torch.Generator().manual_seed(0), "cuda")
    params["grid"]["fold"].requires_grad_(True)
    n, s = 64, 64
    o = torch.zeros((n, 3), device="cuda")
    d = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda"),
                                      dim=-1)
    z = torch.linspace(0.1, 4.0, s, device="cuda").expand(n, s).contiguous()
    try:
        fused_cp.fused_cp_rays_composite(field, params, o, d, d, z)
    except ValueError as e:
        assert "fused_cp_train" in str(e), e
        log(f"[guard] composite kernel with a parameter requiring grad "
            f"raised: {e}")
    else:
        raise AssertionError("the composite kernel took a parameter that "
                             "requires grad")
    with torch.no_grad():
        fused_cp.fused_cp_rays_composite(field, params, o, d, d, z)


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


def phase_train_path(torch, card: str):
    """The port's train CLI at full width on a generated scene. Returns the
    training kernels' launch counts of that run."""
    import numpy as np

    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.train.checkpoints import tree_leaves
    from mirror_nerf_tpu_torch.train.cli import main as train_main

    work = WORK / "train"
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        generate_scene("scene", n_train=6, n_val=1, n_test=1,
                       img_wh=(64, 64))
        fct.launches_fwd = fct.launches_bwd = 0
        t0 = time.perf_counter()
        tr = train_main(TRAIN_FLAGS + ["--root_dir", "scene", "--img_wh",
                                       "64", "64", "--exp_name", "smoke"])
        wall = time.perf_counter() - t0
        launches = (fct.launches_fwd, fct.launches_bwd)
        assert min(launches) > 0, f"train kernels not launched: {launches}"
        recs = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "metrics.jsonl"))]
        vals = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "val_metrics.jsonl"))]
        assert {r["stage"] for r in recs} == {"geometry", "full"}, recs
        for r in recs + vals:
            for k, v in r.items():
                if isinstance(v, float):
                    assert np.isfinite(v), (k, r)
        assert "novel_ray_reg" in recs[-1] and "mirror_mask_loss" in recs[-1]
        for leaf in tree_leaves(tr.params):
            assert leaf.is_cuda
        for st in tr.opt.opt.state.values():
            for k, v in st.items():
                assert k == "step" or v.is_cuda, k
        log(f"[train] train CLI wrote {tr.workdir}: {len(recs)} log lines, "
            f"{tr.global_step} steps, {wall:.1f} s; train kernel launches "
            f"fwd {launches[0]}, bwd {launches[1]}")
        for v, stage in zip(vals, ("geometry", "reflection")):
            log(f"[train] epoch {v['epoch']} ({stage} stage): loss {v['loss']:.4f}, train psnr {v['psnr']:.2f}, val psnr "
                f"{v['val_psnr']:.2f}, {v['rays_per_sec']:.1f} rays/s at "
                f"batch 1024, steady state after the first step ({card})")
        out = eval_main(EVAL_FLAGS + [
            "--root_dir", "scene", "--img_wh", "64", "64", "--split", "test",
            "--ckpt_path", os.path.join(tr.workdir, "last.ckpt.npz"),
            "--exp_name", "smoke_trained"])
        with open(os.path.join(out, "psnr.json")) as f:
            table = json.load(f)
        assert np.isfinite(table["mean_psnr"]), table
        log(f"[train] last.ckpt.npz through the eval CLI: test PSNR "
            f"{table['mean_psnr']:.2f}")
        return launches, vals[-1]["rays_per_sec"]
    finally:
        os.chdir(cwd)


def phase_step_vs_cpu(torch) -> None:
    """One reflection-stage loss and backward, full width, 1024 rays: the
    card (kernels) against the CPU (plain versions) from the same
    parameters — seeded, with σ ≥ 0 and the mirror head on (`_all_mirror`;
    at the plain seeded init σ < 0 nearly everywhere, the weights are 0 and
    so is almost every gradient) — before any optimizer step. (After a step
    the two would not be comparable at adam_eps 1e-15: Adam's first step is
    ~lr·sign(g), ×20 on the grid tables, so a gradient entry at
    rounding-noise size whose sign differs between the atomics and the CPU
    sum moves a parameter by 2·lr·20 = 0.02 — a property of the optimizer,
    not of the kernels.)"""
    import numpy as np

    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train.checkpoints import _leaves, tree_leaves
    from mirror_nerf_tpu_torch.train.cli import get_opt
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    root = str(WORK / "train" / "scene")
    cfg, _ = get_opt(TRAIN_FLAGS + ["--root_dir", root, "--img_wh", "64",
                                    "64", "--perturb", "0", "--noise_std",
                                    "0", "--novel_ray_batch", "0"])
    cfg = cfg.replace(use_plane_consistent_loss=False)
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    ds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    sel = np.arange(0, len(rays), len(rays) // 1024)[:1024]  # all frames
    statics = EpochStatics.of(cfg, 1, False)
    seeded = Trainer(cfg, ds, str(WORK / "train" / "step_init"), "cpu")
    params = {k: _all_mirror(v) for k, v in seeded.params.items()}
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, ds, str(WORK / "train" / f"step_{dev}"), dev,
                     params=params)
        batch = {k: torch.from_numpy(v[sel]).to(dev)
                 for k, v in (("rays", rays), ("rgbs", rgbs),
                              ("mirror_mask", masks))}
        assert tr.settings(statics)[0].render.fused_density == (dev == "cuda")
        t0 = time.perf_counter()
        loss, _ = tr.loss_and_aux(statics, batch)
        loss.backward()
        losses[dev] = float(loss.detach())
        grads[dev] = [torch.zeros_like(x) if x.grad is None else x.grad
                      for x in tree_leaves(tr.params)]
        log(f"[step] {dev}: loss {losses[dev]:.6f}, loss + backward "
            f"{time.perf_counter() - t0:.2f} s")
    errs = [_rel(c, g.cpu()) if float(c.abs().max()) > 0
            else float(g.abs().max()) for g, c in zip(grads["cuda"],
                                                      grads["cpu"])]
    worst = max(range(len(errs)), key=errs.__getitem__)
    names = [p for p, _ in _leaves(tr.params)]
    live = [n for n, c in zip(names, grads["cpu"]) if float(c.abs().max()) > 0]
    for n in names:  # not vacuous: the fine field's encoder and σ-net learn
        if n.startswith(("fine/grid", "fine/sigma_net")):
            assert n in live, f"{n} has no gradient"
    rel_loss = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"[step] card vs CPU, 1024 rays, full width: loss rel err "
        f"{rel_loss:.2e}; gradient max|a−b|/max|a| over "
        f"{len(errs)} leaves ({len(live)} with a nonzero gradient): max "
        f"{max(errs):.2e} ({names[worst]}), median "
        f"{sorted(errs)[len(errs) // 2]:.2e}")
    assert rel_loss <= TRAIN_GRAD_RTOL, rel_loss
    assert max(errs) <= TRAIN_GRAD_RTOL, errs


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
    fwd_entry, bwd_entry = phase_train_kernels(torch, card)
    phase_grad_guard(torch)
    entry["launches"] = phase_main_path(torch, card)
    (fwd_entry["launches"], bwd_entry["launches"]), rate = \
        phase_train_path(torch, card)
    phase_step_vs_cpu(torch)
    log(f"[train] reflection-stage train-step rate at batch 1024: "
        f"{rate:.1f} rays/s ({card})")
    assert "jax" not in sys.modules and "mirror_nerf_tpu" not in sys.modules
    print(json.dumps({"kernels": [entry, fwd_entry, bwd_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
