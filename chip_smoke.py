#!/usr/bin/env python
"""GPU smoke test of the PyTorch + CUDA port (`mirror_nerf_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from `mirror_nerf_tpu_torch/
csrc/` at first use) and this checkout; it imports nothing of JAX. Phases,
each fatal on failure:

  1. environment: torch/CUDA versions, the card's name and power limit,
     whether nvcc and triton are present; TF32 off for the plain versions;
  2. build the seven kernel libraries at once (one nvcc each), print the
     build seconds and the compiler's register/spill report;
  3. the composite kernel vs its plain PyTorch version on the card, default
     CP field (levels 64:64,256:64,512:64, bound 6, seeded weights), 16384
     rays: S=128 full and S=64 σ-only, relu and softplus, seeded and a
     saturating field (σ ≳ 1e3); max abs error per output, per-ray Σw ≤
     1 + 1e-5, times beside the 3×TF32 bound (and the fp32 CUDA-core
     one, for comparison with the first design); the SASS of its
     ten instances (HMMA in each; FFMA, LDS, LDG, LDL, STL counted) and
     ptxas' registers and spills;
  4. the training kernels (3×TF32 `mma.sync`) vs their plain
     versions at the training path's shapes (T = 131072 and 65536 + 37,
     ~2 % of the points outside the bound; and a train batch's
     ray-ordered samples, 1024 rays × 128 fine and × 64 coarse; every
     sample compared, those with a hidden unit within 1e-6 of its sign
     change counted and their differences logged): forward with tangents
     and density-only; backward under random cotangents on σ, geo and
     tanh(∇σ), density-only with and without d_x, and a saturating σ
     field; the backward twice for the run-to-run spread of its atomics;
     σ and ∇σ against a float64 version, their signed mean error within
     1e-7 of scale; the SASS of its six instances (HMMA in each; FFMA,
     LDS, LDG, LDL, STL counted) and ptxas' registers and spills; kernel
     and plain times, forward and forward+backward, each launch alone on
     uniform and ray-ordered samples, beside the 3×TF32 bound and the
     first design's fp32 one;
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
     its last.ckpt.npz rendered through the eval CLI; then three traced
     reflection-stage steps (tools/profile_train_torch.py `step_profile`):
     the summed device time of a step, the train kernels' share of it, the
     idle share and the step rate;
  8. one reflection-stage loss and backward on the card against the plain
     version on the CPU, from the same parameters: the loss and every
     gradient leaf;
  9. the flagship PE-MLP kernel vs its plain PyTorch version on the card,
     default field (8×256, skip at 4, posenc 10/4, both heads; seeded
     weights with the σ column |w|·5, and a saturating field, ×2000),
     16384 strided rays of the 400×300 bench camera: S=128 full and S=64
     σ-only, relu and softplus; S=80 and 192 on 2048 + 37 rays, both
     variants; the instances for fields without the normal head, the
     mirror head or both and with 6/2 posenc frequencies, and a render of
     the head-less field with --fused_field (it must launch the kernel);
     max abs error per output (scaled above 1), per-ray Σw ≤ 1 + 1e-5,
     kernel and plain times beside the 3×TF32 bound (and the fp32
     CUDA-core one, the first design's); the SASS of its fifteen
     instances (HGMMA in each; FFMA, LDS, LDL, STL counted) and ptxas'
     registers and spills;
 10. the flagship eval path: the eval CLI (run.sh mode-1 nerf flags,
     --fused_field) on a generated 64×64 scene from an npz and from a
     reference-layout Lightning .ckpt of the same weights (equal PSNRs),
     then one 400×300 level-2 view (the livingroom preset's size) through
     run_view, seeded and all-mirror weights; the launch counter is reset
     before the CLI and read right after the timed views; the card against
     the plain version on the CPU on 256 rays;
 11. the per-sample kernels vs their plain versions: CP rows (16384 strided
     rays of the 800×800 camera, S=128 full and S=64 σ-only) and the CP
     composite from per-sample inputs (both variants, relu and softplus,
     Σw ≤ 1 + 1e-5), seeded and saturating;
     flagship rows (16384 rays of the 400×300 camera, the same S, plus
     S=80 and 192 on 2048 + 37 rays) and points (16384·128 and 100003);
     the flagship rows' raw σ against a float64 plain version, its mean
     signed error (the tensor cores' truncating sums) within 1e-7;
     a saturating field for each; errors scaled above 1, kernel and plain
     times beside the bound (the flagship's: 3×TF32 and fp32 CUDA-core, as
     in phase 9). The per-sample composite's and the points'
     launches are counted here (no render path runs them);
 12. the σ-noise path: one level-2 view per model through trace_rays in
     16384-ray chunks (CP 800×800, flagship 400×300; fused_field,
     noise_std 1, perturb 0, test_time, a seeded CUDA generator), launch
     counters reset before the view and read after (rows modes launched,
     composite kernels not), rays/s; on 1024 rays the fused route against
     the plain modules on the card from the same generator seed, and the
     flagship's fused_t=False route at noise 0 against its composite route;
 13. the fused NGP composite (`hash_field_kernel` of
     csrc/fused_cp_composite.cu, ops/fused_hash.py) vs its plain version:
     the hash-grid model at full width (bound 6, dense levels ×1e4, seeded
     and a saturating σ field), 16384 strided rays of the 800×800 camera,
     S=128 full and S=64 σ-only, relu and softplus
     (`tools/exp_hash_diag.py cases`); errors scaled above 1 against 1e-4,
     Σw ≤ 1 + 1e-5, kernel and plain times beside the 3×TF32 bound and the
     L2→SM sectors its gathers touch; the SASS of its four instances
     (HMMA in each; LDG, LDL, STL counted) and ptxas' registers and
     spills. Then the hash-grid kernel's three modes vs their plain
     versions: ENCODE at
     2,097,152 points of the full bound-6 spec (16 levels × 2, 6,616,280
     rows, ×1e4 table, ~2 % out of bound) and at the 800×800 view's sample
     positions (16384 strided rays × 128); GATHER at the probe's (64, 4096)
     on a 2¹⁹ × 2 table, fp32 and bf16, bit for bit; DENSE bit for bit on
     level 3 (side 62), on a level read from its second row (odd rows
     16-B aligned) at samples whose rows wrap, and on level 0 (4920 rows,
     side 17: not side³), with its L2 sector requests per sample before
     (the first design's eight 8-B loads) and now (16-B x-pairs); errors
     scaled above 1, kernel / plain / library times beside the bound. Then
     the probe's entry point (`python -m mirror_nerf_tpu_torch.
     tools.exp_hash_inkernel`, timing part) with the GATHER and DENSE
     counters reset before it and read after: their path; GATHER per call
     through the wrapper, through bare ctypes and as torch indexing, timed
     in turns;
 14. the hash-grid model's (`nerf_tcnn`) eval path: the eval CLI (run.sh
     mode-1 nerf_tcnn flags) on a generated 64×64 scene from an npz and
     from a MirrorNeRFTcnn-layout Lightning .ckpt of the same weights
     (equal PSNRs), then one 800×800 level-2 view through run_view, seeded
     and all-mirror weights; the ENCODE counter is reset before the CLI and
     read right after the timed views; the card against the plain version
     on the CPU on 256 rays. Then the eval CLI once more with --fused_field
     (PSNRs within 0.05 dB of the unfused run's) and the 800×800 view with
     and without --fused_field in turns on the same weights, seeded and
     all-mirror; the fused kernel's and ENCODE's counters are reset before
     the CLI and read around each fused run (the fused kernel launches,
     ENCODE does not); the fused route against the plain path on the CPU
     on 256 rays;
 15. the last three probes' kernels vs their plain versions: the launch
     floor (SMALL (8, 128), GRID (128, 1, 4096)) bit for bit, alone and as
     a chain looped in C; the segmented exclusive prefix, SCAN and TRI, at
     the composite's 2,097,152 values, S = 128, 64 and 16, uniform, δ_inf
     sentinel and wide-range (1e-6 … 1e10) input, against float64 (≤ 2e-6
     scaled above 1, each sentinel's own value equal to its segment's other
     values' sum), TRI's SASS holding HMMA in each of its eight instances,
     and WEIGHTS (S = 128) against its plain version (atol 1e-5, Σw ≤ 1 +
     1e-5); the table products at the JAX probe's defaults and at g 192,
     r 80, 640 lanes (a ragged row tile and lane tile, an int8 chunk of
     64), on the probe's input and the edge inputs (negative x, x that
     clips at ±127, bf16 rounding ties), int8 bit for bit and bf16 ≤ 1e-5
     scaled, `wgmma` in both instances' SASS (IGMMA, HGMMA), ptxas'
     registers and spills. Then each probe's entry point (`python -m
     mirror_nerf_tpu_torch.tools.exp_{invoke_floor,reshape_probe,
     int8_probe}`, timing part) with its counters reset before and read
     after: their path. It prints the floor table (mode × way, µs per rep),
     the wrapper's cost step by step, TRI's device time warm and cold beside
     torch.cumsum's, and SCAN per call through the wrapper, bare ctypes and
     torch.cumsum, timed in turns;
 16. the hash-grid encoder's backward, BWD and BWD2 (`csrc/hashgrid.cu`),
     against their plain versions at full width (bound 6, U(±1) table) on
     131,072 uniform points and a train batch's ray-ordered samples (1024
     rays × 128), edge points in front of each (0, 1, outside, grid
     nodes): table grads, d_dy, dx01 and d_x01 within 1e-5 of their
     largest entry (the atomics' order), the signed mean error against a
     float64 version, the table grads' run-to-run spread; kernel, plain
     and `index_add_` (the same pairs) times beside the bound, the
     reductions by level and the table grads' time over the dense and the
     hashed levels alone;
 17. training the hash-grid model (`nerf_tcnn`) and the flagship (`nerf`)
     through the train CLI (TRAIN_FLAGS with the model's own --decay_step
     2 4 8, no --grid_lr_mult) on phase 7's scene, two epochs: finite logs,
     both stages, parameters and Adam state on the card, TF32 off; for the
     hash grid ENCODE, BWD and BWD2 launched (counters reset before the CLI
     and read after) and the plain encoder never called; peak memory; the
     checkpoint through the eval CLI with --fused_field; a profiled
     reflection-stage step (`step_profile`: ms a step, rays/s, summed
     device time, idle share, BWD's and BWD2's shares);
 18. the eval CLI without --predict_normal (ROADMAP item [10], the tracer
     reflecting about ∇σ) for the CP grid (∇σ from the train kernel's
     forward) and the hash grid (ENCODE, then BWD for dx01): finite PSNRs
     and the launches;
 19. the four applications (run.sh modes 3, 4 with a D-NeRF and a nerf_pl
     guest, 5, 52, 6) on the CP grid at full width with --fused_field, from
     phase 7's last.ckpt.npz and scene, named livingroom for its presets
     (mode 6 substitutes the same checkpoint; the
     guests' files seeded at full width: D-NeRF 8×256, posenc 10/4, 64
     samples; nerf_pl the flagship without heads): the eval CLI for each
     mode on phase 7's scene, then one 800×800 view per mode through
     run_view (rays/s, the COMPOSITE launches and the deep trace's levels)
     and a 128×128 one without --predict_normal (the train forward's
     launches: ∇σ), the counters reset before each view and read after;
     then each mode on 256 rays on the card against the plain version on
     the CPU with the same injected roughness noise (RENDER_ATOL; mode 3
     held at 5 levels, at 50 its error logged and the levels reached
     equal: 50 bounces make its last colour ill-conditioned); then
     mode 3 for the flagship (a 400×300 view, its kernel) and the hash
     grid (--fused_field, the eval CLI at 64×64, the fused NGP composite).
     The applications' launches join the four kernels' counts in the
     kernels line. Check C1: mode 3 to level 50 on the same 256 rays on
     the card, on the CPU in fp32 and in float64, T and the rendered rgb
     level by level against float64's; check C2: the D-NeRF guest at scale
     8 (its near plane in front of the scene) drawn on some rays, card
     against CPU there;
 20. a real capture and the mesh (run.sh mode 2): an ARKit-layout capture
     at the lounge preset's geometry (480×360, near 0.05, far 8, bound 6)
     through the train CLI (real_arkit, run.sh mode 0's nerf_tpu flags,
     one geometry epoch), its checkpoint through the mesh CLI with mode 2's
     flags at --N_grid 256 in both color modes (the box ±0.15 around the
     room's wall a view's centre pixel outside the mirror sees, or, if
     the one-epoch field has no surface there, its densest point on that
     ray; --sigma_threshold 20, or the σ quantile that gives 1e5–5e6
     faces); the σ query's time, points/s and train forward launches, the
     host's marching tetrahedra, cluster and PLY times, the color passes'
     rays/s and COMPOSITE launches, vertex and face counts, peak host and
     device memory; the CP σ grid (32³), the hash grid's (ENCODE) and the
     flagship's (points mode) at 128³ from seeded weights, card against
     CPU within 1e-4 scaled above 1, and the vertex-normal colors of 256
     vertices within 1e-3; a COLMAP capture's view through the eval CLI.
     Its launches join rows 1, 2, 3, 6 and 9's (ENCODE) counts;
 21. the remaining options, on a generated 64×64 scene (3 train views) at
     config.py widths: RAdam and Ranger (--grid_lr_mult 20, coarse 1)
     updates 1–12 of the CP field on the card against the CPU from the
     same state and gradients, within 1e-6 of scale at updates 1, 5, 6 and
     12; the CP train CLI (run.sh mode 0's nerf_tpu flags) with
     --optimizer radam and with ranger --grid_lr_mult 1, two epochs each,
     then ranger resumed from its last.ckpt.npz for a third, the state on
     the card, and that checkpoint through the eval CLI; each field's bf16
     modules on the card against the CPU (4·2⁻⁷ of scale; RMS from fp32
     within 1.5× the CPU's); the train CLI with --compute_dtype bfloat16
     for the CP grid (its train kernels), the hash grid and the flagship,
     each with and without --fp32_sigma_grad, the bf16 CP and flagship
     checkpoints through the eval CLI (--fused_field: the kernels stay
     fp32); reflection-stage step profiles of the flagship and the hash
     grid in fp32, bf16 and bf16 with --fp32_sigma_grad in turns (ms a
     step, summed device time, GEMM share, idle share); LPIPS on seeded
     weights in both layouts, an 800×800 pair on the card against the CPU
     within 1e-5 and its ms, and the eval CLI in a subprocess with
     torch's default flags and $LPIPS_WEIGHTS (each score and mean_lpips
     within 1e-5 of the CPU's on the same images); sh_encode degree 8,
     get_encoder("hashgrid"/"tiledgrid") through ENCODE (its counter read
     around each, against the plain version), a 2-d hash grid raising;
     the native library built and its three bindings against numpy;
     utils/profiling.trace around a train step holding CUDA kernels. Its
     launches join rows 1, 2, 3, 4, 9 (ENCODE), 9c and 9d.

Each phase prints its wall time. The script prints one JSON line with the
twenty-one kernels' numbers (each with the least time the card could take for
the same work, `bound_ms`, counted from this run's shapes; the probe
kernels' also with their profiler `device_ms`, the CP composite's
modes, the train kernels and the flagship's three also with
`bound_fp32_ms`, and the segmented
prefix's with `cold_device_ms` after an L2 flush), the nvidia-smi name and
power limit, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import re
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
# run.sh mode 1 with MODEL_TYPE=nerf (livingroom preset's near/far/bound;
# --scale_factor only rescales real captures), plus --fused_field
NERF_EVAL_FLAGS = ["--dataset_name", "blender", "--near", "0.05", "--far",
                   "8", "--scale_factor", "6", "--model_type", "nerf",
                   "--predict_normal", "--predict_mirror_mask",
                   "--trace_secondary_rays", "--bound", "6",
                   "--N_importance", "64", "--chunk", "16384",
                   "--fused_field", "--max_recursive_level", "2"]
# run.sh mode 1 with MODEL_TYPE=nerf_tcnn (no --fused_field there)
NGP_EVAL_FLAGS = ["--dataset_name", "blender", "--near", "0.05", "--far",
                  "8", "--scale_factor", "1", "--model_type", "nerf_tcnn",
                  "--predict_normal", "--predict_mirror_mask",
                  "--trace_secondary_rays", "--bound", "6",
                  "--N_importance", "64", "--chunk", "16384",
                  "--max_recursive_level", "2"]
# run.sh modes 3-6 (the four applications): their flags after EVAL_FLAGS,
# whose --max_recursive_level 2 each replaces (50 for mode 3, the default 1
# for the others); GUESTS and CKPT are filled in by phase 19
APP_MODES = {
    "3": ["--max_recursive_level", "50", "--app_place_new_mirror",
          "--plane_pos", "plane_x"],
    "4_d_nerf": ["--max_recursive_level", "1",
                 "--app_reflect_newly_placed_objects", "--obj_ckpt_path",
                 "GUESTS/dnerf.tar"],
    "4_nerf_pl": ["--max_recursive_level", "1",
                  "--app_reflect_newly_placed_objects", "--obj_ckpt_path",
                  "GUESTS/nerf_pl.ckpt", "--obj_model_type", "nerf_pl"],
    "5": ["--max_recursive_level", "1", "--app_control_mirror_roughness",
          "--trace_ray_times", "64", "--normal_noise_std", "0.0025"],
    "52": ["--max_recursive_level", "1", "--app_control_mirror_roughness",
           "--trace_ray_times", "64", "--normal_noise_std", "0.01",
           "--normal_noise_std_changes"],
    "6": ["--max_recursive_level", "1", "--app_reflection_substitution",
          "--substitution_ckpt_path", "CKPT"],
}
# the view's progress in phase 19's 800×800 views: the guest's frame time
# and, for mode 52, half of its noise std
APP_PROGRESS = {"4_d_nerf": 0.5, "52": 0.25}
# the least time the card could take (`bound_ms`): operations over the fp32
# peak of the CUDA cores, bytes over the memory rate (NVIDIA H100 SXM data
# sheet, dense, at 700 W). Operations count multiply-adds as 2 and leave out
# transcendentals and compares; bytes count each input read once and each
# output written once.
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # bytes/s
# the TF32 tensor-core peak, dense: fp32-accurate products on the tensor
# cores take three TF32 products each (3×TF32), so the CP composite's and
# the flagship's bounds count their products 3× over this peak
# (`_cp_bound`, `_mlp_bound`)
PEAK_TF32 = 495e12  # FLOP/s


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
    from mirror_nerf_tpu_torch.ops import (_build, fused_cp, fused_cp_train,
                                           fused_hash, fused_mlp_t, hashgrid,
                                           invoke_floor, segment_scan,
                                           table_mma)

    mods = (fused_cp, fused_cp_train, fused_mlp_t, hashgrid, invoke_floor,
            segment_scan, table_mma)
    names = [m._LIB for m in mods]
    t0 = time.perf_counter()
    _build.build_libraries(names)
    for m in mods:
        m._library()
    fused_hash._library()  # the fused NGP composite's entry, same library
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} "
        "s wall")
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


def _bound(flop: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the fp32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flop / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _cp_flop(sum_r: int, full: bool) -> tuple:
    """Operations per sample of the CP composite kernel, (products, the
    rest): the products are the fold of the rank products into 32 features
    (32 multiply-adds a rank), the σ-net 32→64→16 and, in the full variant,
    color 31→64→64→3, normal 15→64→3 and mirror 15→32→1; the rest is per
    rank three lerps (3 each) and the three-axis product (2)."""
    mm = sum_r * 2 * 32 + 2 * (32 * 64 + 64 * 16)
    if full:
        mm += 2 * (31 * 64 + 64 * 64 + 64 * 3 + 15 * 64 + 64 * 3 + 15 * 32
                   + 32)
    return mm, sum_r * (9 + 2)


def _cp_bound(samples: int, sum_r: int, full: bool, nbytes: float):
    """(bound_ms, bound_by, bound_fp32_ms) of the CP composite: its
    products at fp32 accuracy are fastest as 3×TF32 on the tensor cores,
    its lerps on the CUDA cores beside them, so the bound is the largest of
    3 × the products over the TF32 peak, the rest over the fp32 peak and
    the bytes over the memory rate. bound_fp32_ms puts every operation on
    the fp32 CUDA cores, the bound of the kernel's first design."""
    mm, rest = (samples * f for f in _cp_flop(sum_r, full))
    t_ops = max(3 * mm / PEAK_TF32, rest / PEAK_FP32) * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", _bound(mm + rest, nbytes)[0])


def _mlp_bound(samples: int, sigma_only: bool, nbytes: float):
    """(bound_ms, bound_by, bound_fp32_ms) of the flagship PE-MLP kernel:
    its products (`MLP_MACS`, every multiply-add of the trunk and the
    heads) at fp32 accuracy are fastest as 3×TF32 on the tensor cores, so
    the bound is the larger of 3 × the products over the TF32 peak and the
    bytes over the memory rate. bound_fp32_ms puts them on the fp32 CUDA
    cores, the bound of the kernel's first design."""
    flop = 2 * samples * MLP_MACS[sigma_only]
    t_ops = 3 * flop / PEAK_TF32 * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", _bound(flop, nbytes)[0])


def _cp_train_flop(sum_r: int) -> tuple:
    """Operations per sample of the CP train kernels' first design,
    tangent variant, all on the fp32 CUDA cores: forward = the fold of e
    and of the three tangent streams (4 × 32 multiply-adds a rank), lerps,
    slopes and products (26 a rank), the σ-net and its three tangent
    products 32→64 plus ∇σ; backward = that forward (recomputed: the
    function takes no stash) plus its own products (d_s1, d_s2, z̄1, ē, v,
    s1ᵀu: 12352 multiply-adds; u, pb, qv and the two d_fold outer
    products: 5 × 32 a rank; 30 scalar ops a rank)."""
    fwd = (sum_r * (4 * 2 * 32 + 26) + 2 * (32 * 64 + 64 * 16)
           + 2 * (3 * 32 * 64 + 3 * 64))
    bwd = fwd + 2 * (12352 + 5 * 32 * sum_r) + 30 * sum_r
    return fwd, bwd


def _cp_train_tc_flop(sum_r: int) -> tuple:
    """Operations per sample that the CP train functions need, tangent
    variants, split as the tensor-core route runs them: ((forward
    products, forward scalar work), (backward products, backward scalar
    work)), a multiply-add 2. Forward products: the fold of P (32 a rank),
    z1 = e·s1 (32 × 64), h·s2 (64 × 16), v = s1·m (32 × 64) and
    qv = fold·v (32 a rank), since ∇σ_a = TP_a·qv; scalar: per rank the
    three lerps and slopes (12), P and the three pair products (4), qv·g_a
    (3) and the three ∇σ multiply-adds (6), per sample m = [z1 > 0]·s2[:, 0]
    (64). (The kernel folds all four streams, P, TP0, TP1, TP2, and takes
    the three tangent streams through s1: about twice these products.)
    Backward products: the fold of P and TPN, pb = fold ē and qv = fold v,
    d_fold (6 × 32 a rank), z1, zu, ē, v, d_s1 (6 × 32 × 64), s2 sḡ and
    d_s2 (2 × 64 × 16) and Σ tn (64); scalar per rank: the recompute's
    lerps, slopes, P and TPN (25) and the second pass's lerps and slopes,
    the product rule, the table rows' weights, d_x, P and TPN (79)."""
    fwd = (2 * (2 * 32 * sum_r + 2 * 32 * 64 + 64 * 16),
           25 * sum_r + 64)
    bwd = (2 * (6 * 32 * sum_r + 6 * 32 * 64 + 2 * 64 * 16 + 64),
           104 * sum_r)
    return fwd, bwd


def _train_bound(samples: int, flop: tuple, nbytes: float) -> tuple:
    """(bound_ms, bound_by) of a CP train function on the tensor-core
    route: the largest of 3 × its products over the TF32 peak, its scalar
    work over the fp32 peak (the two pipes run side by side) and its bytes
    over the memory rate."""
    mm, rest = (samples * f for f in flop)
    t_ops = max(3 * mm / PEAK_TF32, rest / PEAK_FP32) * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# multiply-adds per sample of the flagship: trunk 63·256 + 6·256² + 319·256
# and σ 256 (σ-only); + xyz_final 256², dir_enc 283·128, rgb 128·3, normal
# 256·128 + 128·3, mirror 256·128 + 128 (full)
MLP_MACS = {True: 491_264, False: 659_456}


def _view_rays(w: int, h: int = None):
    """The bench camera (first pose of the procedural ring, 0.9 rad fov
    across the width), w×h rays."""
    import numpy as np

    from mirror_nerf_tpu_torch.core.rays import (get_ray_directions,
                                                 get_rays, make_ray_buffer)
    from mirror_nerf_tpu_torch.data.synthetic import camera_ring

    h = h or w
    focal = 0.5 * w / np.tan(0.5 * 0.9)
    o, d = get_rays(get_ray_directions(h, w, focal), camera_ring(1)[0])
    return make_ray_buffer(o, d, 0.05, 8.0)


def phase_kernel(torch, card: str) -> dict:
    """Kernel vs plain at the main path's shapes. Returns the JSON entry."""
    from mirror_nerf_tpu_torch.core.sampling import (merge_fine_z_vals,
                                                     stratified_z_vals)
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import _build, fused_cp

    # the machine code: every instance on the tensor cores; registers and
    # spills from ptxas
    sass = _build.sass_counts(_build.library_path(fused_cp._LIB),
                              "cp_field_kernel")
    assert len(sass) == 10 and min(c["HMMA"] for c in sass.values()) > 0, \
        sass
    for name, c in sorted(sass.items()):
        inst = re.search(r"cp_field_kernelILi(\d)ELb(\d)ELb(\d)E", name)
        log(f"[kernel] SASS of cp_field_kernel<mode {inst.group(1)}, "
            f"sigma_only {inst.group(2)}, softplus {inst.group(3)}>: "
            + ", ".join(f"{k} {v}" for k, v in c.items()))
    for line in _build.build_log.get(fused_cp._LIB, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[kernel] ptxas: {line.strip()}")

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
    sum_r = sum(r for _, r in field.grid_levels)

    worst = 0.0
    entry_ms = entry_plain = None
    for pname, params in (("seeded", seeded), ("saturating", saturating)):
        tables, _ = fused_cp._pack_tables(params, field.grid_levels)
        nets = fused_cp._pack_nets(params, field.grid_levels)
        for act in ("relu", "softplus"):
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
                if pname != "seeded" or act != "relu":
                    continue
                b_ms, b_by, fp32_ms = _cp_bound(
                    n * z.shape[1], sum_r, not sigma_only,
                    _nbytes(o, d, d, z, tables, nets, *got.values()))
                log(f"[kernel] bound at {tag}: {b_ms:.3f} ms ({b_by}; 3×TF32 "
                    "products on the tensor cores): the kernel reaches "
                    f"{b_ms / ms * 100:.1f} %; fp32 CUDA-core bound "
                    f"{fp32_ms:.3f} ms: {fp32_ms / ms * 100:.1f} %")
                if not sigma_only:
                    entry_ms, entry_plain = ms, plain_ms
                    bound_ms, bound_by, bound_fp32 = b_ms, b_by, fp32_ms
    return {"name": "fused_cp_composite", "route": "cuda",
            "source": "mirror_nerf_tpu_torch/csrc/fused_cp_composite.cu",
            "replaces": "mirror_nerf_tpu/ops/pallas/fused_cp.py:363",
            "launches": 0, "max_abs_err": worst, "ms": entry_ms,
            "plain_ms": entry_plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "bound_fp32_ms": bound_fp32}


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


def _train_check(torch, fct, field, params, x, cots, nscale, tag,
                 variants) -> tuple:
    """Each variant's kernels against the plain versions on (x, cots),
    every sample: forward outputs ≤ TRAIN_FWD_ATOL scaled above 1, every
    gradient leaf and d_x ≤ TRAIN_GRAD_RTOL relative, d_x and ∇σ exactly 0
    outside the bound, d_x exactly 0 without need_dx. Logs, apart, the
    largest differences at the samples with a hidden unit within 1e-6 of
    its sign change (`exp_train_diag.stable_samples`), where ∇σ jumps.
    Returns the largest absolute forward and backward differences."""
    from mirror_nerf_tpu_torch.tools.exp_train_diag import stable_samples

    near = ~stable_samples(field, params, x)
    n_near = int(near.sum())
    abs_fwd = abs_bwd = 0.0
    out_frac = float((x.abs() > 6.0).any(-1).float().mean())
    for vname, (kern, plain, tangents, need_dx) in variants.items():
        got, g1 = _train_grads(torch, kern, field, params, x, cots,
                               tangents, need_dx, nscale)
        _, g2 = _train_grads(torch, kern, field, params, x, cots, tangents,
                             need_dx, nscale)
        ref, g0 = _train_grads(torch, plain, field, params, x, cots,
                               tangents, need_dx, nscale)
        torch.cuda.synchronize()
        fwd = {k: float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for k, a, b in zip(("sigma", "geo", "grad"), got, ref)}
        bwd = [_rel(a, b) for a, b in zip(g0[:-1], g1[:-1])]
        dx = _rel(g0[-1], g1[-1]) if need_dx else float(g1[-1].abs().max())
        if n_near:
            at_near = ", ".join(
                f"{k} {float((a[near] - b[near]).abs().max()):.2e}"
                for k, a, b in zip(("sigma", "geo", "grad", "d_x"),
                                   list(got) + [g1[-1]],
                                   list(ref) + [g0[-1]]))
        spread = max(_rel(a, b) for a, b in zip(g1, g2))
        oob = (x.abs() > 6.0).any(-1)
        if tangents and bool((x.abs() > 6.0).any()):
            # no slope along an axis outside the bound
            assert float(got[2][x.abs() > 6.0].abs().max()) == 0.0
        if need_dx and bool((x.abs() > 6.0).any()):
            assert float(g1[-1][(x.abs() > 6.0)].abs().max()) == 0.0
        full = f"{tag} {vname}"
        log(f"[train-kernels] {full} ({out_frac * 100:.2f} % out of "
            f"bound, {int(oob.sum())} points): fwd err "
            + ", ".join(f"{k} {v:.2e}" for k, v in fwd.items())
            + f"; grad rel err max {max(bwd):.2e} (fold "
            f"{bwd[0]:.2e}, s1 {bwd[1]:.2e}, s2 {bwd[2]:.2e}, "
            f"tables {max(bwd[3:]):.2e}), d_x "
            f"{'rel err' if need_dx else 'max (must be 0)'} "
            f"{dx:.2e}; run-to-run spread {spread:.2e}; {n_near} samples "
            "with a hidden unit within 1e-6 of its sign change"
            + (f" (largest differences there: {at_near})" if n_near else ""))
        assert max(fwd.values()) <= TRAIN_FWD_ATOL, (full, fwd)
        assert max(bwd) <= TRAIN_GRAD_RTOL, (full, bwd)
        assert (dx <= TRAIN_GRAD_RTOL) if need_dx else dx == 0.0, full
        abs_fwd = max([abs_fwd] + [float((a - b).abs().max())
                                   for a, b in zip(got, ref)])
        abs_bwd = max([abs_bwd] + [float((a - b).abs().max())
                                   for a, b in zip(g0, g1)])
        del got, g1, g2, ref, g0
    return abs_fwd, abs_bwd


def phase_train_kernels(torch, card: str):
    """The training kernels vs their plain versions at the main path's
    shapes. Returns the JSON entries (fwd, bwd) without launch counts."""
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import _build
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.tools import exp_train_diag as etd

    # the machine code: all six instances on the tensor cores; registers
    # and spills from ptxas
    sass = _build.sass_counts(_build.library_path(fct._LIB), "_kernel")
    assert len(sass) == 6 and min(c["HMMA"] for c in sass.values()) > 0, \
        sass
    for name, c in sorted(sass.items()):
        inst = re.search(r"(fwd|bwd)_kernelILb(\d)E(?:Lb(\d)E)?", name)
        log(f"[train-kernels] SASS of {inst.group(1)}_kernel<tangents "
            f"{inst.group(2)}"
            + (f", need_dx {inst.group(3)}" if inst.group(3) else "")
            + ">: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    for name, line in _build.ptxas_by_function(
            _build.build_log.get(fct._LIB, ""), "_kernel").items():
        inst = re.search(r"(fwd|bwd)_kernelIL[^E]*E(?:Lb\d+E)?", name)
        log(f"[train-kernels] ptxas {inst.group(0) if inst else name}: "
            f"{line}")

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
            af, ab = _train_check(torch, fct, field, params, x, cots, nscale,
                                  f"{pname} T={t}", variants)
            abs_fwd, abs_bwd = max(abs_fwd, af), max(abs_bwd, ab)
        # a train batch's samples as the renderer hands them over: 1024
        # rays of the train camera, a ray's fine (128) or coarse (64)
        # samples consecutive; every sample compared, as at uniform points
        coarse, fine = etd.ray_samples(field, params)
        for tag, x in (("rays 1024x128", fine), ("rays 1024x64", coarse)):
            g = torch.Generator(device="cuda").manual_seed(x.shape[0])
            cots = [torch.randn(sh, generator=g, device="cuda")
                    for sh in ((x.shape[0],), (x.shape[0], 15),
                               (x.shape[0], 3))]
            af, ab = _train_check(torch, fct, field, params, x, cots, nscale,
                                  f"{pname} {tag}", variants)
            abs_fwd, abs_bwd = max(abs_fwd, af), max(abs_bwd, ab)
        # the tensor cores' sums truncate toward zero: σ and ∇σ against a
        # float64 version, their signed mean error within 1e-7 of scale
        # (phase 11's bar for the flagship's raw σ)
        for tag, x in (("uniform T=131072", _train_case(torch, params,
                                                        131072, 1)[0]),
                       ("rays 1024x128", fine)):
            with torch.no_grad():
                got = fct.density_with_grad_fused(field, params, x)
            bias = etd.signed_mean_errors(field, params, x, got)
            log(f"[train-kernels] {pname} {tag}: signed mean error against "
                "float64 (over max(1, max|·|)): "
                + ", ".join(f"{k} {v:+.3e}" for k, v in bias.items()))
            assert max(abs(v) for v in bias.values()) <= 1e-7, (tag, bias)

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
    # each launch alone through the wrapper, uniform and ray-ordered (the
    # tangent forward; the tangent backward with d_x)
    p5 = etd.field_and_params()[1]
    for case, (xc, cc) in etd.cases(field, p5).items():
        fwd, bwd = etd._calls(fct, field, p5, xc, cc)
        log(f"[train-kernels] {case} T={xc.shape[0]} ({card}), σ column "
            f"|w|·5: forward {_time_ms(torch, fwd, 20, 2):.4f} ms, backward "
            f"{_time_ms(torch, bwd, 20, 2):.4f} ms a launch")

    sum_r = sum(r for _, r in field.grid_levels)
    flop_f, flop_b = _cp_train_flop(sum_r)
    tc_f, tc_b = _cp_train_tc_flop(sum_r)
    p_bytes = _nbytes(*fct._param_args(seeded))
    bytes_f = _nbytes(x) + p_bytes + t * (1 + 15 + 3) * 4
    # in: x, the cotangents, the params; out: their grads and d_x
    bytes_b = 2 * _nbytes(x) + _nbytes(*cots) + 2 * p_bytes
    b_fwd, b_bwd = _train_bound(t, tc_f, bytes_f), _train_bound(t, tc_b,
                                                                bytes_b)
    f32_fwd, f32_bwd = _bound(t * flop_f, bytes_f), _bound(t * flop_b,
                                                           bytes_b)
    log(f"[train-kernels] bounds at T={t}: 3×TF32 forward {b_fwd[0]:.4f} "
        f"ms, backward {b_bwd[0]:.4f} ms ({b_fwd[1]}, {b_bwd[1]}); the first "
        f"design's fp32 CUDA-core bounds {f32_fwd[0]:.4f}, "
        f"{f32_bwd[0]:.4f} ms")
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
                 "plain_ms": times[("tangents", "plain", "fwd")],
                 "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                 "library_ms": None, "bound_fp32_ms": f32_fwd[0]}
    bwd_entry = {"name": "fused_cp_train_bwd", "route": "cuda",
                 "source": src,
                 "replaces": "mirror_nerf_tpu/ops/pallas/fused_cp_train.py:257",
                 "launches": 0, "max_abs_err": abs_bwd,
                 "ms": k_bwd, "plain_ms": p_bwd, "bound_ms": b_bwd[0],
                 "bound_by": b_bwd[1], "library_ms": None,
                 "bound_fp32_ms": f32_bwd[0]}
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


def _check_against_plain(torch, ctx, rays_np, n: int = 1024):
    """The main path on the card vs the plain version on the CPU, n rays."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import eval_trace
    from mirror_nerf_tpu_torch.render.renderer import render_rays
    from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                         params_to_numpy)

    cpu_params = params_from_numpy(params_to_numpy(ctx.params))
    sub = rays_np[::len(rays_np) // n][:n]
    with torch.no_grad():
        g = render_rays(ctx.field, ctx.params,
                        torch.from_numpy(sub).cuda(), ctx.rs)
        c = render_rays(ctx.field, cpu_params, torch.from_numpy(sub), ctx.rs)
        errs = {k: float((g[k].cpu() - c[k]).abs().max())
                for k in ("rgb_fine", "depth_fine", "opacity_fine",
                          "mirror_mask_fine", "surface_normal_fine")}
        log(f"[main] render_rays card vs plain CPU, {n} rays, all-mirror "
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


def _sigma_scaled(params: dict, scale: float) -> dict:
    """The flagship's weights with the σ column made positive and scaled."""
    out = dict(params)
    out["sigma"] = {"w": params["sigma"]["w"].abs() * scale,
                    "b": params["sigma"]["b"]}
    return out


def _all_mirror(params: dict) -> dict:
    """Seeded weights with σ ≥ 0 everywhere (the σ column |w|·5) and the
    mirror head biased on (+5): every ray is an opaque mirror at every
    level, the heaviest trace. CP-grid, flagship or hash-grid parameters
    (the hash grid also needs `_dense_scaled` for σ to be more than ~0)."""
    if "sigma" in params:
        out = _sigma_scaled(params, 5.0)
    else:
        out = dict(params)
        s2 = params["sigma_net"][1]["w"].clone()
        s2[:, 0] = s2[:, 0].abs() * 5.0
        out["sigma_net"] = [params["sigma_net"][0], {"w": s2}]
    m2 = dict(params["is_mirror"][1])
    m2["b"] = m2["b"] + 5.0
    out["is_mirror"] = [params["is_mirror"][0], m2]
    return out


def _time_view(ctx, rays_np):
    """Time one view through run_view (after one warm view). Returns the
    last result and the walls in seconds."""
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
                 card: str, size: str = "800x800") -> None:
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
    log(f"[main] {size} level-2 view, {label}: {min(times):.3f} s best of "
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
        # where the reflection-stage step's time goes: three traced steps
        # of the trained model (tools/profile_train_torch.py)
        sys.path.insert(0, str(ROOT / "tools"))
        from profile_train_torch import step_profile

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        r = step_profile(tr, tr.cfg, "cuda", acts)
        log(f"[train] reflection-stage step, batch {r['batch']} ({card}): "
            f"{r['ms_per_step']:.2f} ms/step, {r['rays_per_s']:.1f} rays/s "
            f"(host clock, synchronized); traced: summed device time "
            f"{r['device_ms_per_step']:.3f} ms a step, the train kernels "
            f"{100 * r['train_kernel_share']:.1f} % of it, idle share "
            f"{r['idle_share']:.4f}, {r['events_per_step']:.0f} device "
            f"events a step, train kernel launches fwd {r['launches'][0]}, "
            f"bwd {r['launches'][1]} in 3 steps")
        for name, (cnt, ms) in sorted(r["by_name"].items(),
                                      key=lambda kv: -kv[1][1])[:6]:
            log(f"[train]   {ms / 3:8.3f} ms a step x{cnt // 3:4d}  {name}")
        assert r["events_per_step"] > 0 and r["train_kernel_share"] > 0, r
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


def _mlp_case(torch, fm, field, params, o, d, z, sigma_only, act, tag,
              card, time_it=True):
    """One flagship kernel case against its plain version: errors (scaled
    above 1), Σw, and optionally the two times. Returns (worst error,
    kernel ms, plain ms, the kernel's outputs)."""
    def kern():
        return fm.fused_t_rays_composite(field, params, o, d, d, z,
                                         sigma_only=sigma_only,
                                         sigma_act=act)

    def plain():
        return fm.mlp_rays_composite_reference(field, params, o, d, d, z,
                                               sigma_only=sigma_only,
                                               sigma_act=act)

    with torch.no_grad():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        errs = {k: float((got[k] - ref[k]).abs().max())
                / max(1.0, float(ref[k].abs().max())) for k in ref}
        wsum = float(got["weights"].sum(-1).max())
        for k, v in got.items():
            assert v.is_cuda and bool(torch.isfinite(v).all()), k
        ms = _time_ms(torch, kern, reps=5, warmup=1) if time_it else None
        plain_ms = _time_ms(torch, plain, reps=3, warmup=1) if time_it \
            else None
    n, s = z.shape
    times = (f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
             if time_it else "")
    log(f"[mlp-kernel] {tag}: {times}{n} rays × S={s} ({card}); max w "
        f"{float(got['weights'].max()):.4f}, max Σw {wsum:.6f}; max abs err "
        "(scaled above 1) " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in errs.items()))
    assert max(errs.values()) <= KERNEL_ATOL, (tag, errs)
    assert wsum <= 1.0 + 1e-5, (tag, wsum)
    return max(errs.values()), ms, plain_ms, got


def phase_mlp_kernel(torch, card: str) -> dict:
    """The flagship kernel vs its plain version at the main path's shapes.
    Returns the JSON entry without the launch count."""
    from mirror_nerf_tpu_torch.core.sampling import (merge_fine_z_vals,
                                                     stratified_z_vals)
    from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
    from mirror_nerf_tpu_torch.ops import _build
    from mirror_nerf_tpu_torch.ops import fused_mlp_t as fm

    # the machine code: every instance on wgmma; registers and spills from
    # ptxas
    sass = _build.sass_counts(_build.library_path(fm._LIB),
                              "mlp_field_kernel",
                              opcodes=("HGMMA", "FFMA", "LDS", "LDL", "STL"))
    assert len(sass) == 15 and min(c["HGMMA"] for c in sass.values()) > 0, \
        sass
    for name, c in sorted(sass.items()):
        inst = re.search(r"mlp_field_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb"
                         r"(\d)E", name)
        log("[mlp-kernel] SASS of mlp_field_kernel<rows {}, sigma_only {}, "
            "softplus {}, normal {}, mirror {}>: ".format(*inst.groups())
            + ", ".join(f"{k} {v}" for k, v in c.items()))
    for line in _build.build_log.get(fm._LIB, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[mlp-kernel] ptxas: {line.strip()}")

    dev = torch.device("cuda")
    field = MirrorNeRFField()
    base = field.init(torch.Generator().manual_seed(0), dev)
    seeded = _sigma_scaled(base, 5.0)
    saturating = _sigma_scaled(base, 2000.0)

    rays_np = _view_rays(400, 300)
    n = 16384
    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).to(dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    z64 = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 64).contiguous()
    worst, entry = 0.0, None
    for pname, params in (("seeded", seeded), ("saturating", saturating)):
        for act in (("relu", "softplus") if pname == "seeded" else ("relu",)):
            with torch.no_grad():
                coarse = fm.mlp_rays_composite_reference(
                    field, params, o, d, d, z64, sigma_only=True,
                    sigma_act=act)
            z128 = merge_fine_z_vals(z64, coarse["weights"], 64,
                                     0.0).contiguous()
            for sigma_only, z in ((False, z128), (True, z64)):
                tag = (f"{pname} {act} S={z.shape[1]} "
                       f"{'sigma-only' if sigma_only else 'full'}")
                err, ms, plain_ms, got = _mlp_case(
                    torch, fm, field, params, o, d, z, sigma_only, act, tag,
                    card)
                worst = max(worst, err)
                s = z.shape[1]
                bound_ms, bound_by, bound_fp32 = _mlp_bound(
                    n * s, sigma_only,
                    _nbytes(o, d, None if sigma_only else d, z,
                            fm._pack(params), *got.values()))
                log(f"[mlp-kernel] {tag}: 3×TF32 bound {bound_ms:.3f} ms "
                    f"({bound_by}); kernel at {bound_ms / ms * 100:.1f} % "
                    f"of it, {2 * n * s * MLP_MACS[sigma_only] / ms / 1e9:.2f}"
                    f" TFLOP/s of fp32-accurate products; fp32 CUDA-core "
                    f"bound {bound_fp32:.3f} ms, kernel at "
                    f"{bound_fp32 / ms * 100:.1f} %; plain at "
                    f"{bound_ms / plain_ms * 100:.1f} % of the 3×TF32 bound")
                if (pname, act, sigma_only) == ("seeded", "relu", False):
                    entry = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "bound_fp32_ms": bound_fp32}
                    log(f"[mlp-kernel] {tag}: packed weights "
                        f"{_nbytes(fm._pack(params)) / 1e6:.2f} MB (TF32 "
                        "hi and lo planes and the fp32 leaves)")
    # S that do not tile the 256-sample block, on a ragged ray count
    n2 = 2048 + 37
    sub = rays[:n2]
    for s in (80, 192):
        z = stratified_z_vals(sub[:, 6:7], sub[:, 7:8], s).contiguous()
        for sigma_only in (False, True):
            err, *_ = _mlp_case(
                torch, fm, field, seeded, o[:n2].contiguous(),
                d[:n2].contiguous(), z, sigma_only, "relu",
                f"seeded relu S={s} {'sigma-only' if sigma_only else 'full'}",
                card, time_it=False)
            worst = max(worst, err)
    worst = max(worst, _mlp_variants(torch, fm, rays, card))
    return {"name": "fused_mlp_t", "route": "cuda",
            "source": "mirror_nerf_tpu_torch/csrc/fused_mlp_t.cu",
            "replaces": "mirror_nerf_tpu/ops/pallas/fused_mlp_t.py:276",
            "launches": 0, "max_abs_err": worst, **entry,
            "library_ms": None}


def _mlp_variants(torch, fm, rays, card: str) -> float:
    """The kernel's other instances — a field without the normal head,
    without the mirror head, without both, and with 6/2 posenc frequencies
    — against the plain version, timed at the microbench's shapes; and a
    render of the head-less field with fused_field on, which must launch
    the kernel and match the plain modules. Returns the worst error."""
    from mirror_nerf_tpu_torch.core.sampling import stratified_z_vals
    from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
    from mirror_nerf_tpu_torch.render.renderer import (RenderSettings,
                                                       render_rays)

    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    worst = 0.0
    for name, kw in (("no normal", dict(predict_normal=False)),
                     ("no mirror", dict(predict_mirror_mask=False)),
                     ("no heads", dict(predict_normal=False,
                                       predict_mirror_mask=False)),
                     ("posenc 6/2", dict(N_emb_xyz=6, N_emb_dir=2))):
        field = MirrorNeRFField(**kw)
        params = _sigma_scaled(field.init(torch.Generator().manual_seed(2),
                                          rays.device), 5.0)
        for s, sigma_only in ((128, False), (64, True)):
            if sigma_only and "posenc" not in name:
                continue  # the σ-only instance reads no head
            z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], s).contiguous()
            err, *_ = _mlp_case(
                torch, fm, field, params, o, d, z, sigma_only, "relu",
                f"{name} S={s} {'sigma-only' if sigma_only else 'full'}",
                card)
            worst = max(worst, err)
    field = MirrorNeRFField(predict_normal=False, predict_mirror_mask=False)
    params = {side: _sigma_scaled(field.init(
        torch.Generator().manual_seed(seed), rays.device), 5.0)
        for seed, side in enumerate(("coarse", "fine"))}
    out = {}
    for fused in (True, False):
        rs = RenderSettings(N_samples=64, N_importance=64, perturb=0.0,
                            noise_std=0.0, test_time=True,
                            compute_normal=False, fused_field=fused)
        before = fm.launches
        with torch.no_grad():
            out[fused] = render_rays(field, params, rays[:256], rs)
        assert (fm.launches > before) == fused, "fused_field routing"
    errs = {k: float((out[True][k] - v).abs().max())
            / max(1.0, float(v.abs().max())) for k, v in out[False].items()
            if k in out[True] and k.endswith(("_coarse", "_fine"))}
    log(f"[mlp-kernel] no-heads field, render_rays with fused_field on vs "
        f"off, 256 rays: the kernel launched; max abs err (scaled above 1) "
        f"{max(errs.values()):.3e} over {len(errs)} outputs")
    assert max(errs.values()) <= RENDER_ATOL, errs
    return worst


def phase_mlp_main_path(torch, card: str) -> int:
    """The flagship's eval path on the card. Returns its kernel launches."""
    import numpy as np

    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import get_opt, main
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import fused_mlp_t
    from mirror_nerf_tpu_torch.train.checkpoints import (save_pytree,
                                                         save_torch_ckpt)

    work = WORK / "mlp"
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        generate_scene("scene", n_train=1, n_val=1, n_test=2,
                       img_wh=(64, 64))
        cfg, _ = get_opt(NERF_EVAL_FLAGS)
        field = make_field(cfg)
        weights = {k: _sigma_scaled(v, 5.0) for k, v in
                   init_params(field, cfg, "cpu").items()}
        save_pytree("w.npz", weights)
        save_torch_ckpt("w.ckpt", weights)
        fused_mlp_t.launches = 0
        psnrs = {}
        for tag in ("npz", "ckpt"):
            t0 = time.perf_counter()
            out = main(NERF_EVAL_FLAGS + [
                "--root_dir", "scene", "--img_wh", "64", "64", "--split",
                "test", "--ckpt_path", f"w.{tag}", "--exp_name",
                f"smoke_nerf_{tag}"])
            files = os.listdir(out)
            for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                         f"smoke_nerf_{tag}_rgb_fine.gif"):
                assert name in files, (tag, name, files)
            with open(os.path.join(out, "psnr.json")) as f:
                psnrs[tag] = json.load(f)["psnrs"]
            assert np.isfinite(psnrs[tag]).all(), psnrs
            log(f"[mlp-main] eval CLI (nerf, --fused_field, from w.{tag}) "
                f"wrote {out}: {len(files)} entries, PSNRs {psnrs[tag]} "
                f"(seeded weights, σ column |w|·5), "
                f"{time.perf_counter() - t0:.1f} s")
        assert psnrs["npz"] == psnrs["ckpt"], psnrs
        cli_launches = fused_mlp_t.launches
        assert cli_launches > 0, "the flagship eval CLI never launched"

        cfg, args = get_opt(NERF_EVAL_FLAGS + ["--img_wh", "400", "300"])
        ctx = AppContext.build(cfg, args, field,
                               init_params(field, cfg, "cuda"), "cuda")
        rays_np = _view_rays(400, 300)
        mirror_ctx = replace(ctx, params={k: _all_mirror(v)
                                          for k, v in ctx.params.items()})
        views = [(label, c, *_time_view(c, rays_np))
                 for label, c in (("seeded weights", ctx),
                                  ("all-mirror weights", mirror_ctx))]
        # the main path's count ends here: the diagnostics below launch too
        launches = fused_mlp_t.launches
        assert launches > cli_launches, "run_view never launched the kernel"
        log(f"[mlp-main] kernel launches on the flagship's main path: "
            f"{launches} ({cli_launches} in the eval CLI, "
            f"{launches - cli_launches} in the timed run_view calls)")
        for label, c, res, times in views:
            _report_view(torch, c, rays_np, res, times, label, card,
                         size="400x300 flagship")
        _check_against_plain(torch, mirror_ctx, rays_np, n=256)
        return launches
    finally:
        os.chdir(cwd)


def _scaled_errs(got: dict, ref: dict) -> dict:
    """max |kernel − plain| per output, over max(1, max |plain|)."""
    return {k: float((got[k] - ref[k]).abs().max())
            / max(1.0, float(ref[k].abs().max())) for k in ref}


def _row_groups(rows) -> dict:
    """(B, 8) rows (or (B, 1) σ-only) -> σ, rgb, normal, mirror."""
    if rows.shape[-1] == 1:
        return {"sigma": rows[..., 0]}
    return {"sigma": rows[..., 0], "rgb": rows[..., 1:4],
            "normal": rows[..., 4:7], "mirror": rows[..., 7]}


def _rows_case(torch, tag: str, kern, plain, card: str, time_it=True,
               composite=False):
    """One per-sample kernel case against its plain version: errors (scaled
    above 1), Σw ≤ 1 + 1e-5 for a composite, and optionally the two times.
    Returns (worst error, kernel ms, plain ms, the kernel's outputs)."""
    with torch.no_grad():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        errs = _scaled_errs(got, ref)
        for k, v in got.items():
            assert v.is_cuda and bool(torch.isfinite(v).all()), (tag, k)
        ms = _time_ms(torch, kern, reps=5, warmup=1) if time_it else None
        plain_ms = (_time_ms(torch, plain, reps=3, warmup=1) if time_it
                    else None)
    extra = ""
    if composite:
        wsum = float(got["weights"].sum(-1).max())
        assert wsum <= 1.0 + 1e-5, (tag, wsum)
        extra = f"max Σw {wsum:.6f}; "
    times = (f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, " if time_it
             else "")
    log(f"[rows-kernel] {tag}: {times}({card}); {extra}max abs err (scaled "
        "above 1) " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert max(errs.values()) <= KERNEL_ATOL, (tag, errs)
    return max(errs.values()), ms, plain_ms, got


def _entry(name: str, source: str, replaces: str, worst: float, timed: dict,
           bound: tuple, tag: str) -> dict:
    """A JSON entry (launches filled in later) and its bound's log line;
    `bound` is (ms, by) or, for the CP composite's modes, `_cp_bound`'s
    three values."""
    bound_ms, bound_by = bound[:2]
    log(f"[rows-kernel] {name} at {tag}: bound {bound_ms:.3f} ms "
        f"({bound_by}); kernel at {bound_ms / timed['ms'] * 100:.1f} % of it, "
        f"plain at {bound_ms / timed['plain_ms'] * 100:.1f} %"
        + (f"; fp32 CUDA-core bound {bound[2]:.3f} ms, kernel at "
           f"{bound[2] / timed['ms'] * 100:.1f} %" if len(bound) > 2 else ""))
    out = {"name": name, "route": "cuda",
           "source": f"mirror_nerf_tpu_torch/csrc/{source}",
           "replaces": f"mirror_nerf_tpu/ops/pallas/{replaces}",
           "launches": 0, "max_abs_err": worst, "ms": timed["ms"],
           "plain_ms": timed["plain_ms"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None}
    if len(bound) > 2:
        out["bound_fp32_ms"] = bound[2]
    return out


def _ray_inputs(torch, rays_np, n: int, coarse_weights):
    """n strided rays of a view: o, d, z64 (stratified) and z128 (64 + 64
    merged on `coarse_weights(o, d, z64)`, as the fine pass gets them)."""
    from mirror_nerf_tpu_torch.core.sampling import (merge_fine_z_vals,
                                                     stratified_z_vals)

    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).cuda()
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    z64 = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 64).contiguous()
    with torch.no_grad():
        z128 = merge_fine_z_vals(z64, coarse_weights(o, d, z64), 64,
                                 0.0).contiguous()
    return o, d, z64, z128


def phase_rows_kernels(torch, card: str) -> list:
    """(11) The per-sample kernels of the σ-noise passes and point queries
    against their plain versions at the main paths' shapes. Returns the
    four JSON entries; the per-sample composite's and the points' launches
    are this phase's (no render path runs them), the rows modes' are set
    from phase 12."""
    from mirror_nerf_tpu_torch.core.sampling import stratified_z_vals
    from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.ops import fused_cp, fused_mlp
    from mirror_nerf_tpu_torch.ops import fused_mlp_t as fm
    from mirror_nerf_tpu_torch.tools import exp_mlp_diag

    fused_cp.launches_samples = fused_mlp.launches_points = 0
    n = 16384
    worst = {}

    # -- CP grid: rows (JAX fused_cp.py:314) and per-sample composite (:335)
    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    seeded = field.init(torch.Generator().manual_seed(0), "cuda")
    saturating = dict(seeded)
    s2 = seeded["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 2000.0
    saturating["sigma_net"] = [seeded["sigma_net"][0], {"w": s2}]
    o, d, z64, z128 = _ray_inputs(
        torch, _view_rays(800), n, lambda o, d, z: fused_cp.
        cp_rays_composite_reference(field, seeded, o, d, d, z, True)[
            "weights"])
    sum_r = sum(r for _, r in field.grid_levels)
    tables, _ = fused_cp._pack_tables(seeded, field.grid_levels)
    nets = fused_cp._pack_nets(seeded, field.grid_levels)
    timed = {}
    for pname, params in (("seeded", seeded), ("saturating", saturating)):
        for sigma_only, z in ((False, z128), (True, z64)):
            tag = (f"cp rows {pname} S={z.shape[1]} "
                   f"{'sigma-only' if sigma_only else 'full'}, {n} rays")
            err, ms, plain_ms, got = _rows_case(
                torch, tag,
                lambda: fused_cp.fused_cp_rays_eval(
                    field, params, o, d, d, z, sigma_only),
                lambda: fused_cp.cp_rays_rows_reference(
                    field, params, o, d, d, z, sigma_only),
                card, time_it=pname == "seeded")
            worst["cp_rows"] = max(worst.get("cp_rows", 0.0), err)
            if (pname, sigma_only) == ("seeded", False):
                timed["cp_rows"] = {"ms": ms, "plain_ms": plain_ms}
                rows_bytes = _nbytes(o, d, d, z, tables, nets) + n * 128 * 32
    for pname, params, act, sigma_only, z in (
            (pname, params, act, sigma_only, z)
            for pname, params in (("seeded", seeded),
                                  ("saturating", saturating))
            for act in ("relu", "softplus")
            for sigma_only, z in ((False, z128), (True, z64))):
        xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        v = d[:, None, :].expand_as(xyz).contiguous()
        dl = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full_like(z[:, :1], 1e10)], -1).contiguous()
        tag = (f"cp per-sample composite {pname} {act} S={z.shape[1]} "
               f"{'sigma-only' if sigma_only else 'full'}, {n} rays")
        err, ms, plain_ms, got = _rows_case(
            torch, tag,
            lambda: fused_cp.fused_cp_forward_composite(
                field, params, xyz, v, z, dl, sigma_only, act),
            lambda: fused_cp.cp_samples_composite_reference(
                field, params, xyz, v, z, dl, sigma_only, act),
            card, time_it=act == "relu" and pname == "seeded",
            composite=True)
        worst["cp_samples"] = max(worst.get("cp_samples", 0.0), err)
        if (pname, act, sigma_only) == ("seeded", "relu", False):
            timed["cp_samples"] = {"ms": ms, "plain_ms": plain_ms}
            samples_bytes = _nbytes(xyz, v, z, dl, tables, nets,
                                    *got.values())
    entries = [
        _entry("fused_cp_rows", "fused_cp_composite.cu", "fused_cp.py:314",
               worst["cp_rows"], timed["cp_rows"],
               _cp_bound(n * 128, sum_r, True, rows_bytes), "S=128 full"),
        _entry("fused_cp_samples_composite", "fused_cp_composite.cu",
               "fused_cp.py:335", worst["cp_samples"], timed["cp_samples"],
               _cp_bound(n * 128, sum_r, True, samples_bytes), "S=128 full")]
    del o, d, z64, z128, xyz, v, dl, got

    # -- flagship: rows (JAX fused_mlp.py:238) and points (:223)
    field = MirrorNeRFField()
    base = field.init(torch.Generator().manual_seed(0), "cuda")
    seeded = _sigma_scaled(base, 5.0)
    saturating = _sigma_scaled(base, 2000.0)
    o, d, z64, z128 = _ray_inputs(
        torch, _view_rays(400, 300), n, lambda o, d, z: fm.
        mlp_rays_composite_reference(field, seeded, o, d, d, z, True)[
            "weights"])
    packed = fm._pack(seeded)
    for pname, params, sigma_only, z in (
            ("seeded", seeded, False, z128), ("seeded", seeded, True, z64),
            ("saturating", saturating, False, z128)):
        tag = (f"flagship rows {pname} S={z.shape[1]} "
               f"{'sigma-only' if sigma_only else 'full'}, {n} rays")
        err, ms, plain_ms, got = _rows_case(
            torch, tag,
            lambda: _row_groups(fused_mlp.fused_rays_eval(
                field, params, o, d, d, z, sigma_only)),
            lambda: _row_groups(fused_mlp.mlp_rays_rows_reference(
                field, params, o, d, d, z, sigma_only)),
            card, time_it=pname == "seeded")
        worst["mlp_rows"] = max(worst.get("mlp_rows", 0.0), err)
        if (pname, sigma_only) == ("seeded", False):
            timed["mlp_rows"] = {"ms": ms, "plain_ms": plain_ms}
            mlp_rows_bytes = _nbytes(o, d, d, z, packed) + n * 128 * 32
    # raw σ against float64: the tensor cores' sums truncate toward zero,
    # so a bias is what a sum left on them too long shows (the diagnosis
    # tool's `layer_sums` build: ~1e-6 of σ's scale; the kernel's ~1e-8)
    bias = exp_mlp_diag.sigma_bias(
        {"kernel": fm._library.entry("mnerf_fused_mlp_t")})
    log(f"[rows-kernel] flagship rows raw σ against a float64 plain version, "
        f"S=128, {n} rays ({card}): mean signed error, max abs error (scaled "
        "above 1): " + "; ".join(f"{k} {m:+.3e}, {a:.3e}"
                                 for k, (m, a) in bias.items()))
    assert abs(bias["kernel"][0]) <= 1e-7, bias
    # S that do not tile the 256-sample block, on a ragged ray count
    n2 = 2048 + 37
    o2, d2 = o[:n2].contiguous(), d[:n2].contiguous()
    for s in (80, 192):
        z = stratified_z_vals(torch.full((n2, 1), 0.05, device="cuda"),
                              torch.full((n2, 1), 8.0, device="cuda"), s)
        for sigma_only in (False, True):
            err, *_ = _rows_case(
                torch, f"flagship rows seeded S={s} "
                f"{'sigma-only' if sigma_only else 'full'}, {n2} rays",
                lambda: _row_groups(fused_mlp.fused_rays_eval(
                    field, seeded, o2, d2, d2, z, sigma_only)),
                lambda: _row_groups(fused_mlp.mlp_rays_rows_reference(
                    field, seeded, o2, d2, d2, z, sigma_only)),
                card, time_it=False)
            worst["mlp_rows"] = max(worst["mlp_rows"], err)
    # points: the fine pass's sample positions, 16384·128, and an odd count
    pts = (o[:, None, :] + d[:, None, :] * z128[..., None]).reshape(-1, 3)
    dirs = d.repeat_interleave(128, 0)
    b_odd = 100_003
    for pname, params, sigma_only, b in (
            ("seeded", seeded, False, pts.shape[0]),
            ("seeded", seeded, True, pts.shape[0]),
            ("seeded", seeded, False, b_odd),
            ("saturating", saturating, False, b_odd)):
        x, v = pts[:b], dirs[:b]
        tag = (f"flagship points {pname} "
               f"{'sigma-only' if sigma_only else 'full'}, {b} points")
        err, ms, plain_ms, got = _rows_case(
            torch, tag,
            lambda: _row_groups(fused_mlp.fused_packed_eval(
                field, params, x, v, sigma_only)),
            lambda: _row_groups(fused_mlp.mlp_rows_reference(
                field, params, x, v, sigma_only)),
            card, time_it=b != b_odd)
        worst["mlp_points"] = max(worst.get("mlp_points", 0.0), err)
        if (pname, sigma_only, b) == ("seeded", False, pts.shape[0]):
            timed["mlp_points"] = {"ms": ms, "plain_ms": plain_ms}
            points_bytes = _nbytes(x, v, packed) + b * 32
    entries += [
        _entry("fused_mlp_rows", "fused_mlp_t.cu", "fused_mlp.py:238",
               worst["mlp_rows"], timed["mlp_rows"],
               _mlp_bound(n * 128, False, mlp_rows_bytes), "S=128 full"),
        _entry("fused_mlp_points", "fused_mlp_t.cu", "fused_mlp.py:223",
               worst["mlp_points"], timed["mlp_points"],
               _mlp_bound(pts.shape[0], False, points_bytes),
               f"{pts.shape[0]} points full")]
    entries[1]["launches"] = fused_cp.launches_samples
    entries[3]["launches"] = fused_mlp.launches_points
    log(f"[rows-kernel] launches in this phase: per-sample composite "
        f"{fused_cp.launches_samples}, points {fused_mlp.launches_points}")
    return entries


def _noise_view(torch, field, params, rays, ts, generator, chunk=16384):
    """One traced view through `trace_rays`, in chunks; rgb_fine, depth_fine
    and the resolved mirror mask of level 0, and the wall in seconds."""
    from mirror_nerf_tpu_torch.render.tracer import trace_rays

    keys = ("rgb_fine", "depth_fine", "mirror_mask_resolved")
    out = {k: [] for k in keys}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(0, rays.shape[0], chunk):
            sub = rays[i:i + chunk]
            res = trace_rays(field, params, sub,
                             torch.full_like(sub[:, 0], -1.0), ts, generator)
            for k in keys:
                out[k].append(res[k])
    torch.cuda.synchronize()
    return {k: torch.cat(v) for k, v in out.items()}, time.perf_counter() - t0


def phase_noise_path(torch, card: str) -> tuple:
    """(12) The σ-noise path: one level-2 traced view per model through
    `trace_rays` in 16384-ray chunks (CP grid 800×800, flagship 400×300;
    fused_field, noise_std 1, perturb 0, test_time, a seeded CUDA generator,
    all-mirror weights so every level blends in). The launch counters are
    reset before the timed view and read right after: the rows modes must
    launch, the composite kernels must not. Then, on 1024 rays, the fused
    route against the plain modules on the card from the same generator
    seed, and the flagship's fused_t=False route at noise 0 against its
    composite route. Returns the rows modes' launches (CP, flagship)."""
    from mirror_nerf_tpu_torch.eval import get_opt
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import fused_cp, fused_mlp, fused_mlp_t
    from mirror_nerf_tpu_torch.render.renderer import (RenderSettings,
                                                       render_rays)
    from mirror_nerf_tpu_torch.render.tracer import TraceSettings

    rs = RenderSettings(N_samples=64, N_importance=64, perturb=0.0,
                        noise_std=1.0, test_time=True, compute_normal=False,
                        fused_field=True)
    ts = TraceSettings(render=rs, max_recursive_level=2,
                       only_trace_mode="eval", is_eval=True)
    launches = []
    for model, flags, (w, h) in (("cp grid", EVAL_FLAGS, (800, 800)),
                                 ("flagship", NERF_EVAL_FLAGS, (400, 300))):
        cfg, _ = get_opt(flags + ["--img_wh", str(w), str(h)])
        field = make_field(cfg)
        params = {k: _all_mirror(v)
                  for k, v in init_params(field, cfg, "cuda").items()}
        rays = torch.from_numpy(_view_rays(w, h)).cuda()
        _noise_view(torch, field, params, rays[:1024], ts,
                    torch.Generator(device="cuda").manual_seed(0))  # warm
        fused_cp.launches = fused_cp.launches_rows = 0
        fused_mlp.launches_rays = fused_mlp_t.launches = 0
        out, wall = _noise_view(torch, field, params, rays, ts,
                                torch.Generator(device="cuda").manual_seed(1))
        rows = (fused_cp.launches_rows if model == "cp grid"
                else fused_mlp.launches_rays)
        composite = fused_cp.launches + fused_mlp_t.launches
        assert rows > 0, f"{model}: the rows mode never launched"
        assert composite == 0, f"{model}: a composite kernel launched"
        for k, v in out.items():
            assert v.shape[0] == rays.shape[0] and v.is_cuda, k
            assert bool(torch.isfinite(v).all()), k
        launches.append(rows)
        log(f"[noise] {model} {w}x{h} level-2 σ-noise view through "
            f"trace_rays: {wall:.3f} s -> {rays.shape[0] / wall:.1f} rays/s "
            f"({card}); rows-mode launches {rows}, composite launches "
            f"{composite}; mirror fraction "
            f"{float(out['mirror_mask_resolved'].mean()):.4f}, mean "
            f"opacity-weighted depth {float(out['depth_fine'].mean()):.3f}")

        sub = rays[::rays.shape[0] // 1024][:1024]
        got, want = (_noise_view(
            torch, field, params, sub, replace(ts, render=replace(
                rs, fused_field=fused)),
            torch.Generator(device="cuda").manual_seed(2))[0]
            for fused in (True, False))
        errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
        log(f"[noise] {model}: fused route vs plain modules on the card, "
            f"1024 rays, same generator seed: max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        assert max(errs.values()) <= RENDER_ATOL, errs
        if model == "flagship":
            quiet = replace(rs, noise_std=0.0)
            with torch.no_grad():
                t_on, t_off = (render_rays(field, params, sub, replace(
                    quiet, fused_t=ft)) for ft in (True, False))
            errs = {k: float((t_on[k] - t_off[k]).abs().max())
                    for k in ("rgb_fine", "depth_fine", "opacity_fine",
                              "mirror_mask_fine", "surface_normal_fine",
                              "weights_coarse")}
            log(f"[noise] flagship at noise 0, fused_t=False (rows) vs "
                f"fused_t=True (composite), 1024 rays: max abs err "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            assert max(errs.values()) <= RENDER_ATOL, errs
    return tuple(launches)


def _dense_scaled(field, params: dict, scale: float = 1e4) -> dict:
    """Hash-grid weights with the table's dense levels (0–3 at bound 6)
    ×`scale`: at the ±1e-4 init σ is ~0 everywhere, no sample is opaque and
    no ray a mirror. The hashed levels keep the init."""
    n = sum(lv.size for lv in field.grid_spec.levels() if not lv.use_hash)
    grid = params["grid"].clone()
    grid[:n] *= scale
    return {**params, "grid": grid}


# operations per (point, level) of the hash-grid lookup, counted as fp32
# operations (a multiply-add as 2): pos 3 FMAs, floor and fraction (6),
# 1 − t (3), eight corner weights of two multiplies, eight corner rows of C
# multiply-adds; the integer index work is not counted
def _hash_flop(c: int = 2) -> int:
    return 6 + 6 + 3 + 8 * 2 + 8 * c * 2


def _hash_composite_bound(samples: int, full: bool, nbytes: float):
    """(bound_ms, bound_by) of the fused NGP composite: its nets' products
    (the CP composite's without the fold, `_cp_flop(0, full)`) at fp32
    accuracy are fastest as 3×TF32 on the tensor cores, the levels'
    interpolation (16 × `_hash_flop`) on the fp32 CUDA cores beside them;
    bytes over the memory rate."""
    t_ops = max(3 * samples * _cp_flop(0, full)[0] / PEAK_TF32,
                samples * 16 * _hash_flop() / PEAK_FP32) * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _gather_sectors(torch, field, o, d, z) -> int:
    """The 32-B L2 sectors the fused kernel's corner loads touch: per
    sample and level, the distinct sectors of its eight 8-B corner rows
    (the kernel loads them for samples out of bound too), summed; a figure
    beside the bound, not a bound."""
    from mirror_nerf_tpu_torch.ops import hashgrid as hg

    spec = field.grid_spec
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    x01 = (xyz + field.bound) * field.inv_2b
    corners = hg._corner_offsets(3, x01.device)
    total = 0
    for lv in spec.levels():
        pg, _ = hg._grid_pos(x01, lv.scale, 0.5)
        rows = lv.offset + hg._corner_indices(
            spec, lv, pg[None] + corners[:, None, :])  # (8, N)
        sec = torch.sort(rows * 8 // 32, dim=0).values
        total += int(sec.shape[1] + (sec[1:] != sec[:-1]).sum())
    return total


def _dense_sectors(torch, rows, x, scale, side) -> tuple:
    """DENSE's L2 traffic per sample on these inputs: the 32-B sector
    requests of the first design (eight 8-B corner loads, each within one
    sector), those of this one (one 16-B load an x-pair of corners where
    `hashgrid.dense_pair_loads` says so, else two), and the distinct
    sectors a sample's corners touch."""
    from mirror_nerf_tpu_torch.ops import hashgrid as hg

    r8 = hg.dense_corner_rows(rows.shape[0], x, scale, side)  # (8, N)
    pairs = hg.dense_pair_loads(r8, rows.data_ptr())  # (4, N)
    after = float((8 - pairs.sum(0)).float().mean())
    sec = torch.sort((rows.data_ptr() + r8 * 8) // 32, dim=0).values
    distinct = float((1 + (sec[1:] != sec[:-1]).sum(0)).float().mean())
    return 8.0, after, distinct


def _fused_hash_kernel(torch, card: str) -> dict:
    """(13, first part) The fused NGP composite vs its plain version at the
    main path's shapes (`tools/exp_hash_diag.py cases`): errors, Σw, times
    beside the bound and the gathers' sector figure, the SASS of its four
    instances and ptxas' report. Returns its JSON entry (launches set from
    phase 14)."""
    from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_hash
    from mirror_nerf_tpu_torch.tools import exp_hash_diag

    sass = _build.sass_counts(_build.library_path(fused_hash._LIB),
                              "hash_field_kernel")
    assert len(sass) == 4 and min(c["HMMA"] for c in sass.values()) > 0, \
        sass
    for name, c in sorted(sass.items()):
        log(f"[hash-fused] SASS of {exp_hash_diag._instance(name)}: "
            + ", ".join(f"{k} {v}" for k, v in c.items()))
    for line in exp_hash_diag.ptxas_lines(
            _build.build_log.get(fused_hash._LIB, "")):
        log(f"[hash-fused] ptxas: {line}")

    worst, timed = 0.0, {}
    field, o, d, _ = exp_hash_diag.inputs()
    for case, (kern, plain, params, z) in exp_hash_diag.cases().items():
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            errs = _scaled_errs(got, ref)
            wsum = float(got["weights"].sum(-1).max())
            for k, v in got.items():
                assert v.is_cuda and bool(torch.isfinite(v).all()), (case, k)
            line = (f"[hash-fused] {case}: max w "
                    f"{float(got['weights'].max()):.4f}, max Σw {wsum:.6f}; "
                    "max abs err (scaled above 1) " + ", ".join(
                        f"{k} {v:.3e}" for k, v in errs.items()))
            if case.startswith("seeded relu"):
                ms = _time_ms(torch, kern, reps=20, warmup=3)
                plain_ms = _time_ms(torch, plain, reps=3, warmup=1)
                full = "full" in case
                nbytes = (_nbytes(o, d, d if full else None, z,
                                  params["grid"], *got.values())
                          + 4 * fused_cp.NETS)
                b_ms, b_by = _hash_composite_bound(z.numel(), full, nbytes)
                timed[case] = (ms, plain_ms, b_ms, b_by, z)
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                         f"bound {b_ms:.4f} ms ({b_by}; 3×TF32 products on "
                         "the tensor cores, the lerps on the fp32 cores "
                         f"beside them, {nbytes / 1e6:.1f} MB): the kernel "
                         f"reaches {b_ms / ms * 100:.1f} %")
        log(line + f" ({card})")
        assert max(errs.values()) <= KERNEL_ATOL, (case, errs)
        assert wsum <= 1.0 + 1e-5, (case, wsum)
        worst = max(worst, max(errs.values()))

    ms, plain_ms, b_ms, b_by, z128 = timed["seeded relu S=128 full"]
    with torch.no_grad():
        sectors = _gather_sectors(torch, field, o, d, z128)
    n_smp = z128.numel()
    log(f"[hash-fused] gathers at S=128 full ({n_smp} samples): "
        f"{sectors} distinct 32-B sectors ({sectors / n_smp:.1f} a sample "
        f"for 128 corner loads), {sectors * 32 / 1e9:.3f} GB of L2→SM "
        f"sectors: {sectors * 32 / ms / 1e9:.2f} TB/s at the kernel's "
        f"{ms:.3f} ms ({card})")
    return {"name": "fused_hash_composite", "route": "cuda",
            "source": "mirror_nerf_tpu_torch/csrc/fused_cp_composite.cu",
            "replaces": "tools/exp_hash_inkernel.py:59", "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "sigma_only_ms": timed["seeded relu S=64 sigma-only"][0],
            "sector_gb": sectors * 32 / 1e9}


def phase_hash_kernels(torch, card: str) -> list:
    """(13) The fused NGP composite vs its plain version; the hash-grid
    kernel's modes vs their plain versions, then the probe's timing entry
    point as the GATHER/DENSE path. Returns the four JSON entries (the
    fused kernel's and ENCODE's launches set from phase 14)."""
    fused = _fused_hash_kernel(torch, card)
    from mirror_nerf_tpu_torch.core.sampling import stratified_z_vals
    from mirror_nerf_tpu_torch.ops import hashgrid as hg
    from mirror_nerf_tpu_torch.tools import exp_hash_inkernel as probe

    src = "mirror_nerf_tpu_torch/csrc/hashgrid.cu"
    # kernel vs plain: the probe's parity part at the path's point count
    par = probe.parity("cuda", probe.PATH_POINTS)
    torch.cuda.synchronize()
    log(f"[hash-kernel] parity ({card}): GATHER fp32 / bf16 max abs err "
        f"{par['gather_fp32']:.1e} / {par['gather_bf16']:.1e} (bit for bit "
        f"on {probe.IDX_SHAPE} indices); DENSE level 3 {par['dense']:.3e}, "
        f"vs ENCODE's level-3 slice {par['dense_vs_encode_level3']:.3e}; "
        f"ENCODE at {probe.PATH_POINTS} points "
        f"({par['encode_oob_share'] * 100:.2f} % out of bound, ×1e4 table) "
        f"{par['encode']:.3e} (scaled above 1)")
    for k in ("dense", "dense_vs_encode_level3", "encode"):
        assert par[k] <= 1e-5, (k, par)
    assert par["gather_fp32"] == 0.0 and par["gather_bf16"] == 0.0, par
    assert par["dense"] == 0.0, par
    # DENSE bit for bit beyond the probe's input: a level read from its
    # second row (odd rows 16-B aligned) at samples whose rows wrap, and
    # level 0 of the bound-6 spec (4920 rows, side 17: not side³, odd side)
    from mirror_nerf_tpu_torch.tools.exp_hash_diag import dense_inputs
    cases = dense_inputs()
    spec0, table0, _ = probe.encode_case(8, 5, "cuda")
    lv0 = spec0.levels()[0]
    g0 = torch.Generator().manual_seed(6)
    cases["level0_wrap"] = (
        table0[lv0.offset:lv0.offset + lv0.size].contiguous(),
        (torch.rand((100_003, 3), generator=g0) * 1.1 - 0.05).cuda(),
        lv0.scale, lv0.resolution + 1)
    with torch.no_grad():
        for case, (rows, x, scale, side) in cases.items():
            got = hg.dense_level_lookup(rows, x, scale, side)
            want = hg.dense_level_lookup_reference(rows, x, scale, side)
            assert torch.equal(got, want), (case, int((got != want).sum()))
    torch.cuda.synchronize()
    before, after, distinct = _dense_sectors(
        torch, *cases["probe"])
    log(f"[hash-kernel] DENSE bit for bit against its plain version on "
        f"{', '.join(cases)} ({card}); its L2 traffic on the probe's "
        f"{probe.DENSE_SAMPLES} samples, per sample: {before:.3f} sector "
        f"requests with the first design's eight 8-B corner loads, "
        f"{after:.3f} with the 16-B x-pairs; {distinct:.3f} distinct 32-B "
        "sectors (figures, not bounds)")

    # ENCODE at the view's sample positions: 16384 strided rays × 128
    spec, table, _ = probe.encode_case(8, 3, "cuda")
    n = 16384
    rays_np = _view_rays(800)
    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).cuda()
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 128)
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(
        -1, 3)
    x01 = ((xyz + 6.0) * (1.0 / 12.0)).contiguous()
    oob = float(((x01 < 0) | (x01 > 1)).any(-1).float().mean())
    with torch.no_grad():
        got = hg.hashgrid_encode(table, x01, spec)
        ref = hg.hashgrid_encode_reference(table, x01, spec)
        err = float((got - ref).abs().max()) / max(1.0, float(
            ref.abs().max()))
        assert err <= 1e-5, err
        enc_ms = _time_ms(torch, lambda: hg.hashgrid_encode(table, x01, spec),
                          reps=20, warmup=2)
        enc_plain = _time_ms(torch, lambda: hg.hashgrid_encode_reference(
            table, x01, spec), reps=3, warmup=1)
    npts = x01.shape[0]
    enc_bound = _bound(npts * spec.num_levels * _hash_flop(),
                       _nbytes(x01, table, got))
    log(f"[hash-kernel] ENCODE at the 800x800 view's samples ({n} rays × 128 "
        f"= {npts} points, {oob * 100:.2f} % out of bound): kernel "
        f"{enc_ms:.3f} ms, plain {enc_plain:.3f} ms ({card}); max abs err "
        f"(scaled above 1) {err:.3e}; bound {enc_bound[0]:.3f} ms "
        f"({enc_bound[1]}): the kernel at {enc_bound[0] / enc_ms * 100:.1f} %"
        f", {npts / enc_ms / 1e3:.1f} M points/s, "
        f"{npts * 16 * 8 / enc_ms / 1e6:.2f} G corner rows/s")
    worst_enc = max(err, par["encode"])
    del got, ref, xyz, x01

    # the probe's entry point (its timing part) is the GATHER/DENSE path:
    # kernel, plain and library times at the JAX probe's shapes
    hg.launches_gather = hg.launches_dense = 0
    b = probe.main(["--skip_parity"])["bench"]
    launches = (hg.launches_gather, hg.launches_dense)
    assert min(launches) > 0, f"the probe never launched: {launches}"
    n_idx = probe.IDX_SHAPE[0] * probe.IDX_SHAPE[1]
    # table, idx and out once; level rows, x and out once
    g_bound = _bound(0, probe.TABLE_ROWS * 8 + n_idx * (4 + 8))
    d_bound = _bound(probe.DENSE_SAMPLES * _hash_flop(),
                     probe.DENSE_SIDE ** 3 * 8 + probe.DENSE_SAMPLES * (12 + 8))
    dev_ms = ", ".join(f"{k} {v['device_ms']:.4f}" for k, v in b.items()
                       if "device_ms" in v)
    log(f"[hash-kernel] probe (python -m mirror_nerf_tpu_torch.tools."
        f"exp_hash_inkernel, {card}), ms per call (CUDA events): GATHER "
        f"fp32 {b['B_gather_fp32']['ms']:.4f} / bf16 "
        f"{b['B_gather_bf16']['ms']:.4f}, plain "
        f"{b['B_gather_plain_fp32']['ms']:.4f}, torch indexing "
        f"{b['A_torch_index_fp32']['ms']:.4f} / "
        f"{b['A_torch_index_bf16']['ms']:.4f} (bound "
        f"{g_bound[0]:.4f}, {g_bound[1]}); DENSE {b['C_dense']['ms']:.4f}, "
        f"plain {b['C_dense_plain']['ms']:.4f}, grid_sample "
        f"{b['C_dense_grid_sample']['ms']:.4f} (max |Δ| "
        f"{b['C_dense_grid_sample']['max_abs_diff']:.1e}, its own "
        f"coordinate rounding; bound {d_bound[0]:.4f}, {d_bound[1]}); "
        f"ENCODE at uniform points {b['D_encode']['ms']:.3f}, plain "
        f"{b['D_encode_plain']['ms']:.3f}. Device ms per call (profiler): "
        f"{dev_ms}. Launches GATHER {launches[0]}, DENSE {launches[1]}")
    log(f"[hash-kernel] GATHER per call in turns ({card}), µs: fp32 through "
        f"the wrapper {b['B_gather_fp32']['ms'] * 1e3:.2f}, bare ctypes "
        f"{b['B_gather_bare_fp32']['ms'] * 1e3:.2f}, torch indexing "
        f"{b['A_torch_index_fp32']['ms'] * 1e3:.2f}; bf16 "
        f"{b['B_gather_bf16']['ms'] * 1e3:.2f} / "
        f"{b['B_gather_bare_bf16']['ms'] * 1e3:.2f} / "
        f"{b['A_torch_index_bf16']['ms'] * 1e3:.2f}")

    def entry(name, replaces, worst, ms, plain, bound, lib):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"tools/exp_hash_inkernel.py:{replaces}",
                "launches": 0, "max_abs_err": worst, "ms": ms,
                "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": lib}

    enc = entry("hashgrid_encode", 59, worst_enc, enc_ms, enc_plain,
                enc_bound, None)
    gat = entry("hashgrid_gather", 59, 0.0, b["B_gather_fp32"]["ms"],
                b["B_gather_plain_fp32"]["ms"], g_bound,
                b["A_torch_index_fp32"]["ms"])
    den = entry("hashgrid_dense", 137, max(par["dense"],
                                          par["dense_vs_encode_level3"]),
                b["C_dense"]["ms"], b["C_dense_plain"]["ms"], d_bound,
                b["C_dense_grid_sample"]["ms"])
    gat["launches"], den["launches"] = launches
    return [fused, enc, gat, den]


def _fused_ctx(ctx):
    """The same eval context with --fused_field."""
    return replace(ctx, rs=replace(ctx.rs, fused_field=True),
                   rs_sec=None if ctx.rs_sec is None else replace(
                       ctx.rs_sec, fused_field=True))


def _ngp_fused_path(torch, card: str, views, rays_np, psnr_unfused):
    """(14, second part) The eval CLI with --fused_field (the fused NGP
    composite), then the 800×800 view with and without the flag in turns on
    the same weights. Returns the fused kernel's launches on that path."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval import main
    from mirror_nerf_tpu_torch.eval.apps import run_view
    from mirror_nerf_tpu_torch.ops import fused_hash, hashgrid

    hashgrid.launches_encode = fused_hash.launches = 0
    t0 = time.perf_counter()
    out = main(NGP_EVAL_FLAGS + [
        "--fused_field", "--root_dir", "scene", "--img_wh", "64", "64",
        "--split", "test", "--ckpt_path", "w.npz", "--exp_name",
        "smoke_ngp_fused"])
    with open(os.path.join(out, "psnr.json")) as f:
        psnrs = json.load(f)["psnrs"]
    assert "rgb_fine_001.png" in os.listdir(out), os.listdir(out)
    cli = (fused_hash.launches, hashgrid.launches_encode)
    log(f"[ngp-main] eval CLI (nerf_tcnn --fused_field, from w.npz) wrote "
        f"{out}: PSNRs {psnrs} (without the flag {psnr_unfused}), fused "
        f"kernel launches {cli[0]}, ENCODE launches {cli[1]}, "
        f"{time.perf_counter() - t0:.1f} s")
    assert cli[0] > 0 and cli[1] == 0, cli
    # the same checkpoint, two routes: the quality parity bar (ROADMAP.md)
    assert np.allclose(psnrs, psnr_unfused, atol=0.05, rtol=0), psnrs

    sample = {"rays": rays_np}
    fused_launches, encode_launches = cli
    for label, ctx, _, _ in views:
        fctx = _fused_ctx(ctx)
        run_view(fctx, sample)  # warm
        walls = {"without": [], "with": []}
        for flag in ("without", "with", "with", "without") * 2:
            c = fctx if flag == "with" else ctx
            n0 = (fused_hash.launches, hashgrid.launches_encode)
            t0 = time.perf_counter()
            res = run_view(c, sample)
            walls[flag].append(time.perf_counter() - t0)
            if flag == "with":
                fused_launches += fused_hash.launches - n0[0]
                encode_launches += hashgrid.launches_encode - n0[1]
                fused_res = res
            else:
                assert fused_hash.launches == n0[0], label
        n = rays_np.shape[0]
        log(f"[ngp-main] 800x800 hash-grid level-2 view, {label}, in turns "
            f"on the same weights ({card}): without --fused_field "
            f"{n / min(walls['without']):.1f} rays/s (best of "
            f"{len(walls['without'])}: "
            f"{', '.join(f'{w:.3f}' for w in walls['without'])} s), with "
            f"{n / min(walls['with']):.1f} rays/s ("
            f"{', '.join(f'{w:.3f}' for w in walls['with'])} s): "
            f"{min(walls['without']) / min(walls['with']):.2f}×")
        views_fused = (label, fctx, fused_res, walls["with"])
    # the main path's count ends here: the diagnostics below launch too
    log(f"[ngp-main] fused NGP composite launches on the fused path: "
        f"{fused_launches} ({cli[0]} in the eval CLI); ENCODE launches "
        f"there: {encode_launches}")
    assert fused_launches > cli[0] and encode_launches == 0, (
        fused_launches, encode_launches)
    label, fctx, res, walls = views_fused
    _report_view(torch, fctx, rays_np, res, walls, f"{label}, --fused_field",
                 card, size="800x800 hash-grid")
    _check_against_plain(torch, fctx, rays_np, n=256)
    return fused_launches


def phase_ngp_main_path(torch, card: str) -> tuple:
    """(14) The hash-grid model's eval path on the card, without and with
    --fused_field. Returns ENCODE's launches (without) and the fused
    kernel's (with)."""
    import numpy as np

    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import get_opt, main
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import hashgrid
    from mirror_nerf_tpu_torch.train.checkpoints import (save_pytree,
                                                         save_torch_ckpt)

    work = WORK / "ngp"
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        generate_scene("scene", n_train=1, n_val=1, n_test=2,
                       img_wh=(64, 64))
        cfg, _ = get_opt(NGP_EVAL_FLAGS)
        field = make_field(cfg)
        weights = {k: _dense_scaled(field, _all_mirror(v)) for k, v in
                   init_params(field, cfg, "cpu").items()}
        save_pytree("w.npz", weights)
        save_torch_ckpt("w.ckpt", weights)
        hashgrid.launches_encode = 0
        psnrs = {}
        for tag in ("npz", "ckpt"):
            t0 = time.perf_counter()
            out = main(NGP_EVAL_FLAGS + [
                "--root_dir", "scene", "--img_wh", "64", "64", "--split",
                "test", "--ckpt_path", f"w.{tag}", "--exp_name",
                f"smoke_ngp_{tag}"])
            files = os.listdir(out)
            for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                         f"smoke_ngp_{tag}_rgb_fine.gif"):
                assert name in files, (tag, name, files)
            with open(os.path.join(out, "psnr.json")) as f:
                psnrs[tag] = json.load(f)["psnrs"]
            assert np.isfinite(psnrs[tag]).all(), psnrs
            log(f"[ngp-main] eval CLI (nerf_tcnn, from w.{tag}) wrote {out}: "
                f"{len(files)} entries, PSNRs {psnrs[tag]} (all-mirror "
                f"weights, dense levels ×1e4), "
                f"{time.perf_counter() - t0:.1f} s")
        assert psnrs["npz"] == psnrs["ckpt"], psnrs
        cli_launches = hashgrid.launches_encode
        assert cli_launches > 0, "the hash-grid eval CLI never launched"

        cfg, args = get_opt(NGP_EVAL_FLAGS + ["--img_wh", "800", "800"])
        ctx = AppContext.build(cfg, args, field,
                               init_params(field, cfg, "cuda"), "cuda")
        assert ctx.params["fine"]["grid"].is_cuda
        rays_np = _view_rays(800)
        mirror_ctx = replace(ctx, params={
            k: _dense_scaled(field, _all_mirror(v))
            for k, v in ctx.params.items()})
        views = [(label, c, *_time_view(c, rays_np))
                 for label, c in (("seeded weights", ctx),
                                  ("all-mirror weights", mirror_ctx))]
        # the main path's count ends here: the diagnostics below launch too
        launches = hashgrid.launches_encode
        assert launches > cli_launches, "run_view never launched ENCODE"
        log(f"[ngp-main] ENCODE launches on the hash-grid model's main path: "
            f"{launches} ({cli_launches} in the eval CLI, "
            f"{launches - cli_launches} in the timed run_view calls)")
        for label, c, res, times in views:
            _report_view(torch, c, rays_np, res, times, label, card,
                         size="800x800 hash-grid")
        _check_against_plain(torch, mirror_ctx, rays_np, n=256)
        return launches, _ngp_fused_path(torch, card, views, rays_np,
                                         psnrs["npz"])
    finally:
        os.chdir(cwd)


# the tensor cores' dense peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BF16 = 989e12  # FLOP/s
PEAK_INT8 = 1979e12  # OP/s


def phase_probe_kernels(torch, card: str) -> list:
    """(15) The last three probes' kernels vs their plain versions on the
    card, then each probe's entry point (its timing part) with its counters
    reset before and read after: their path. Returns seven JSON entries."""
    from mirror_nerf_tpu_torch.ops import _build
    from mirror_nerf_tpu_torch.ops import invoke_floor as fl
    from mirror_nerf_tpu_torch.ops import segment_scan as ss
    from mirror_nerf_tpu_torch.ops import table_mma as tm
    from mirror_nerf_tpu_torch.tools import exp_int8_probe as p8
    from mirror_nerf_tpu_torch.tools import exp_invoke_floor as pf
    from mirror_nerf_tpu_torch.tools import exp_reshape_probe as pr

    # 10c: SMALL and GRID bit for bit, and a chain looped in C
    par_f = pf.parity("cuda")
    log(f"[probe-kernel] floor ({card}): values that differ from the plain "
        "version " + ", ".join(f"{k} {v}" for k, v in par_f.items()))
    # 10a at the composite's 2,097,152 values: both modes, S = 128, 64, 16,
    # uniform and sentinel input, against float64 (the sentinels' own
    # values equal to their segment's other values' sum)
    with torch.no_grad():
        x = pr.path_input("cuda")
        worst = {"scan": 0.0, "tri": 0.0}
        by_kind = {}
        for s in (128, 64, 16):
            for kind in pr.KINDS:
                xi = pr.kind_input(x, s, kind)
                for mode in worst:
                    err, last = pr.prefix_errors(
                        ss.segment_prefix(xi, s, mode), xi, s)
                    assert err <= pr.PREFIX_BAR and last <= pr.PREFIX_BAR, \
                        (s, kind, mode, err, last)
                    worst[mode] = max(worst[mode], err, last)
                    by_kind[mode, kind] = max(by_kind.get((mode, kind), 0.0),
                                              err, last)
        torch.cuda.synchronize()
        # WEIGHTS at S = 128 against its plain version, the sentinel input
        sd = pr.with_sentinel(pr.path_input("cuda", seed=1, high=1.5), 128)
        w = ss.prefix_weights(sd, 128)
        w_err = float((w - ss.prefix_weights_reference(sd, 128)).abs().max())
        w_sum = float(w.reshape(-1, 128).sum(-1).max())
        assert w_err <= 1e-5 and w_sum <= 1.0 + 1e-5, (w_err, w_sum)
    log(f"[probe-kernel] segmented prefix at {x.numel()} values ({card}), "
        f"S = 128, 64, 16, uniform, sentinel and wide (1e-6 … 1e10): max "
        f"error vs float64 (scaled above 1) SCAN {worst['scan']:.3e}, TRI "
        f"{worst['tri']:.3e} (" + ", ".join(
            f"{m.upper()} {k} {v:.3e}" for (m, k), v in by_kind.items())
        + f"); WEIGHTS (S = 128) max abs err {w_err:.3e}, max Σw "
        f"{w_sum:.7f}")
    # TRI's machine code: every instance on the tensor cores
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path(ss._LIB))], capture_output=True, text=True,
        check=True).stdout
    hmma = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.splitlines()[0].strip()
        if "tri_kernel" in name:
            hmma[name] = f.count("HMMA")
    assert len(hmma) == 8 and min(hmma.values()) > 0, hmma
    log(f"[probe-kernel] TRI's SASS (cuobjdump): HMMA instructions per "
        f"instance {sorted(hmma.values())}")
    # 10b at the JAX probe's defaults: int8 bit for bit, bf16 ≤ 1e-5 scaled,
    # on the probe's input and the edge inputs (negative, clipping at ±127,
    # bf16 rounding ties); a size with several lane tiles, a ragged row
    # tile and an int8 chunk of 64
    from mirror_nerf_tpu_torch.tools.exp_table_diag import edge_inputs
    size = dict(g=512, r=64, lanes=1024, blocks=64, tables=9)
    par_8 = p8.parity("cuda", size)
    edge = {}
    with torch.no_grad():
        for sz in (size, dict(g=192, r=80, lanes=640, blocks=3, tables=2)):
            x8, tabs8 = p8.inputs(**sz, seed=9, device="cuda")
            for case, xc in edge_inputs(x8).items():
                for kind, t in tabs8.items():
                    got = tm.table_mma(xc, t)
                    ref = tm.table_mma_reference(xc, t)
                    if kind == "int8":
                        assert torch.equal(got, ref), (sz, case)
                    else:
                        err = p8._scaled_err(got, ref)
                        assert err <= p8.BF16_BAR, (sz, case, err)
                        edge[case] = max(edge.get(case, 0.0), err)
                        if sz is size and case == "uniform":
                            # the tensor cores' truncating sums: the mean
                            # error toward zero, scaled (a figure)
                            bias = float(((got - ref) * torch.sign(ref))
                                         .double().mean()) / max(
                                1.0, float(ref.abs().max()))
    torch.cuda.synchronize()
    par_8["bf16"] = max(par_8["bf16"], *edge.values())
    log(f"[probe-kernel] table products at {size} ({card}): int8 "
        f"{par_8['int8_values_that_differ']} values differ, bf16 max err "
        f"{par_8['bf16']:.3e} (scaled above 1); with g 192, r 80, 640 "
        "lanes too, int8 bit for bit and bf16 on the edge inputs "
        + ", ".join(f"{k} {v:.3e}" for k, v in edge.items())
        + f"; bf16's mean error away from zero at the defaults {bias:.3e} "
        "(scaled above 1; negative: toward zero)")
    # both instances on wgmma (IGMMA int8, HGMMA bf16: cuobjdump), and
    # ptxas' registers and spills
    gmma = {}
    for name, counts in _build.sass_counts(
            _build.library_path(tm._LIB), "table_mma_kernel",
            ("IGMMA", "HGMMA", "F2I", "LDL", "STL")).items():
        gmma["bf16" if "bfloat16" in name else "int8"] = counts
    assert gmma["int8"]["IGMMA"] > 0 and gmma["bf16"]["HGMMA"] > 0, gmma
    ptx = _build.ptxas_by_function(_build.build_log.get(tm._LIB, ""),
                                   "table_mma_kernel")
    log(f"[probe-kernel] table products' SASS (cuobjdump): " + "; ".join(
        f"{k} " + ", ".join(f"{op} {n}" for op, n in v.items())
        for k, v in gmma.items()) + "; ptxas: " + "; ".join(
        f"{'bf16' if 'bfloat16' in k else 'int8'} {v}"
        for k, v in ptx.items()))

    # the entry points' timing parts are the kernels' path
    fl.launches_small = fl.launches_grid = 0
    bf = pf.main(["--skip_parity"])["bench"]
    floor_launches = (fl.launches_small, fl.launches_grid)
    ss.launches_scan = ss.launches_tri = ss.launches_weights = 0
    br = pr.main(["--skip_parity"])["bench"]
    scan_launches = (ss.launches_scan, ss.launches_tri, ss.launches_weights)
    tm.launches_int8 = tm.launches_bf16 = 0
    b8 = p8.main(["--skip_parity"])["bench"]
    mma_launches = (tm.launches_int8, tm.launches_bf16)
    for name, n in (("floor", floor_launches), ("segment scan", scan_launches),
                    ("table mma", mma_launches)):
        assert min(n) > 0, f"the {name} probe never launched: {n}"
    log(f"[probe-kernel] the launch floor ({card}), µs per rep, best of "
        f"{pf.BEST_OF} chains of {pf.REPS}:\n{pf.format_table(bf['floor_us'])}")
    fu = bf["floor_us"]
    log(f"[probe-kernel] floor: device µs per launch (profiler) "
        + ", ".join(f"{k} {v:.3f}" for k, v in bf["device_us"].items())
        + f"; graph replays launched {fu['one']['graph_launches']} SMALL "
        f"kernels past the counter (counted {fu['one']['counted_at_capture']}"
        f" at capture); launches SMALL {floor_launches[0]}, GRID "
        f"{floor_launches[1]}")
    log(f"[probe-kernel] floor ({card}): {pf.format_breakdown(bf['breakdown'])}")
    log(f"[probe-kernel] floor SMALL ({card}): the wrapper "
        f"{fu['one']['wrapper']:.3f} µs a rep against bare ctypes "
        f"{fu['one']['ctypes']:.3f}: {fu['one']['wrapper'] - fu['one']['ctypes']:.3f}"
        " µs of launch path")

    def entry(name, source, replaces, worst, ms, plain, bound, lib, n,
              dev=None):
        e = {"name": name, "route": "cuda",
             "source": f"mirror_nerf_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": n, "max_abs_err": worst,
             "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": lib}
        if dev is not None:
            e["device_ms"] = dev
        return e

    fsrc, rep_f = "invoke_floor.cu", "tools/exp_invoke_floor.py"
    small_b = _bound(0, 2 * 8 * 128 * 4)
    grid_b = _bound(0, 2 * 128 * 4096 * 4)
    entries = [
        entry("floor_small", fsrc, f"{rep_f}:43", 0.0,
              fu["one"]["bare"] / 1e3, bf["plain_ms"]["small"], small_b,
              fu["none"]["wrapper"] / 1e3, floor_launches[0],
              bf["device_us"]["small"] / 1e3),
        entry("floor_grid", fsrc, f"{rep_f}:55", 0.0,
              fu["grid"]["bare"] / 1e3, bf["plain_ms"]["grid"], grid_b,
              fu["none_grid"]["wrapper"] / 1e3, floor_launches[1],
              bf["device_us"]["grid"] / 1e3)]
    n_vals = pr.PATH_SHAPE[0] * pr.PATH_SHAPE[1]
    scan_b = _bound(0, 2 * n_vals * 4)
    for i, mode in enumerate(("scan", "tri")):
        r = br[f"path_S128_{mode}"]
        entries.append(entry(
            f"segment_{mode}", "segment_scan.cu",
            "tools/exp_reshape_probe.py:35", worst[mode], r["ms"],
            br["path_S128_plain"]["ms"], scan_b,
            br["path_S128_cumsum"]["ms"], scan_launches[i], r["device_ms"]))
        entries[-1]["cold_device_ms"] = r["cold_device_ms"]
    r = br["path_S128_weights"]
    entries.append(entry(
        "prefix_weights", "segment_scan.cu", "tests/test_fused_cp.py:204",
        w_err, r["ms"], br["path_S128_weights_plain"]["ms"], scan_b, None,
        scan_launches[2], r["device_ms"]))
    entries[-1]["cold_device_ms"] = r["cold_device_ms"]
    c, tri = br["path_S128_cumsum"], br["path_S128_tri"]
    log(f"[probe-kernel] torch.cumsum on the (16384, 128) segment view "
        f"({card}): device {c['device_ms']:.4f} ms, cold L2 "
        f"{c['cold_device_ms']:.4f} ms; TRI device {tri['device_ms']:.4f} "
        f"ms, cold {tri['cold_device_ms']:.4f} ms ({scan_b[0] / tri['cold_device_ms'] * 100:.1f} % of "
        f"its {scan_b[0] * 1e3:.2f} µs bound cold)")
    log(f"[probe-kernel] per call in turns ({card}), 2,097,152 values, "
        f"S = 128: SCAN through the wrapper {br['path_S128_scan']['ms'] * 1e3:.2f}"
        f" µs, bare ctypes {br['path_S128_scan_bare']['ms'] * 1e3:.2f} µs, "
        f"torch.cumsum {c['ms'] * 1e3:.2f} µs; TRI "
        f"{tri['ms'] * 1e3:.2f} µs; WEIGHTS "
        f"{br['path_S128_weights']['ms'] * 1e3:.2f} µs")
    ops = b8["operations"]
    n_basis = size["blocks"] * size["tables"] * size["g"] * size["lanes"]
    out_bytes = size["blocks"] * size["r"] * size["lanes"] * 4
    for i, (kind, peak) in enumerate((("int8", PEAK_INT8),
                                      ("bf16", PEAK_BF16))):
        # the products on the tensor cores, the basis build (three fp32
        # operations an element) on the CUDA cores, x and out once
        t_ops = max(ops / peak, 3 * n_basis / PEAK_FP32) * 1e3
        t_bytes = (out_bytes + size["blocks"] * size["lanes"] * 4) \
            / PEAK_HBM * 1e3
        bound = (max(t_ops, t_bytes),
                 "operations" if t_ops >= t_bytes else "bytes")
        v = b8[kind]
        # no single PyTorch call computes the function: the GEMMs on bases
        # built beforehand do less work, the build + GEMMs two calls a table
        entries.append(entry(
            f"table_mma_{kind}", "table_mma.cu", "tools/exp_int8_probe.py:49",
            0.0 if kind == "int8" else par_8["bf16"], v["ms"], v["plain_ms"],
            bound, None, mma_launches[i], v["device_ms"]))
        entries[-1]["library_gemm_only_ms"] = v["library_ms"]
        entries[-1]["library_build_gemm_ms"] = v["library_build_ms"]
        log(f"[probe-kernel] table_mma_{kind} ({card}): library GEMMs only "
            f"(bases built beforehand) {v['library_ms']:.4f} ms, device "
            f"{v['library_device_ms']:.4f}; build + GEMMs "
            f"{v['library_build_ms']:.4f} ms, device "
            f"{v['library_build_device_ms']:.4f}")
    for e in entries:
        dev = (f", device {e['device_ms']:.4f} ms"
               + (f" (cold L2 {e['cold_device_ms']:.4f} ms)"
                  if "cold_device_ms" in e else "")
               if "device_ms" in e else "")
        lib = (f", library {e['library_ms']:.4f} ms"
               if e["library_ms"] is not None else "")
        log(f"[probe-kernel] {e['name']} ({card}): kernel {e['ms']:.4f} ms"
            f"{dev}, plain {e['plain_ms']:.4f} ms{lib}; bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}); launches "
            f"{e['launches']}")
    return entries


# BWD and BWD2 against their plain versions, each error scaled to the
# largest entry: the table grads within 1e-5 of the plain version run in
# float64 (the kernel's atomics and the fp32 plain version's index_add_
# both add in an order that changes from run to run, so the two fp32 sums
# are held to the exact one, not to each other), d_dy, dx01 and d_x01
# within 1e-5 of the fp32 plain version; on the layout with every point in
# one level-0 cell the table grads' bar grows with the reductions its
# busiest row takes, as fp32's rounding does (`exp_hash_diag.table_bar`)
HASH_BWD_REL = 1e-5
# runs of BWD and BWD2 whose table grads' error is logged (its spread)
HASH_BWD_REPS = 10


def _scale_err(got, ref) -> float:
    """max|got − ref| / max|ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def _signed_mean(got, ref64) -> float:
    """The mean error away from zero against a float64 version, over the
    entries that are not 0 there, scaled by its largest entry (negative:
    toward zero)."""
    nz = ref64 != 0
    d = ((got.double() - ref64) * ref64.sign())[nz]
    return float(d.mean()) / float(ref64.abs().max()) if d.numel() else 0.0


def _bwd_level_split(torch, hg, spec, table, x, dy) -> dict:
    """BWD's table grads (no dx01) over a subset of the levels, by bare
    launches of the C entry on the level table's rows of those levels: all
    16, the 4 dense ones (the coarse levels, where every sample of a batch
    adds into a few thousand rows) and the 12 hashed ones; ms a call, the zeroing of d_table included, as the wrapper
    does it."""
    words = hg._level_table(spec, x.device)
    n_dense = sum(not lv.use_hash for lv in spec.levels())
    d = torch.zeros_like(table)
    out = {}
    for key, (lo, hi) in (("16 levels", (0, spec.num_levels)),
                          (f"the {n_dense} dense", (0, n_dense)),
                          (f"the {spec.num_levels - n_dense} hashed",
                           (n_dense, spec.num_levels))):
        w = words[lo:hi].contiguous()
        dyl = dy[:, 2 * lo:2 * hi].contiguous()

        def run(w=w, dyl=dyl, k=hi - lo):
            d.zero_()
            hg._library.launch(
                "mnerf_hash_bwd", "hash-grid BWD (levels)", x.device.index,
                x.data_ptr(), table.data_ptr(), w.data_ptr(), k, 2,
                x.shape[0], dyl.data_ptr(), d.data_ptr(), None)

        out[key] = _time_ms(torch, run, reps=20, warmup=3)
    return out


def _hash_bwd_code() -> dict:
    """The SASS of BWD's and BWD2's instances: kind -> opcode counts summed
    over its instances. A table grad must leave as a no-return reduction
    (REDG or RED), never as an atomic that returns the old value (ATOMG or
    ATOM)."""
    from mirror_nerf_tpu_torch.ops import _build

    ops = ("REDG", "RED", "ATOMG", "ATOM", "SHFL", "LDG")
    counts = _build.sass_counts(_build.library_path("hashgrid"),
                                "hash_backward", ops)
    out = {}
    for name, c in counts.items():
        kind = "BWD2" if "hash_backward2" in name else "BWD"
        for k, v in c.items():
            out.setdefault(kind, dict.fromkeys(ops, 0))[k] += v
    return out


def _hash_bwd_case(torch, card, spec, table, name, x, dy, g,
                   full: bool) -> dict:
    """BWD and BWD2 on one layout: errors against the plain versions, the
    signed mean error against float64, the run-to-run spread of the table
    grads (twice, and their error over HASH_BWD_REPS + 1 runs each), the
    reductions the kernels send (`reduction_plan`) and times;
    with `full`, also the table-only and dx01-only times, the plain
    versions', the level split, the bound and `index_add_` on the same
    pairs."""
    from mirror_nerf_tpu_torch.ops import hashgrid as hg
    from mirror_nerf_tpu_torch.tools.exp_hash_diag import (ONE_CELL,
                                                           table_bar)

    n = x.shape[0]
    with torch.no_grad():
        # BWD: d_table and dx01
        got = hg.encode_backward(table, x, dy, spec)
        again = hg.encode_backward(table, x, dy, spec)
        torch.cuda.synchronize()
        ref = hg.encode_backward_reference(table, x, dy, spec)
        r64 = hg.encode_backward_reference(table.double(), x.double(),
                                           dy.double(), spec)
        outside = ~hg._in_cube(x)
        assert (name == ONE_CELL or bool(outside.any())) and bool(
            (got[1][outside] == 0).all()), "dx01 outside the cube"
        e1 = {"d_table": _scale_err(got[0], r64[0]),
              "dx01": _scale_err(got[1], ref[1])}
        fp32_t = {"d_table": _scale_err(got[0], ref[0])}
        m1 = {"d_table": _signed_mean(got[0], r64[0]),
              "dx01": _signed_mean(got[1], r64[1])}
        spread = _scale_err(again[0], got[0])
        runs1 = [e1["d_table"], _scale_err(again[0], r64[0])] + [
            _scale_err(hg.encode_backward(table, x, dy, spec)[0], r64[0])
            for _ in range(HASH_BWD_REPS - 1)]
        del again, r64
        # BWD2: d_dy, d_table, d_x01
        got2 = hg.encode_backward2(table, x, dy, g, spec)
        torch.cuda.synchronize()
        ref2 = hg.encode_backward2_reference(table, x, dy, g, spec)
        r642 = hg.encode_backward2_reference(
            table.double(), x.double(), dy.double(), g.double(), spec)
        e2 = {k: _scale_err(a, b) for k, a, b in zip(
            ("d_table", "d_dy", "d_x01"), got2, (r642[0], *ref2[1:]))}
        fp32_t["bwd2 d_table"] = _scale_err(got2[0], ref2[0])
        runs2 = [e2["d_table"]] + [
            _scale_err(hg.encode_backward2(table, x, dy, g, spec)[0],
                       r642[0]) for _ in range(HASH_BWD_REPS)]
        m2 = {k: _signed_mean(a, b) for k, a, b in zip(
            ("d_table", "d_dy", "d_x01"), got2, r642)}
        del r642
        for v in (*got, *got2):
            assert v.is_cuda and bool(torch.isfinite(v).all()), name
        assert bool((got2[1][outside] == 0).all()) and bool(
            (got2[2][outside] == 0).all()), "BWD2 outside the cube"
        # times: BWD both outputs (the bound's function), table only (the
        # loss backward's σ path) and dx01 only (the normal pass); BWD2 all
        ms = _time_ms(torch, lambda: hg.encode_backward(table, x, dy, spec),
                      reps=20, warmup=3)
        ms2 = _time_ms(torch, lambda: hg.encode_backward2(
            table, x, dy, g, spec), reps=20, warmup=3)

        sent_rows, _, by_level = hg.reduction_plan(spec, x,
                                                   hg.pair_values(spec, dy))
        busiest = int(torch.bincount(sent_rows).max())
        del sent_rows
        if full:
            ms_t = _time_ms(torch, lambda: hg.encode_backward(
                table, x, dy, spec, True, False), reps=20, warmup=3)
            ms_x = _time_ms(torch, lambda: hg.encode_backward(
                table, x, dy, spec, False, True), reps=20, warmup=3)
            plain = _time_ms(torch, lambda: hg.encode_backward_reference(
                table, x, dy, spec), reps=2, warmup=1)
            plain2 = _time_ms(torch, lambda: hg.encode_backward2_reference(
                table, x, dy, g, spec), reps=2, warmup=1)
            split = _bwd_level_split(torch, hg, spec, table, x, dy)
            lib = {}
            for key, gk in (("bwd", None), ("bwd2", g)):
                rows, vals = hg.table_grad_pairs(spec, x, hg.pair_values(
                    spec, dy, gk))
                sectors = int(torch.unique(rows * 8 // 32).numel())
                d = torch.zeros_like(table)
                lib[key] = _time_ms(torch, lambda: d.zero_().index_add_(
                    0, rows, vals), reps=20, warmup=3)
                del rows, vals, d
    n_red = sum(p for p, _, _ in by_level)
    sent = sum(r for _, r, _ in by_level)
    log(f"[hash-bwd] {name}, {n} points ({int(outside.sum())} outside the "
        f"cube) ({card}): BWD max err (scaled to the largest "
        f"entry; d_table vs float64) " + ", ".join(
            f"{k} {v:.3e}" for k, v in e1.items())
        + "; signed mean vs float64 " + ", ".join(
            f"{k} {v:.2e}" for k, v in m1.items())
        + f"; the table grads twice differ by {spread:.2e}. BWD2 max err "
        + ", ".join(f"{k} {v:.3e}" for k, v in e2.items())
        + "; signed mean vs float64 " + ", ".join(
            f"{k} {v:.2e}" for k, v in m2.items())
        + "; the table grads vs the fp32 plain version (a figure) "
        + ", ".join(f"{k} {v:.3e}" for k, v in fp32_t.items()))
    log(f"[hash-bwd] {name}: {n_red} (row, value) pairs, {sent} global "
        f"reductions sent ({sent / max(n_red, 1):.3f} a pair; "
        "`reduction_plan`); by level (pairs / reductions / distinct rows a "
        "warp of 32 consecutive points): " + ", ".join(
            f"{li}: {p}/{r}/{t:.1f}" for li, (p, r, t) in
            enumerate(by_level)))
    bar = table_bar(name, busiest)
    log(f"[hash-bwd] {name} ({card}): the table grads' error vs float64 "
        f"(scaled) over {len(runs1)} runs: BWD min {min(runs1):.3e}, median "
        f"{sorted(runs1)[len(runs1) // 2]:.3e}, max {max(runs1):.3e}; BWD2 "
        f"min {min(runs2):.3e}, median {sorted(runs2)[len(runs2) // 2]:.3e}, "
        f"max {max(runs2):.3e}; the busiest row takes {busiest} reductions "
        f"(2^-24·sqrt of it {2.0**-24 * busiest**0.5:.3e}); bar {bar:.3e}")
    for k, v in {**e1, **{"bwd2 " + k: v for k, v in e2.items()}}.items():
        assert v <= (bar if k.endswith("d_table") else HASH_BWD_REL), (
            name, k, v)
    assert max(runs1 + runs2) <= bar, (name, max(runs1 + runs2), bar)
    if not full:
        log(f"[hash-bwd] {name} ({card}): BWD {ms:.4f} ms, BWD2 {ms2:.4f} ms")
        return {"bwd": (ms, None, None, None, max(e1.values())),
                "bwd2": (ms2, None, None, None, max(e2.values()))}
    pl = n_red // 8  # (point, level) pairs in the cube
    dense_out = table.numel() * 4  # d_table, zeroed and written whole
    # bytes: x, dy and dx01 once, the table's distinct 32-B sectors that
    # dx01 reads once, d_table written once (52.9 MB: the wrapper zeroes it
    # and the reductions add into it); BWD2 adds g, d_dy and d_x01;
    # operations (fp32, a multiply-add 2) per (point, level) in the cube:
    # pos, floor, fraction and 1 − t (15), per corner the weight (2), its
    # table grad (2), the dot (3), three weight grads and their sums (12)
    # for BWD; BWD2 per corner u (12), d_dy (4), the table grad (2), the dot
    # (3), three mixed second derivatives (6) and the d_x sums (18)
    b1 = _bound(pl * (15 + 8 * 19),
                n * (12 + 128 + 12) + 32 * sectors + dense_out)
    b2 = _bound(pl * (15 + 8 * 45),
                n * (12 + 128 + 12 + 128 + 12) + 32 * sectors + dense_out)
    log(f"[hash-bwd] {name} ({card}): BWD {ms:.4f} ms (table grads only "
        f"{ms_t:.4f}, dx01 only {ms_x:.4f}), plain {plain:.3f} ms, bound "
        f"{b1[0]:.4f} ms ({b1[1]}; {sectors} distinct 32-B sectors read, "
        f"d_table's {dense_out} B written), index_add_ on the same {n_red} "
        f"pairs {lib['bwd']:.4f} ms; BWD2 {ms2:.4f} ms, plain {plain2:.3f} "
        f"ms, bound {b2[0]:.4f} ms ({b2[1]}), index_add_ on its {n_red} "
        f"table pairs {lib['bwd2']:.4f} ms; the table grads' time by "
        "levels, bare launches: all " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items()))
    return {"bwd": (ms, plain, b1, lib["bwd"], max(e1.values())),
            "bwd2": (ms2, plain2, b2, lib["bwd2"], max(e2.values()))}


def phase_hash_bwd_kernels(torch, card: str) -> list:
    """(16) BWD and BWD2 against their plain versions at full width on four
    layouts (timed in full on two). Returns their two JSON entries
    (launches set from phase 17)."""
    from mirror_nerf_tpu_torch.tools.exp_hash_diag import bwd_cases

    spec, table, cases = bwd_cases()
    full = ("uniform", "ray-ordered 1024 x 128")
    res = {name: _hash_bwd_case(torch, card, spec, table, name, *c,
                                full=name in full)
           for name, c in cases.items()}
    code = _hash_bwd_code()
    log("[hash-bwd] SASS (cuobjdump, summed over the instances): " + "; ".join(
        f"{kind} " + ", ".join(f"{k} {v}" for k, v in c.items())
        for kind, c in code.items()))
    for kind, c in code.items():
        assert c["ATOMG"] + c["ATOM"] == 0 and c["REDG"] + c["RED"] > 0, (
            kind, c)
    entries = []
    for key, title in (("bwd", "hashgrid_backward"),
                       ("bwd2", "hashgrid_backward2")):
        ms, plain, bound, lib, _ = res["ray-ordered 1024 x 128"][key]
        entries.append({
            "name": title, "route": "cuda",
            "source": "mirror_nerf_tpu_torch/csrc/hashgrid.cu",
            "replaces": "mirror_nerf_tpu/ops/hashgrid.py:137",
            "launches": 0,
            "max_abs_err": max(r[key][4] for r in res.values()),
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib,
            "uniform_ms": res["uniform"][key][0]})
    return entries


def _model_train_flags(model: str) -> list:
    """TRAIN_FLAGS for another model: its own --decay_step 2 4 8 (run.sh
    mode 0's for nerf and nerf_tcnn) and no --grid_lr_mult."""
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--model_type") + 1] = model
    i = flags.index("--decay_step")
    flags[i + 1:i + 4] = ["2", "4", "8"]
    i = flags.index("--grid_lr_mult")
    del flags[i:i + 2]
    return flags


def _count_calls(module, names):
    """Wrap module functions to count their calls; returns (counts,
    restore)."""
    counts = dict.fromkeys(names, 0)
    real = {k: getattr(module, k) for k in names}

    def wrap(k):
        def f(*a, **kw):
            counts[k] += 1
            return real[k](*a, **kw)
        return f

    for k in names:
        setattr(module, k, wrap(k))
    return counts, lambda: [setattr(module, k, v) for k, v in real.items()]


def _train_model(torch, card: str, model: str, eval_flags: list) -> tuple:
    """(17) One model through the train CLI (two epochs, geometry then
    reflection) on phase 7's scene, its checkpoint through the eval CLI
    with --fused_field, then a profiled reflection-stage step. Returns the
    hash-grid kernels' launches in the train CLI and the rate."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.ops import hashgrid as hg
    from mirror_nerf_tpu_torch.train.checkpoints import tree_leaves
    from mirror_nerf_tpu_torch.train.cli import main as train_main

    scene = str(WORK / "train" / "scene")
    work = WORK / f"train_{model}"
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    plain, restore = _count_calls(hg, ("hashgrid_encode_reference",
                                       "encode_backward_reference",
                                       "encode_backward2_reference"))
    try:
        hg.launches_encode = hg.launches_bwd = hg.launches_bwd2 = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_main(_model_train_flags(model) + [
            "--root_dir", scene, "--img_wh", "64", "64", "--exp_name",
            f"smoke_{model}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = (hg.launches_encode, hg.launches_bwd, hg.launches_bwd2)
        calls = dict(plain)
        restore()
        assert not torch.backends.cuda.matmul.allow_tf32
        recs = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "metrics.jsonl"))]
        vals = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "val_metrics.jsonl"))]
        assert {r["stage"] for r in recs} == {"geometry", "full"}, recs
        for r in recs + vals:
            for k, v in r.items():
                if isinstance(v, float):
                    assert np.isfinite(v), (model, k, r)
        assert "normal_loss" in recs[-1] and "novel_ray_reg" in recs[-1]
        for leaf in tree_leaves(tr.params):
            assert leaf.is_cuda
        for st in tr.opt.opt.state.values():
            for k, v in st.items():
                assert k == "step" or v.is_cuda, k
        if model == "nerf_tcnn":
            assert min(launches) > 0, f"hash-grid kernels: {launches}"
            assert not any(calls.values()), f"plain versions ran: {calls}"
        log(f"[train-{model}] train CLI wrote {tr.workdir}: {len(recs)} log "
            f"lines, {tr.global_step} steps, {wall:.1f} s; launches ENCODE "
            f"{launches[0]}, BWD {launches[1]}, BWD2 {launches[2]}; plain "
            f"hash-grid calls {calls}; peak memory {peak:.2f} GiB "
            f"(max_memory_allocated, {card})")
        for v, stage in zip(vals, ("geometry", "reflection")):
            log(f"[train-{model}] epoch {v['epoch']} ({stage} stage): loss "
                f"{v['loss']:.4f}, train psnr {v['psnr']:.2f}, val psnr "
                f"{v['val_psnr']:.2f}, {v['rays_per_sec']:.1f} rays/s at "
                f"batch 1024, steady state after the first step ({card})")
        out = eval_main(eval_flags + [
            "--root_dir", scene, "--img_wh", "64", "64", "--split", "test",
            "--ckpt_path", os.path.join(tr.workdir, "last.ckpt.npz"),
            "--exp_name", f"smoke_{model}_trained"])
        with open(os.path.join(out, "psnr.json")) as f:
            table = json.load(f)
        assert np.isfinite(table["mean_psnr"]), table
        log(f"[train-{model}] last.ckpt.npz through the eval CLI "
            f"(--fused_field): test PSNR {table['mean_psnr']:.2f}")
        sys.path.insert(0, str(ROOT / "tools"))
        from profile_train_torch import step_profile

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.reset_peak_memory_stats()
        r = step_profile(tr, tr.cfg, "cuda", acts)
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        dev_ms = r["device_ms_per_step"] * 3

        def share(key):
            return sum(ms for name, (_, ms) in r["by_name"].items()
                       if key in name) / max(dev_ms, 1e-9)

        log(f"[train-{model}] reflection-stage step, batch {r['batch']} "
            f"({card}): {r['ms_per_step']:.2f} ms/step, "
            f"{r['rays_per_s']:.1f} rays/s (host clock, synchronized); "
            f"traced: summed device time {r['device_ms_per_step']:.3f} ms a "
            f"step, idle share {r['idle_share']:.4f}, BWD "
            f"{100 * share('hash_backward_kernel'):.1f} % and BWD2 "
            f"{100 * share('hash_backward2_kernel'):.1f} % of the device "
            f"time, ENCODE {100 * share('hash_encode_kernel'):.1f} %; "
            f"{r['events_per_step']:.0f} device events a step; peak memory "
            f"{step_peak:.2f} GiB")
        for name, (cnt, ms) in sorted(r["by_name"].items(),
                                      key=lambda kv: -kv[1][1])[:6]:
            log(f"[train-{model}]   {ms / 3:8.3f} ms a step x{cnt // 3:4d}  "
                f"{name}")
        assert r["events_per_step"] > 0, r
        return launches, vals[-1]["rays_per_sec"], r["rays_per_s"]
    finally:
        restore()
        os.chdir(cwd)


def phase_model_training(torch, card: str) -> tuple:
    """(17) The hash-grid model and the flagship through the train CLI.
    Returns BWD's and BWD2's launches in the hash-grid run."""
    ngp = _train_model(torch, card, "nerf_tcnn",
                       NGP_EVAL_FLAGS + ["--fused_field"])
    mlp = _train_model(torch, card, "nerf", NERF_EVAL_FLAGS)
    for model, (_, epoch_rate, step_rate) in (("nerf_tcnn", ngp),
                                               ("nerf", mlp)):
        log(f"[train-{model}] reflection-stage train-step rate at batch "
            f"1024: {step_rate:.1f} rays/s profiled steps, {epoch_rate:.1f} "
            f"rays/s over the CLI's reflection epoch ({card})")
    return ngp[0][1], ngp[0][2]


def phase_grad_normal_views(torch, card: str) -> None:
    """(18) The eval CLI without --predict_normal (item [10]: the tracer
    reflects about ∇σ), the CP grid (∇σ from the train kernel's forward
    with tangents) and the hash grid (ENCODE then BWD for dx01), seeded
    all-mirror weights (the hash grid's dense levels ×1e4)."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval import get_opt
    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.ops import hashgrid as hg
    from mirror_nerf_tpu_torch.train.checkpoints import save_pytree

    scene = str(WORK / "train" / "scene")
    work = WORK / "grad_normal"
    work.mkdir(parents=True)
    for model, flags in (("nerf_tpu", EVAL_FLAGS),
                         ("nerf_tcnn", NGP_EVAL_FLAGS)):
        flags = [f for f in flags if f != "--predict_normal"]
        cfg, _ = get_opt(flags)
        field = make_field(cfg)
        weights = {}
        for k, v in init_params(field, cfg, "cpu").items():
            v = _all_mirror(v)
            weights[k] = _dense_scaled(field, v) if model == "nerf_tcnn" \
                else v
        npz = str(work / f"{model}.npz")
        save_pytree(npz, weights)
        fct.launches_fwd = hg.launches_encode = hg.launches_bwd = 0
        t0 = time.perf_counter()
        out = eval_main(flags + [
            "--root_dir", scene, "--img_wh", "64", "64", "--split", "test",
            "--ckpt_path", npz, "--exp_name", f"smoke_{model}_grad_normal"])
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "psnr.json")) as f:
            table = json.load(f)
        n = (fct.launches_fwd, hg.launches_encode, hg.launches_bwd)
        assert np.isfinite(table["mean_psnr"]), table
        assert (n[0] > 0) if model == "nerf_tpu" else min(n[1:]) > 0, n
        log(f"[grad-normal] {model} eval CLI without --predict_normal "
            f"(reflecting about ∇σ), all-mirror weights: test PSNR "
            f"{table['mean_psnr']:.2f}, {wall:.1f} s; launches CP train "
            f"forward {n[0]}, ENCODE {n[1]}, BWD {n[2]} ({card})")


def _write_guests(torch, path: Path) -> None:
    """(19) The guest objects' files: a seeded full-width D-NeRF .tar (8×256,
    posenc 10/4, 64 samples, no fine net; the α bias +20: an opaque shell
    at the object's near plane, 2 from each ray's origin in its frame, 1 in
    the livingroom scene's)
    with its config.txt, and a nerf_pl Lightning .ckpt (the flagship
    without heads, the σ column |w|·5)."""
    from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
    from mirror_nerf_tpu_torch.models.guests import (DNeRFField,
                                                     dnerf_state_dict)
    from mirror_nerf_tpu_torch.train.checkpoints import save_torch_ckpt

    path.mkdir(parents=True)
    dp = DNeRFField().init(torch.Generator().manual_seed(31))
    dp["alpha"]["b"] = dp["alpha"]["b"] + 20.0
    torch.save({"global_step": 0,
                "network_fn_state_dict": dnerf_state_dict(dp),
                "network_fine_state_dict": None}, path / "dnerf.tar")
    (path / "config.txt").write_text(
        "netdepth = 8\nnetwidth = 256\nmultires = 10\nmultires_views = 4\n"
        "N_samples = 64\nN_importance = 0\nuse_viewdirs = True\n")
    field = MirrorNeRFField(predict_normal=False, predict_mirror_mask=False)
    g = torch.Generator().manual_seed(32)
    save_torch_ckpt(str(path / "nerf_pl.ckpt"),
                    {k: _sigma_scaled(field.init(g), 5.0)
                     for k in ("coarse", "fine")})


def _app_ctx(torch, flags: list, device: str):
    """An eval context for `flags` on `device`, its weights from the
    flags' --ckpt_path."""
    from mirror_nerf_tpu_torch.eval import get_opt
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.models.fields import make_field

    cfg, args = get_opt(flags)
    field = make_field(cfg)
    return AppContext.build(cfg, args, field,
                            init_params(field, cfg, device), device)


def _app_noises(torch, ctx, n: int, progress: float):
    """The roughness bundles' normal perturbations for n rays, drawn on the
    CPU from a fixed seed (the same for the card and the plain version)."""
    import numpy as np

    if not ctx.app.roughness:
        return None
    a = ctx.args
    cycle = progress * 2 if progress < 0.5 else 1 - (progress - 0.5) * 2
    std = a.normal_noise_std * (cycle if a.normal_noise_std_changes else 1)
    z = np.random.default_rng(19).normal(
        size=(a.trace_ray_times + 1, n, 3)).astype(np.float32) * std
    return [torch.from_numpy(v) for v in z]


def _cast_tree(torch, tree, dtype):
    return torch.utils._pytree.tree_map(
        lambda t: t.to(dtype) if torch.is_tensor(t) else t, tree)


def _deep_vs_float64(torch, flags: list, sub) -> dict:
    """(19, C1) Mode 3's deep trace on the same rays to level 50: the card
    (fp32 kernels), the plain version on the CPU in fp32 and in float64,
    the same weights (no noise in mode 3). Per level: the rays whose
    throughput T differs from float64's, and the largest |rgb − float64's|
    over the rays float64 still carries into that level; then the final
    rgb_fine's distance to float64, the card's beside the CPU's."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import eval_trace_deep

    runs = {}
    for name, dev, dtype in (("card", "cuda", torch.float32),
                             ("cpu", "cpu", torch.float32),
                             ("f64", "cpu", torch.float64)):
        ctx = _app_ctx(torch, flags, dev)
        levels = []
        with torch.no_grad():
            res = eval_trace_deep(
                ctx.field, {k: _cast_tree(torch, v, dtype)
                            for k, v in ctx.params.items()},
                sub.to(dev, dtype), ctx.rs, ctx.app,
                ctx.cfg.max_recursive_level, ctx.cfg.trace_secondary_rays,
                rs_secondary=ctx.rs_sec, levels=levels)
        runs[name] = ([(t.double().cpu().numpy(), r.double().cpu().numpy())
                       for t, r in levels],
                      res["rgb_fine"].double().cpu().numpy())
    ref = runs["f64"][0]
    n = min(len(ref), *(len(runs[k][0]) for k in ("card", "cpu")))
    first_apart = None
    for lv in range(n):
        alive = (np.ones(len(sub), bool) if lv == 0 else ref[lv - 1][0] > 0)
        row = {}
        for k in ("card", "cpu"):
            t, rgb = runs[k][0][lv]
            row[k] = (int((t != ref[lv][0]).sum()),
                      float(np.abs(rgb - ref[lv][1]).max(-1)[alive].max()
                            if alive.any() else 0.0))
        if first_apart is None and row["card"][1] > 2 * row["cpu"][1] + 1e-6:
            first_apart = lv
        if lv < 3 or lv % 10 == 0 or lv == n - 1 or row["card"][0] \
                or row["cpu"][0]:
            log(f"[apps] C1 level {lv}: T differs from float64 on card "
                f"{row['card'][0]} / CPU {row['cpu'][0]} rays; rendered rgb "
                f"max |Δ| card {row['card'][1]:.3e}, CPU {row['cpu'][1]:.3e}")
    errs = {k: np.abs(runs[k][1] - runs["f64"][1]).max(-1)
            for k in ("card", "cpu")}
    out = {k: float(e.max()) for k, e in errs.items()}
    lv0 = {k: float(np.abs(runs[k][0][0][1] - ref[0][1]).max())
           for k in ("card", "cpu")}
    out["ratio0"] = lv0["card"] / max(lv0["cpu"], 1e-12)
    log(f"[apps] C1 mode 3 to level 50, {len(sub)} rays, levels rendered "
        f"card {len(runs['card'][0]) - 1}, CPU {len(runs['cpu'][0]) - 1}, "
        f"float64 {len(ref) - 1}: rgb_fine max |Δ| to float64 card "
        f"{out['card']:.3e} (median {np.median(errs['card']):.1e}), CPU "
        f"fp32 {out['cpu']:.3e} (median {np.median(errs['cpu']):.1e}); "
        f"first level where the card's rendered rgb is over 2x the CPU's "
        f"distance: {first_apart}")
    return out


def _guest_drawn(torch, flags: list, rays_np, n: int = 256) -> int:
    """(19, C2) The D-NeRF guest, scaled so that its opaque shell lies at
    the median depth of the scene on these rays: the preset's scale 2 puts
    it at ~1, behind every depth of phase 7's checkpoint, and it is drawn
    on none. On n strided rays, the rays where it is drawn at level 0 (the
    composited depth is the guest's, its opacity above 0.8): the card's
    and the CPU's sets agree on ≥ 99 % and the card is within RENDER_ATOL
    of the plain version there. Returns the count."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import render_chunk

    sub = torch.from_numpy(rays_np[::len(rays_np) // n][:n].copy())
    t = APP_PROGRESS["4_d_nerf"]
    with torch.no_grad():
        ctx = _app_ctx(torch, flags, "cpu")
        (_, s0) = ctx.obj_render_fn.transform
        scene = render_chunk(ctx, sub, 1.0, t)["depth_fine"]
        rays_obj = sub.clone()
        rays_obj[:, 0:3] = sub[:, 0:3] * s0
        shell = ctx.obj_render_fn(rays_obj, t)["depth"]
        scale = float(shell.median() / scene.median())
        out = {}
        for dev in ("cuda", "cpu"):
            ctx = _app_ctx(torch, flags, dev)
            fn = ctx.obj_render_fn
            fn.transform = ((0.0, 0.0, 0.0), scale)
            rays = sub.to(dev)
            res = render_chunk(ctx, rays, 1.0, t)
            rays_obj = rays.clone()
            rays_obj[:, 0:3] = rays[:, 0:3] * scale
            obj = fn(rays_obj, t)
            drawn = ((res["depth_fine"] == obj["depth"] / scale)
                     & (obj["opacity"] > 0.8))
            out[dev] = {k: res[k].cpu().numpy() for k in (
                "rgb_fine", "depth_fine", "mirror_mask_resolved")}
            out[dev]["drawn"] = drawn.cpu().numpy()
    g, c = out["cuda"], out["cpu"]
    both = g["drawn"] & c["drawn"]
    errs = {k: float(np.abs(g[k] - c[k]).reshape(n, -1).max(-1)[both].max())
            for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved")} \
        if both.any() else {}
    log(f"[apps] C2 D-NeRF guest at scale {scale:.4f} (its shell at the "
        f"scene's median depth {float(scene.median()):.4f}; the preset's "
        f"scale {s0}): drawn on {int(g['drawn'].sum())} of {n} rays on the "
        f"card, {int(c['drawn'].sum())} on the CPU, {int(both.sum())} on "
        f"both; there card vs plain CPU max abs err {errs}")
    assert both.any() and (g["drawn"] == c["drawn"]).mean() >= 0.99, (
        g["drawn"].sum(), c["drawn"].sum())
    assert max(errs.values()) <= RENDER_ATOL, errs
    return int(both.sum())


def _app_vs_plain(torch, mode: str, flags: list, rays_np, progress: float,
                  n: int = 256) -> None:
    """(19) One application on the card against the plain version on the
    CPU, n strided rays of the view, the same weights and injected noise:
    the level-0 mirror mask agrees on ≥ 99 % of the rays, and where it does
    every output is within RENDER_ATOL. The deep trace is held so at 5
    levels. At its 50 the error is logged and the levels reached must
    agree: a ray that is a mirror at every level (phase 7's checkpoint
    makes every ray one) follows a 50-bounce path on which fp32 differences
    grow bounce by bounce, so its last level's colour is ill-conditioned."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.apps import render_chunk

    sub = torch.from_numpy(rays_np[::len(rays_np) // n][:n].copy())

    def run(fl):
        out = {}
        with torch.no_grad():
            for dev in ("cuda", "cpu"):
                ctx = _app_ctx(torch, fl, dev)
                noises = _app_noises(torch, ctx, n, progress)
                res = render_chunk(ctx, sub.to(ctx.device), 1.0, progress,
                                   noises and [z.to(ctx.device)
                                               for z in noises])
                out[dev] = {k: (v.cpu().numpy() if torch.is_tensor(v)
                                else v) for k, v in res.items()}
        return out, ctx.deep

    def compare(out, what):
        g, c = out["cuda"], out["cpu"]
        same = g["mirror_mask_resolved"] == c["mirror_mask_resolved"]
        assert same.any(), (mode, what)
        errs = {}
        for k in ("rgb_fine", "depth_fine", "rgb_fine_reflect",
                  "depth_fine_reflect"):
            errs[k] = np.abs(g[k] - c[k]).reshape(n, -1).max(-1)[same]
        log(f"[apps] mode {mode}{what} card vs plain CPU, {n} rays: "
            f"level-0 mirror mask agrees on {100 * same.mean():.2f}% "
            f"(mirror fraction {float(c['mirror_mask_resolved'].mean()):.3f}"
            f"); there max abs err " + ", ".join(
                f"{k} {e.max():.2e} (median {np.median(e):.1e}, "
                f"{100 * (e <= RENDER_ATOL).mean():.1f}% within "
                f"{RENDER_ATOL})" for k, e in errs.items()))
        assert same.mean() >= 0.99, (mode, what, same.mean())
        return max(float(e.max()) for e in errs.values())

    out, deep = run(flags)
    err = compare(out, "")
    if not deep:
        assert err <= RENDER_ATOL, (mode, err)
        return None
    levels = (out["cuda"]["_deep_levels"], out["cpu"]["_deep_levels"])
    log(f"[apps] mode {mode}: deep trace to level {levels[0]} on the card, "
        f"{levels[1]} on the CPU")
    assert levels[0] == levels[1], levels
    out5, _ = run(flags + ["--max_recursive_level", "5"])
    err = compare(out5, " at 5 levels")
    assert err <= RENDER_ATOL, (mode, err)
    return _deep_vs_float64(torch, flags, sub)


def phase_applications(torch, card: str) -> dict:
    """(19) The four applications (run.sh modes 3, 4 with both guests, 5,
    52, 6) on the CP grid at full width with --fused_field, from phase 7's
    trained last.ckpt.npz. Returns each kernel's launches on this path."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.eval.apps import run_view
    from mirror_nerf_tpu_torch.ops import fused_cp, fused_hash, fused_mlp_t
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.train.checkpoints import save_pytree

    train_dir = WORK / "train"
    ckpt = str(next(train_dir.glob("logs/*_smoke/last.ckpt.npz")))
    work = WORK / "apps"
    _write_guests(torch, work / "guests")
    # phase 7's scene under the name of run.sh's default scene, whose
    # presets the applications take: the new mirror the plane x = 0, the
    # guest object at scale 2
    scene = work / "livingroom"
    scene.symlink_to(train_dir / "scene", target_is_directory=True)

    def flags(mode, normal=True):
        fl = EVAL_FLAGS + [a.replace("GUESTS", str(work / "guests"))
                           .replace("CKPT", ckpt) for a in APP_MODES[mode]]
        fl += ["--ckpt_path", ckpt, "--root_dir", str(scene)]
        return fl if normal else [f for f in fl if f != "--predict_normal"]

    counts = {"composite": 0, "train_fwd": 0, "flagship": 0, "hash": 0}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # the eval CLI, run.sh's flags at phase 7's 64×64 scene
        for mode in APP_MODES:
            fused_cp.launches = 0
            t0 = time.perf_counter()
            out = eval_main(flags(mode) + ["--img_wh", "64", "64", "--split",
                                           "test", "--exp_name",
                                           f"smoke_app{mode}"])
            n = fused_cp.launches
            with open(os.path.join(out, "psnr.json")) as f:
                table = json.load(f)
            assert np.isfinite(table["psnrs"]).all(), (mode, table)
            assert "rgb_fine_000.png" in os.listdir(out), mode
            assert n > 0, f"mode {mode}: the eval CLI never launched"
            counts["composite"] += n
            log(f"[apps] eval CLI mode {mode}: test PSNR "
                f"{table['mean_psnr']:.2f} (phase 7's checkpoint), "
                f"COMPOSITE launches {n}, {time.perf_counter() - t0:.1f} s")
        # one 800×800 view per application (COMPOSITE), then a 128×128 one
        # without --predict_normal (∇σ: the train forward)
        rays_np = _view_rays(800)
        small_np = _view_rays(128)
        for mode in APP_MODES:
            progress = APP_PROGRESS.get(mode, 0.0)
            for normal, rays, size in ((True, rays_np, "800x800"),
                                       (False, small_np, "128x128")):
                ctx = _app_ctx(torch, flags(mode, normal) + [
                    "--img_wh", size.split("x")[0], size.split("x")[1]],
                    "cuda")
                fused_cp.launches = fct.launches_fwd = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run_view(ctx, {"rays": rays}, progress, 0)
                wall = time.perf_counter() - t0
                n = (fused_cp.launches, fct.launches_fwd)
                for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved",
                          "rgb_fine_reflect"):
                    assert res[k].shape[0] == len(rays), (mode, k)
                    assert np.isfinite(res[k]).all(), (mode, k)
                assert n[0 if normal else 1] > 0, (mode, normal, n)
                counts["composite"] += n[0]
                counts["train_fwd"] += n[1]
                log(f"[apps] mode {mode}, {size} view"
                    + ("" if normal else " without --predict_normal (∇σ)")
                    + f", progress {progress}: {wall:.3f} s -> "
                    f"{len(rays) / wall:.1f} rays/s ({card}); launches "
                    f"COMPOSITE {n[0]}, train forward {n[1]}; mirror "
                    f"fraction {float(res['mirror_mask_resolved'].mean()):.4f}"
                    + (f"; deep trace to level {ctx.deep_levels}"
                       if ctx.deep else ""))
        c1 = {}
        for mode in APP_MODES:
            c1[mode] = _app_vs_plain(torch, mode, flags(mode), rays_np,
                                     APP_PROGRESS.get(mode, 0.0))
        # C1: the card's distance to float64 at level 50 grows no more than
        # the CPU's: its kernels start ~3x the CPU's fp32 distance at level
        # 0 (both ~1e-7), and a fault of the card's would widen that ratio
        # bounce by bounce
        d = c1["3"]
        assert d["card"] <= max(d["ratio0"], 1.0) * 1.5 * d["cpu"], d
        _guest_drawn(torch, flags("4_d_nerf"), rays_np)

        # mode 3 for the flagship at 400×300 and the hash grid (fused) at
        # 64×64, seeded weights
        mode3 = APP_MODES["3"] + ["--root_dir", str(scene)]
        cfg_flags = NERF_EVAL_FLAGS + mode3 + ["--img_wh", "400", "300"]
        ctx = _app_ctx(torch, cfg_flags, "cuda")
        ctx.params = {k: _sigma_scaled(v, 5.0) for k, v in
                      ctx.params.items()}
        fused_mlp_t.launches = 0
        t0 = time.perf_counter()
        rays = _view_rays(400, 300)
        res = run_view(ctx, {"rays": rays})
        wall = time.perf_counter() - t0
        counts["flagship"] = fused_mlp_t.launches
        assert counts["flagship"] > 0 and np.isfinite(res["rgb_fine"]).all()
        log(f"[apps] mode 3, flagship 400x300 view (seeded, σ column "
            f"|w|·5): {wall:.3f} s -> {len(rays) / wall:.1f} rays/s "
            f"({card}); "
            f"flagship kernel launches {counts['flagship']}; deep trace to "
            f"level {ctx.deep_levels}")
        ngp = _app_ctx(torch, NGP_EVAL_FLAGS + ["--fused_field"] + mode3,
                       "cpu")
        save_pytree("ngp.npz", {k: _dense_scaled(ngp.field, _all_mirror(v))
                                for k, v in ngp.params.items()})
        fused_hash.launches = 0
        out = eval_main(NGP_EVAL_FLAGS + ["--fused_field"] + mode3 + [
            "--img_wh", "64", "64", "--split", "test", "--ckpt_path",
            "ngp.npz", "--exp_name", "smoke_app3_ngp"])
        counts["hash"] = fused_hash.launches
        with open(os.path.join(out, "psnr.json")) as f:
            table = json.load(f)
        assert counts["hash"] > 0 and np.isfinite(table["mean_psnr"]), table
        log(f"[apps] mode 3, hash grid --fused_field eval CLI (all-mirror, "
            f"dense levels ×1e4): test PSNR {table['mean_psnr']:.2f}, fused "
            f"NGP composite launches {counts['hash']}")
        log(f"[apps] launches on the applications' path: {counts}")
        return counts
    finally:
        os.chdir(cwd)


# run.sh's lounge preset (real_arkit, near 0.05, far 8, 480×360, bound 6;
# scale_factor 1 for nerf_tpu) and mode 2's flags, the box filled in by
# phase 20
LOUNGE = ["--dataset_name", "real_arkit", "--near", "0.05", "--far", "8",
          "--scale_factor", "1", "--img_wh", "480", "360", "--bound", "6"]
MESH_FLAGS = ["--model_type", "nerf_tpu", "--predict_normal",
              "--predict_mirror_mask", "--trace_secondary_rays",
              "--N_importance", "64", "--N_grid", "256", "--color_mesh"]
# the mesh's face counts phase 20 accepts at --sigma_threshold 20; outside
# them it takes the σ quantile that gives a count inside (host memory of
# the numpy marching tetrahedra)
MESH_FACES = (1e5, 5e6)


def _with(flags: list, **values) -> list:
    """`flags` with each --name's value replaced."""
    out = list(flags)
    for k, v in values.items():
        out[out.index(f"--{k}") + 1] = v
    return out


def _faces_estimate(sigma, thr: float) -> float:
    """Faces of the iso-surface at thr, from the grid edges it crosses
    (about two faces an edge crossing on the 6-tetrahedra split)."""
    import numpy as np

    inside = sigma > thr
    return 2.0 * sum(float((np.diff(inside, axis=a) != 0).sum())
                     for a in range(3))


def _pick_threshold(sigma):
    """(threshold, why): run.sh's --sigma_threshold 20 when its mesh has
    MESH_FACES faces, else the first quantile of the positive σ, from the
    top, whose mesh has; None when none has."""
    import numpy as np

    if MESH_FACES[0] <= _faces_estimate(sigma, 20.0) <= MESH_FACES[1]:
        return 20.0, "run.sh's 20"
    pos = sigma[sigma > 0]
    for q in (0.999, 0.995, 0.99, 0.98, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5,
              0.4, 0.3, 0.2, 0.1):
        thr = float(np.quantile(pos, q)) if pos.size else 0.0
        if MESH_FACES[0] <= _faces_estimate(sigma, thr) <= MESH_FACES[1]:
            return thr, f"the positive σ's quantile {q}"
    return None


class _HostPeak:
    """The largest resident set of this process while the `with` block
    runs, sampled every 20 ms from /proc/self/status (the kernel's own
    peak, VmHWM, can only be reset through /proc/self/clear_refs, which a
    container may refuse)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while True:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.peak = max(self.peak, int(line.split()[1]))
            if self._stop.wait(0.02):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @property
    def gib(self) -> float:
        return self.peak / 2 ** 20


def _sigma_card_vs_cpu(torch, field, params: dict, n: int, box, chunk: int,
                       tag: str) -> float:
    """A σ grid through `query_sigma_grid` on the card against the same on
    the CPU (the plain version), max|Δ| / max(1, max|σ|)."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval.mesh import query_sigma_grid

    got = query_sigma_grid(field, params, n, *box, chunk=chunk,
                           device="cuda")
    want = query_sigma_grid(field, torch.utils._pytree.tree_map(
        lambda t: t.cpu(), params), n, *box, chunk=chunk, device="cpu")
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want)
                                                           .max()))
    log(f"[mesh] {tag}: σ grid {n}³ card vs plain CPU, max |Δ| / "
        f"max(1, max σ) {err:.2e} (bar {KERNEL_ATOL}); σ in "
        f"[{want.min():.3g}, {want.max():.3g}], {100 * (want > 0).mean():.1f}"
        f" % above 0")
    assert err <= KERNEL_ATOL, (tag, err)
    return err


def phase_real_capture_and_mesh(torch, card: str) -> dict:
    """(20) A generated capture in the ARKit layout at the lounge preset's
    geometry through the train CLI (real_arkit, one short epoch), its
    checkpoint through the mesh CLI with mode 2's flags at --N_grid 256 in
    both color modes, a COLMAP capture through the eval CLI, and the σ
    routes and the vertex colors card against CPU. Returns each kernel's
    launches on this path."""
    import numpy as np

    from mirror_nerf_tpu_torch.data.real_arkit import RealDatasetARKit
    from mirror_nerf_tpu_torch.data.synthetic import (generate_scene_arkit,
                                                      generate_scene_colmap,
                                                      trace_gt)
    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.eval.cli import init_params
    from mirror_nerf_tpu_torch.eval.mesh import (query_sigma_grid, read_ply,
                                                 sigma_route, vertex_normals)
    from mirror_nerf_tpu_torch.mesh import cli as mesh_cli
    from mirror_nerf_tpu_torch.models.fields import (MirrorNeRFField,
                                                     make_field)
    from mirror_nerf_tpu_torch.models.ngp import NGPField
    from mirror_nerf_tpu_torch.ops import fused_cp, fused_mlp, hashgrid
    from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
    from mirror_nerf_tpu_torch.train.cli import main as train_main

    work = WORK / "mesh"
    work.mkdir(parents=True)
    counts = {"composite": 0, "train_fwd": 0, "train_bwd": 0, "points": 0,
              "encode": 0}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        generate_scene_arkit("lounge", n_train=3, n_val=1, n_test=1,
                             img_wh=(480, 360))
        generate_scene_colmap("colmap", n_images=3, img_wh=(64, 48))
        log(f"[mesh] captures written (ARKit 3 + 1 + 1 frames at 480x360, "
            f"COLMAP 3 at 64x48): {time.perf_counter() - t0:.1f} s")

        # train: run.sh mode 0's nerf_tpu flags, one (geometry) epoch
        flags = _with(TRAIN_FLAGS, dataset_name="real_arkit", num_epochs="1")
        fct.launches_fwd = fct.launches_bwd = 0
        t0 = time.perf_counter()
        tr = train_main(flags + ["--root_dir", "lounge", "--img_wh", "480",
                                 "360", "--scale_factor", "1",
                                 "--exp_name", "lounge"])
        wall = time.perf_counter() - t0
        vals = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "val_metrics.jsonl"))]
        assert np.isfinite(vals[-1]["loss"]) and fct.launches_bwd > 0
        counts["train_fwd"] += fct.launches_fwd
        counts["train_bwd"] += fct.launches_bwd
        log(f"[mesh] train CLI on the real_arkit capture (3 views at "
            f"480x360, one geometry epoch, {tr.global_step} steps): "
            f"{wall:.1f} s, {vals[-1]['rays_per_sec']:.1f} rays/s at batch "
            f"1024 ({card}); val psnr {vals[-1]['val_psnr']:.2f}; train "
            f"kernel launches fwd {fct.launches_fwd}, bwd {fct.launches_bwd}")
        ckpt = os.path.join(tr.workdir, "last.ckpt.npz")

        # the box: ±0.15 (mode 2's size) around the room's wall where the
        # ray of the val view's pixel nearest its centre outside the mirror
        # (GT mask 0) meets it (the generator's exact depth), in the
        # capture's centred frame; if the trained field has no surface
        # there yet (one epoch), around the field's densest point on that
        # ray
        ds = RealDatasetARKit("lounge", "val", (480, 360),
                              mesh_cli.get_opt(LOUNGE)[0])
        cfg, _ = mesh_cli.get_opt(LOUNGE + MESH_FLAGS + ["--ckpt_path",
                                                         ckpt])
        field = make_field(cfg)
        params = init_params(field, cfg, "cuda")
        val = ds.get_image(0)
        yx = np.argwhere(val["mirror_mask"].reshape(360, 480) == 0)
        px = yx[np.argmin(((yx - [180, 240]) ** 2).sum(-1))]
        ray = val["rays"][px[0] * 480 + px[1]]
        avg = np.eye(4)
        avg[:3] = ds.pose_avg
        wall_depth = float(trace_gt((avg @ np.append(ray[:3], 1.0))[None, :3],
                                    (avg[:3, :3] @ ray[3:6])[None])[2][0])
        t = np.linspace(ray[6], ray[7], 4096, dtype=np.float32)
        pts = ray[None, :3] + t[:, None] * ray[None, 3:6]
        with torch.no_grad():
            on_ray = sigma_route(field, params["fine"], "cuda")[1](
                torch.from_numpy(pts).cuda()).cpu().numpy()
        picked = None
        for where, depth in (("the room's wall", wall_depth),
                             ("the field's densest point on the ray",
                              float(t[int(np.argmax(on_ray))]))):
            c = ray[:3] + ray[3:6] * depth
            box = [(float(v - 0.15), float(v + 0.15)) for v in c]
            sigma = query_sigma_grid(field, params["fine"], 256, *box,
                                     chunk=cfg.chunk, device="cuda")
            picked = _pick_threshold(sigma)
            log(f"[mesh] val view pixel {tuple(int(v) for v in px)} "
                f"(outside the mirror): {where} at depth {depth:.4f} (the "
                f"wall's {wall_depth:.4f}), {c.round(4)}: σ in the box "
                f"[{sigma.min():.3g}, {sigma.max():.3g}], "
                f"{'a' if picked else 'no'} threshold for "
                f"{MESH_FACES[0]:.0e}–{MESH_FACES[1]:.0e} faces")
            if picked:
                break
        assert picked, "no box on the ray holds a surface of the field"
        thr, which = picked
        base = LOUNGE + MESH_FLAGS + [
            "--root_dir", "lounge", "--ckpt_path", ckpt, "--exp_name",
            "lounge_mesh"] + sum(([f"--{a}_range", str(lo), str(hi)]
                                  for a, (lo, hi) in zip("xyz", box)), [])
        log(f"[mesh] box {[tuple(round(v, 4) for v in b) for b in box]}: σ "
            f"in [{sigma.min():.3g}, {sigma.max():.3g}], median "
            f"{np.median(sigma):.3g}; --sigma_threshold {thr:.6g} "
            f"({which}; an estimated {_faces_estimate(sigma, thr):.0f} "
            f"faces)")
        mesh_dir = None
        for normal in (True, False):
            fused_cp.launches = fct.launches_fwd = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _HostPeak() as host:
                r = mesh_cli.extract(*mesh_cli.get_opt(
                    base + ["--sigma_threshold", str(thr)]
                    + (["--use_vertex_normal"] if normal else [])))
            wall = time.perf_counter() - t0
            mesh_dir = r["dir"]
            n = (fct.launches_fwd, fused_cp.launches)
            assert r["vertices"] > 0 and r["faces"] > 0, r
            assert n[0] > 0 and n[1] > 0, n
            assert r["routes"] == {"sigma": "CP train forward, density only",
                                   "colors_fused": True}, r["routes"]
            for f in ("lounge_mesh.ply", "noise_free.ply",
                      "lounge_mesh_colored.ply"):
                assert os.path.getsize(os.path.join(mesh_dir, f)) > 0, f
            counts["train_fwd"] += n[0]
            counts["composite"] += n[1]
            mode = "vertex-normal" if normal else "multi-view"
            log(f"[mesh] mesh CLI, {mode} colors, --N_grid 256: "
                f"{wall:.1f} s; σ query "
                f"{r['sigma_s']:.3f} s, {r['points_per_s']:.4g} points/s, "
                f"train forward launches {n[0]}; marching tetrahedra "
                f"{r['marching_s']:.2f} s, largest cluster "
                f"{r['cluster_s']:.2f} s, PLY {r['ply_s']:.2f} s (host); "
                f"colors {r['color_s']:.2f} s, {r['color_rays']} rays, "
                f"{r['color_rays_per_s']:.4g} rays/s, COMPOSITE launches "
                f"{n[1]}; {r['vertices']} vertices, {r['faces']} faces; "
                f"peak host {host.gib:.2f} GiB (resident), device "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                f"({card})")

        # card against CPU: the CP σ grid on a 32³ box, the hash grid
        # (ENCODE) and the flagship (points mode) at 128³ from seeded
        # weights (their card runs drive those models' σ route through the
        # mesh's entry, `query_sigma_grid`: the launches count), the
        # vertex-normal colors on 256 vertices
        _sigma_card_vs_cpu(torch, field, params["fine"], 32, box, cfg.chunk,
                           "CP grid (train forward), phase 20's checkpoint")
        g = torch.Generator().manual_seed(20)
        hf = NGPField(bound=6.0)
        hp = _dense_scaled(hf, hf.init(g))
        hp = torch.utils._pytree.tree_map(lambda t: t.cuda(), hp)
        hashgrid.launches_encode = 0
        _sigma_card_vs_cpu(torch, hf, hp, 128, box, cfg.chunk,
                           "hash grid (ENCODE), seeded, dense levels x1e4")
        counts["encode"] = hashgrid.launches_encode
        mf = MirrorNeRFField()
        mp = _sigma_scaled(mf.init(g), 5.0)
        mp = torch.utils._pytree.tree_map(lambda t: t.cuda(), mp)
        fused_mlp.launches_points = 0
        _sigma_card_vs_cpu(torch, mf, mp, 128, box, cfg.chunk,
                           "flagship (points mode), seeded, σ column |w|·5")
        counts["points"] = fused_mlp.launches_points
        assert counts["encode"] > 0 and counts["points"] > 0, counts
        verts, tris, _ = read_ply(os.path.join(mesh_dir, "noise_free.ply"))
        normals = vertex_normals(verts, tris)
        sel = np.arange(0, len(verts), max(len(verts) // 256, 1))[:256]
        rays = mesh_cli.vertex_normal_rays(verts[sel], normals[sel], ds.near,
                                           ds.far, 1.0)
        rgb = {dev: mesh_cli.vertex_normal_rgb(
            cfg, field, init_params(field, cfg, dev), rays, dev)
            for dev in ("cuda", "cpu")}
        err = float(np.abs(rgb["cuda"] - rgb["cpu"]).max())
        log(f"[mesh] vertex-normal colors on {len(sel)} vertices, card "
            f"(fused composite) vs plain CPU: max abs err {err:.2e} (bar "
            f"{RENDER_ATOL})")
        assert err <= RENDER_ATOL, err

        # a COLMAP capture through the eval CLI: one view of its test path
        fused_cp.launches = 0
        t0 = time.perf_counter()
        out = eval_main(_with(EVAL_FLAGS, dataset_name="real_colmap") + [
            "--root_dir", "colmap", "--img_wh", "64", "48", "--ckpt_path",
            ckpt, "--split", "test", "--only_eval_idx", "0", "--exp_name",
            "colmap_view"])
        assert "rgb_fine_000.png" in os.listdir(out), out
        assert fused_cp.launches > 0
        counts["composite"] += fused_cp.launches
        log(f"[mesh] eval CLI on the real_colmap capture (its spheric test "
            f"path, one 64x48 view): {time.perf_counter() - t0:.1f} s, "
            f"COMPOSITE launches {fused_cp.launches}")
        log(f"[mesh] launches on the real-capture and mesh path: {counts}")
        return counts
    finally:
        os.chdir(cwd)


# ---- phase 21: the remaining optimizer, precision and metric options ----

# RAdam / Ranger: the updates compared card against CPU (ρ crosses 5
# between 5 and 6; lookahead syncs at 6 and 12)
OPT_STEPS = (1, 5, 6, 12)
# bf16 outputs on two devices: within 4·2⁻⁷ of the output's scale, and the
# card's RMS distance from the fp32 evaluation within 1.5× the CPU's; where
# the CPU's is bf16's (over 10× the card's fp32 field's), at least 0.5× the
# CPU's and over 10× the card's fp32 field's (a card that skipped the casts
# fails there)
BF16_BAR = 4 * 2.0 ** -7
BF16_RATIO = 1.5
BF16_FLOOR = 0.5
BF16_SEEN = 10.0
# LPIPS: the card against the CPU, both fp32 (cuDNN's TF32 pinned off)
LPIPS_ATOL = 1e-5
# phase 21's generated scene: 3 train views of this size
OPTIONS_WH = ("64", "64")
# the kernels whose launches phase 21's paths add, by the counters that
# count them
OPTION_COUNTERS = {"composite": ("fused_cp", "launches"),
                   "train_fwd": ("fused_cp_train", "launches_fwd"),
                   "train_bwd": ("fused_cp_train", "launches_bwd"),
                   "flagship": ("fused_mlp_t", "launches"),
                   "encode": ("hashgrid", "launches_encode"),
                   "bwd": ("hashgrid", "launches_bwd"),
                   "bwd2": ("hashgrid", "launches_bwd2")}


def _counted(totals: dict, fn, *a, **kw):
    """fn(*a, **kw) as a path run: each counter of OPTION_COUNTERS set to 0
    just before it and read just after, into `totals`."""
    import importlib

    mods = {k: importlib.import_module(f"mirror_nerf_tpu_torch.ops.{m}")
            for k, (m, _) in OPTION_COUNTERS.items()}
    for k, (_, attr) in OPTION_COUNTERS.items():
        setattr(mods[k], attr, 0)
    out = fn(*a, **kw)
    for k, (_, attr) in OPTION_COUNTERS.items():
        totals[k] += getattr(mods[k], attr)
    return out


def _opt_tensors(opt) -> list:
    """The optimizer state's tensors (radam/ranger: μ, ν, slow weights;
    adam, sgd: torch's per-parameter state)."""
    if opt.opt is None:
        return opt.mu + opt.nu + (opt.slow or [])
    return [v for st in opt.opt.state.values() for k, v in st.items()
            if k != "step"]


def _optim_card_vs_cpu(torch) -> None:
    """(21) RAdam and Ranger (--grid_lr_mult 20, coarse 1) on the CP
    field's parameters at config.py widths: updates 1–12 on the card and
    on the CPU, each from the same state (the CPU's, copied to the card)
    and gradients; after updates 1, 5, 6 and 12 every parameter and state
    array within 1e-6 of its scale."""
    import numpy as np

    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                         params_to_numpy,
                                                         tree_leaves)
    from mirror_nerf_tpu_torch.train.optim import Optimizer

    f = TPUGridField(bound=6.0)
    g = torch.Generator().manual_seed(0)
    p0 = params_to_numpy({"coarse": f.init(g), "fine": f.init(g)})
    for name in ("radam", "ranger"):
        cfg = Config(optimizer=name, lr=5e-4, grid_lr_mult=20.0,
                     coarse_grid_lr_mult=1.0)
        trees, opts = {}, {}
        for dev in ("cpu", "cuda"):
            trees[dev] = params_from_numpy(p0, dev)
            for x in tree_leaves(trees[dev]):
                x.requires_grad_(True)
            opts[dev] = Optimizer(cfg, trees[dev], 24)
        gen = torch.Generator().manual_seed(1)
        worst = []
        for step in range(1, 13):
            with torch.no_grad():
                for a, b in zip(tree_leaves(trees["cuda"]),
                                tree_leaves(trees["cpu"])):
                    a.copy_(b)
            opts["cuda"].load_state_arrays(opts["cpu"].state_arrays(step - 1))
            grads = [torch.randn(x.shape, generator=gen)
                     for x in tree_leaves(trees["cpu"])]
            for dev, opt in opts.items():
                opt.zero_grad()
                for x, gr in zip(tree_leaves(trees[dev]), grads):
                    x.grad = gr.to(dev)
                opt.step(step - 1)
            if step not in OPT_STEPS:
                continue
            got = opts["cuda"].state_arrays(step)
            want = opts["cpu"].state_arrays(step)
            err = max(float(np.abs(np.asarray(got[k], np.float64)
                                   - want[k]).max())
                      / max(float(np.abs(want[k]).max()), 1e-30)
                      for k in want)
            err = max([err] + [_rel(b, a.detach().cpu()) for a, b in zip(
                tree_leaves(trees["cuda"]), tree_leaves(trees["cpu"]))])
            worst.append(err)
            assert all(x.is_cuda for x in _opt_tensors(opts["cuda"]))
        log(f"[options] {name} update card vs CPU at updates "
            f"{list(OPT_STEPS)} (CP field, config.py widths, grid_lr_mult "
            f"20, coarse 1): max|a−b|/scale {[f'{e:.1e}' for e in worst]}")
        assert max(worst) <= 1e-6, (name, worst)


def _train_run(torch, totals: dict, flags: list, tag: str):
    """(21) One train CLI run on phase 21's scene: finite logs, parameters
    and optimizer state on the card. Returns the Trainer and its
    reflection epoch's rate."""
    import numpy as np

    from mirror_nerf_tpu_torch.train.checkpoints import tree_leaves
    from mirror_nerf_tpu_torch.train.cli import main as train_main

    t0 = time.perf_counter()
    before = dict(totals)
    tr = _counted(totals, train_main, flags)
    wall = time.perf_counter() - t0
    recs = [json.loads(x) for x in open(os.path.join(tr.workdir,
                                                     "metrics.jsonl"))]
    vals = [json.loads(x) for x in open(os.path.join(tr.workdir,
                                                     "val_metrics.jsonl"))]
    for r in recs + vals:
        for k, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), (tag, k, r)
    assert all(x.is_cuda for x in tree_leaves(tr.params))
    assert all(x.is_cuda for x in _opt_tensors(tr.opt)), tag
    run = {k: totals[k] - before[k] for k in totals if totals[k] > before[k]}
    log(f"[options] {tag}: {tr.global_step} steps, {wall:.1f} s; losses "
        f"{[round(v['loss'], 4) for v in vals]}, val psnr "
        f"{[round(v['val_psnr'], 2) for v in vals]}, "
        f"{vals[-1]['rays_per_sec']:.1f} rays/s at batch 1024 (the last "
        f"epoch after its first step); launches {run}")
    return tr, vals[-1]["rays_per_sec"]


def _eval_run(torch, totals: dict, flags: list, tag: str) -> dict:
    """(21) One eval CLI run: a finite PSNR; returns its launches."""
    import numpy as np

    from mirror_nerf_tpu_torch.eval import main as eval_main

    before = dict(totals)
    out = _counted(totals, eval_main, flags)
    with open(os.path.join(out, "psnr.json")) as f:
        table = json.load(f)
    assert np.isfinite(table["mean_psnr"]), table
    run = {k: totals[k] - before[k] for k in totals if totals[k] > before[k]}
    log(f"[options] {tag} through the eval CLI: test PSNR "
        f"{table['mean_psnr']:.2f}; launches {run}")
    return run


def _bf16_fields_card_vs_cpu(torch, card: str) -> None:
    """(21) Each field's bf16 density, color and heads at config.py widths
    on 65,536 points: the card against the CPU within BF16_BAR of the
    output's scale, and the card's RMS distance from the fp32 evaluation
    within BF16_RATIO of the CPU's and, where the CPU rounds the output to
    bf16, at least BF16_FLOOR of it and over BF16_SEEN × the card's fp32
    field's."""
    import numpy as np

    from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
    from mirror_nerf_tpu_torch.models.ngp import NGPField
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.train.checkpoints import _map

    rng = np.random.default_rng(5)
    n = 65536
    x = torch.from_numpy(rng.uniform(-5.9, 5.9, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    for name, cls, kw in (("nerf", MirrorNeRFField, {}),
                          ("nerf_tcnn", NGPField, dict(bound=6.0)),
                          ("nerf_tpu", TPUGridField, dict(bound=6.0))):
        f32, f16 = cls(**kw), cls(**kw, compute_dtype="bfloat16")
        params = f32.init(torch.Generator().manual_seed(2))
        if name == "nerf_tcnn":
            params["grid"] = params["grid"] * 1e4
        geo = torch.from_numpy(rng.normal(size=(n, 256 if name == "nerf"
                                                else 15)).astype(np.float32))

        def outs(field, dev):
            p = _map(params, lambda _, v: v.to(dev))
            s, gf = field.density(p, x.to(dev))
            o = {"sigma": s, "geo": gf.float(),
                 "color": field.color(p, geo.to(dev), d.to(dev)),
                 "normal": field.normal_head(p, geo.to(dev)),
                 "mirror": field.mirror_head(p, geo.to(dev))}
            return {k: v.detach().cpu().double() for k, v in o.items()}

        dev, cpu, ref = outs(f16, "cuda"), outs(f16, "cpu"), outs(f32, "cpu")
        dev32 = outs(f32, "cuda")
        msg = []
        for k in ref:
            scale = float(cpu[k].abs().max()) + 1e-30
            dist = float((dev[k] - cpu[k]).abs().max()) / scale
            e_card = float(((dev[k] - ref[k]) ** 2).mean().sqrt())
            e_cpu = float(((cpu[k] - ref[k]) ** 2).mean().sqrt())
            e_32 = float(((dev32[k] - ref[k]) ** 2).mean().sqrt())
            msg.append(f"{k} {dist:.1e} ({e_card:.2e}/{e_cpu:.2e}/"
                       f"{e_32:.2e})")
            assert dist <= BF16_BAR, (name, k, dist)
            assert e_card <= BF16_RATIO * e_cpu + 1e-7 * scale, (
                name, k, e_card, e_cpu)
            if e_cpu > BF16_SEEN * e_32:  # the CPU rounds this output
                assert e_card >= max(BF16_FLOOR * e_cpu, BF16_SEEN * e_32), (
                    name, k, e_card, e_cpu, e_32)
        log(f"[options] bf16 {name} fields, card vs CPU ({card}): max|a−b|"
            f"/scale (RMS from fp32, card/CPU/card fp32): "
            + ", ".join(msg))


def _bf16_step_profiles(torch, card: str, root: str) -> dict:
    """(21) Reflection-stage steps (`step_profile`) of the flagship and the
    hash grid in fp32, bf16 and bf16 with --fp32_sigma_grad, in turns
    (fp32, bf16, fsg, fsg, bf16, fp32) from the same seeded weights: ms a
    step, rays/s, summed device time, GEMM share, idle share. Returns a
    hash-grid Trainer (bf16) for the profiling check."""
    sys.path.insert(0, str(ROOT / "tools"))
    from profile_train_torch import gemm_share, step_profile

    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train.cli import get_opt
    from mirror_nerf_tpu_torch.train.loop import Trainer

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    variants = {"fp32": [], "bf16": ["--compute_dtype", "bfloat16"],
                "bf16+fp32_sigma_grad": ["--compute_dtype", "bfloat16",
                                         "--fp32_sigma_grad"]}
    order = ["fp32", "bf16", "bf16+fp32_sigma_grad",
             "bf16+fp32_sigma_grad", "bf16", "fp32"]
    keep = None
    for model in ("nerf", "nerf_tcnn"):
        trainers = {}
        for v, extra in variants.items():
            cfg, _ = get_opt(_model_train_flags(model) + extra + [
                "--root_dir", root, "--img_wh", *OPTIONS_WH])
            ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
            trainers[v] = (Trainer(cfg, ds, str(WORK / "options" / "prof"
                                                / f"{model}_{v}"), "cuda"),
                           cfg)
        runs = {v: [] for v in variants}
        for v in order:
            tr, cfg = trainers[v]
            runs[v].append(step_profile(tr, cfg, "cuda", acts))
        for v, rs in runs.items():
            log(f"[options] {model} reflection-stage step, {v}, batch 1024 "
                f"({card}), two runs in turns: "
                + "; ".join(f"{r['ms_per_step']:.2f} ms/step "
                            f"({r['rays_per_s']:.1f} rays/s), summed device "
                            f"{r['device_ms_per_step']:.3f} ms, GEMMs "
                            f"{100 * gemm_share(r):.1f} %, idle "
                            f"{r['idle_share']:.4f}" for r in rs))
            assert all(r["events_per_step"] > 0 for r in rs)
        if model == "nerf_tcnn":
            keep = trainers["bf16"]
    return keep


def _lpips_weights(torch, path_npz: Path, path_pth: Path) -> None:
    """Seeded AlexNet and lin weights (He scale) in the npz layout and as a
    torch state dict with torchvision and lpips keys."""
    import numpy as np

    rng = np.random.default_rng(7)
    w, sd = {}, {}
    for i, (fi, cin, cout, k) in enumerate(
            ((0, 3, 64, 11), (3, 64, 192, 5), (6, 192, 384, 3),
             (8, 384, 256, 3), (10, 256, 256, 3))):
        w[f"conv{i}/w"] = (rng.normal(size=(cout, cin, k, k))
                           * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
        w[f"conv{i}/b"] = (rng.normal(size=cout) * 0.05).astype(np.float32)
        w[f"lin{i}/w"] = rng.uniform(0, 0.5, size=cout).astype(np.float32)
        sd[f"features.{fi}.weight"] = w[f"conv{i}/w"]
        sd[f"features.{fi}.bias"] = w[f"conv{i}/b"]
        sd[f"lin{i}.model.1.weight"] = w[f"lin{i}/w"].reshape(1, -1, 1, 1)
    np.savez(path_npz, **w)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path_pth)


def _lpips_check(torch, card: str, work: Path, scene: str, ckpt: str):
    """(21) LPIPS on seeded weights in both layouts: an 800×800 pair on the
    card (the process's TF32 flags turned on around it: the module pins
    fp32) against the CPU within LPIPS_ATOL, its ms; `metrics.lpips` with
    no device argument on the card; then the eval CLI in a
    subprocess with torch's default backend flags and $LPIPS_WEIGHTS set:
    each view's score, and mean_lpips, equal the CPU's on the same images
    within LPIPS_ATOL."""
    import textwrap

    import numpy as np

    from mirror_nerf_tpu_torch.eval import lpips as tl

    npz, pth = work / "lpips.npz", work / "alex.pth"
    _lpips_weights(torch, npz, pth)
    rng = np.random.default_rng(8)
    a = rng.uniform(size=(800, 800, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    for path in (npz, pth):
        cpu = tl.lpips_from_file(a, b, str(path), "cpu")
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = tl.lpips_from_file(a, b, str(path), "cuda")
            w = tl._CACHE[(os.path.abspath(path), "cuda")]
            ms = _time_ms(torch, lambda: tl.lpips_forward(w, a, b), 5, 2)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        log(f"[options] LPIPS 800x800 ({path.suffix}): card {got:.7f}, CPU "
            f"{cpu:.7f}, |a−b| {abs(got - cpu):.1e}; {ms:.2f} ms a pair "
            f"on the card (host images in, score out; {card})")
        assert np.isfinite(got) and abs(got - cpu) <= LPIPS_ATOL, (got, cpu)
    # a call with no device argument scores on the card
    from mirror_nerf_tpu_torch.eval.metrics import lpips as lpips_metric

    tl._CACHE.clear()
    got = lpips_metric(a, b, str(npz))
    assert [k[1] for k in tl._CACHE] == ["cuda"], list(tl._CACHE)
    assert next(iter(tl._CACHE.values()))["conv0/w"].is_cuda
    assert abs(got - tl.lpips_from_file(a, b, str(npz), "cpu")) \
        <= LPIPS_ATOL, got
    log(f"[options] LPIPS with no device argument: weights on "
        f"{next(iter(tl._CACHE.values()))['conv0/w'].device}, score {got:.7f}")
    out_json = work / "lpips_cli.json"
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        assert torch.backends.cudnn.allow_tf32  # torch's default flags
        from mirror_nerf_tpu_torch.eval import cli, metrics
        real, seen = metrics.lpips, []
        def spy(pred, gt, weights_path=None, device="cuda"):
            v = real(pred, gt, weights_path, device)
            seen.append([v, real(pred, gt, weights_path, "cpu"),
                         str(device)])
            return v
        metrics.lpips = spy
        out = cli.main({EVAL_FLAGS + ["--root_dir", scene, "--img_wh",
                                      *OPTIONS_WH, "--split", "test",
                                      "--ckpt_path", ckpt, "--exp_name",
                                      "lpips"]!r})
        json.dump({{"out": out, "seen": seen}}, open({str(out_json)!r}, "w"))
    """)
    env = dict(os.environ, LPIPS_WEIGHTS=str(npz))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=str(work), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.load(open(out_json))
    table = json.load(open(work / res["out"] / "psnr.json"))
    cpu = [s[1] for s in res["seen"]]
    assert all(s[2].startswith("cuda") for s in res["seen"]), res["seen"]
    assert len(table["lpips"]) == len(cpu) >= 1, (table, res)
    diff = max(abs(x - y) for x, y in zip(table["lpips"], cpu))
    mean_diff = abs(table["mean_lpips"] - float(np.mean(cpu)))
    log(f"[options] the eval CLI in a subprocess (torch's default flags, "
        f"$LPIPS_WEIGHTS): mean_lpips {table['mean_lpips']:.7f}, CPU "
        f"{np.mean(cpu):.7f} on the same images, max |a−b| a view "
        f"{diff:.1e}; {time.perf_counter() - t0:.1f} s")
    assert diff <= LPIPS_ATOL and mean_diff <= LPIPS_ATOL, (table, cpu)


def _encoders_check(torch, card: str, totals: dict) -> None:
    """(21) sh_encode at degree 8 on the card against the CPU;
    get_encoder("hashgrid") and ("tiledgrid") at their defaults (16 levels,
    2¹⁹ rows, 2048) through ENCODE on 262,144 points, the launch counter
    read around each, against the plain version within 1e-5 scaled above
    1; an encoder ENCODE lacks (input_dim 2) raises on the card."""
    import numpy as np

    from mirror_nerf_tpu_torch.models.encoding import get_encoder
    from mirror_nerf_tpu_torch.ops.hashgrid import hashgrid_encode_reference
    from mirror_nerf_tpu_torch.ops.sh import sh_encode

    rng = np.random.default_rng(9)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(1 << 20, 3)).astype(np.float32)), dim=-1)
    err = float((sh_encode(d.cuda(), 8).cpu() - sh_encode(d, 8)).abs().max())
    log(f"[options] sh_encode degree 8 on 1,048,576 directions, card vs "
        f"CPU: max|a−b| {err:.1e}")
    assert err <= 1e-5, err
    x = torch.from_numpy(rng.uniform(-1, 1, (1 << 18, 3)).astype(np.float32))
    for name in ("hashgrid", "tiledgrid"):
        enc, dim = get_encoder(name)
        table = enc.init(torch.Generator().manual_seed(3)) * 1e4
        before = totals["encode"]
        got = _counted(totals, lambda: enc(table.cuda(), x.cuda()))
        n = totals["encode"] - before
        x01 = (x + 1.0) * 0.5
        want = hashgrid_encode_reference(table, x01, enc.spec)
        scale = max(float(want.abs().max()), 1.0)
        e = float((got.cpu() - want).abs().max()) / scale
        log(f"[options] get_encoder({name!r}) (dim {dim}, "
            f"{enc.spec.table_rows} rows) through ENCODE: {n} launch(es), "
            f"max|a−b|/scale {e:.1e} against the plain version")
        assert n >= 1 and e <= 1e-5, (name, n, e)
    enc2, _ = get_encoder("hashgrid", input_dim=2, num_levels=4,
                          log2_hashmap_size=10)
    table2 = enc2.init(torch.Generator().manual_seed(4)).cuda()
    try:
        enc2(table2, torch.zeros(8, 2, device="cuda"))
    except NotImplementedError as e:
        assert "item 15" in str(e), e
    else:
        raise AssertionError("a 2-d hash grid did not raise on the card")


def _native_check() -> None:
    """(21) The port's native library is built and used; its three
    bindings against numpy."""
    import numpy as np

    from mirror_nerf_tpu_torch import native
    from mirror_nerf_tpu_torch.core.rays import (get_ray_directions,
                                                 get_rays, make_ray_buffer)

    t0 = time.perf_counter()
    lib = native.get_lib()
    assert lib is not None, "native library not built"
    rng = np.random.default_rng(10)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:, 3] = [0.3, -0.2, 1.1]
    o, dd = get_rays(get_ray_directions(600, 800, 700.0), c2w)
    np.testing.assert_allclose(native.generate_rays(c2w, 600, 800, 700.0,
                                                    0.05, 8.0),
                               make_ray_buffer(o, dd, 0.05, 8.0),
                               rtol=1e-5, atol=1e-6)
    rays = rng.normal(size=(100000, 8)).astype(np.float32)
    rgbs = rng.normal(size=(100000, 3)).astype(np.float32)
    masks = rng.normal(size=100000).astype(np.float32)
    idx = rng.integers(0, 100000, 1024)
    for a, b in zip(native.gather_batch(rays, rgbs, masks, idx),
                    (rays[idx], rgbs[idx], masks[idx])):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (480000, 4)).astype(np.uint8)
    rgb, valid = native.blend_rgba(img)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(rgb, f[:, :3] * f[:, 3:4] + (1 - f[:, 3:4]),
                               atol=1e-6)
    np.testing.assert_array_equal(valid, img[:, 3] > 0)
    log(f"[options] native library {native.library_path().name} built and "
        f"loaded; generate_rays (800x600), gather_batch, blend_rgba match "
        f"numpy ({time.perf_counter() - t0:.1f} s, the build included)")


def _profiling_check(torch, trainer_cfg, work: Path) -> None:
    """(21) utils/profiling.trace around one train step writes a Chrome
    trace holding the card's kernels."""
    sys.path.insert(0, str(ROOT / "tools"))
    from profile_train_torch import stepper

    from mirror_nerf_tpu_torch.utils.profiling import trace

    tr, cfg = trainer_cfg
    step = stepper(tr, cfg, "cuda")
    step()
    with trace(str(work / "trace")):
        step()
    events = json.load(open(work / "trace" / "trace.json"))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"[options] utils/profiling.trace around one hash-grid train step: "
        f"{len(events)} events, {len(kernels)} CUDA kernel events")
    assert kernels, "no CUDA kernel event in the trace"


def phase_remaining_options(torch, card: str) -> dict:
    """(21) RAdam and Ranger, --compute_dtype bfloat16 with and without
    --fp32_sigma_grad for the three models, LPIPS, the encoders, native
    and profiling, on a generated 64×64 scene at config.py widths. Returns
    each kernel's launches on these paths."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene

    t_start = time.perf_counter()
    work = WORK / "options"
    work.mkdir(parents=True)
    totals = dict.fromkeys(OPTION_COUNTERS, 0)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        generate_scene("scene", n_train=3, n_val=1, n_test=1,
                       img_wh=tuple(int(v) for v in OPTIONS_WH))
        scene = ["--root_dir", "scene", "--img_wh", *OPTIONS_WH]
        _optim_card_vs_cpu(torch)

        # RAdam, Ranger (--grid_lr_mult 1) and its resume: the CP train CLI
        # with run.sh mode 0's nerf_tpu flags
        tr, _ = _train_run(torch, totals, _with(
            TRAIN_FLAGS, optimizer="radam") + scene + ["--exp_name", "radam"],
            "radam, CP grid, 2 epochs")
        ranger = _with(TRAIN_FLAGS, optimizer="ranger",
                       grid_lr_mult="1") + scene
        tr, _ = _train_run(torch, totals, ranger + ["--exp_name", "ranger"],
                           "ranger, CP grid, --grid_lr_mult 1, 2 epochs")
        ckpt = os.path.join(tr.workdir, "last.ckpt.npz")
        steps = tr.global_step
        tr, _ = _train_run(torch, totals, _with(ranger, num_epochs="3") + [
            "--ckpt_path", ckpt, "--exp_name", "ranger_resumed"],
            "ranger resumed from its last.ckpt.npz, epoch 3")
        assert tr.global_step > steps and tr.opt.count == tr.global_step
        ckpt = os.path.join(tr.workdir, "last.ckpt.npz")
        _eval_run(torch, totals, EVAL_FLAGS + scene + [
            "--split", "test", "--ckpt_path", ckpt, "--exp_name", "ranger"],
            "the resumed ranger checkpoint")

        # bf16: the fields, then the train CLI for each model
        _bf16_fields_card_vs_cpu(torch, card)
        bf = ["--compute_dtype", "bfloat16"]
        before = dict(totals)
        tr, _ = _train_run(torch, totals, TRAIN_FLAGS + bf + scene + [
            "--exp_name", "cp_bf16"], "bf16 CP grid, 2 epochs")
        assert totals["train_fwd"] > before["train_fwd"] and \
            totals["train_bwd"] > before["train_bwd"], totals
        _eval_run(torch, totals, EVAL_FLAGS + bf + scene + [
            "--split", "test", "--ckpt_path",
            os.path.join(tr.workdir, "last.ckpt.npz"), "--exp_name",
            "cp_bf16"], "the bf16 CP checkpoint")
        for model in ("nerf_tcnn", "nerf"):
            for fsg in ([], ["--fp32_sigma_grad"]):
                before = dict(totals)
                tr, _ = _train_run(torch, totals, _model_train_flags(
                    model) + bf + fsg + scene + [
                    "--exp_name", f"{model}_bf16{'_fsg' if fsg else ''}"],
                    f"bf16 {model}{' --fp32_sigma_grad' if fsg else ''}, "
                    "2 epochs")
                if model == "nerf_tcnn":
                    assert all(totals[k] > before[k]
                               for k in ("encode", "bwd", "bwd2")), totals
        run = _eval_run(torch, totals, NERF_EVAL_FLAGS + bf + scene + [
            "--split", "test", "--ckpt_path",
            os.path.join(tr.workdir, "last.ckpt.npz"), "--exp_name",
            "nerf_bf16"], "the bf16 flagship checkpoint (--fused_field)")
        assert run.get("flagship", 0) > 0, run
        keep = _bf16_step_profiles(torch, card, str(work / "scene"))

        _lpips_check(torch, card, work, str(work / "scene"), ckpt)
        _encoders_check(torch, card, totals)
        _native_check()
        _profiling_check(torch, keep, work)
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t_start
    log(f"[options] phase 21 launches {totals}; wall {wall:.1f} s ({card})")
    return totals


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
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    card = timed("environment", phase_environment, torch)
    timed("build", phase_build)
    entry = timed("cp kernel", phase_kernel, torch, card)
    fwd_entry, bwd_entry = timed("train kernels", phase_train_kernels,
                                 torch, card)
    timed("grad guard", phase_grad_guard, torch)
    entry["launches"] = timed("cp main path", phase_main_path, torch, card)
    (fwd_entry["launches"], bwd_entry["launches"]), rate = timed(
        "train path", phase_train_path, torch, card)
    timed("train step vs cpu", phase_step_vs_cpu, torch)
    log(f"[train] reflection-stage train-step rate at batch 1024: "
        f"{rate:.1f} rays/s ({card})")
    mlp_entry = timed("flagship kernel", phase_mlp_kernel, torch, card)
    mlp_entry["launches"] = timed("flagship main path", phase_mlp_main_path,
                                  torch, card)
    rows_entries = timed("rows kernels", phase_rows_kernels, torch, card)
    rows_entries[0]["launches"], rows_entries[2]["launches"] = timed(
        "noise path", phase_noise_path, torch, card)
    hash_entries = timed("hash kernels", phase_hash_kernels, torch, card)
    hash_entries[1]["launches"], hash_entries[0]["launches"] = timed(
        "hash-grid main path", phase_ngp_main_path, torch, card)
    probe_entries = timed("probe kernels", phase_probe_kernels, torch, card)
    bwd_entries = timed("hash-grid backward kernels",
                        phase_hash_bwd_kernels, torch, card)
    bwd_entries[0]["launches"], bwd_entries[1]["launches"] = timed(
        "hash-grid and flagship training", phase_model_training, torch,
        card)
    timed("views about the σ-gradient normal", phase_grad_normal_views,
          torch, card)
    apps = timed("applications", phase_applications, torch, card)
    # the applications' launches join each kernel's count
    for e, k in ((entry, "composite"), (fwd_entry, "train_fwd"),
                 (mlp_entry, "flagship"), (hash_entries[0], "hash")):
        e["launches"] += apps[k]
    mesh = timed("real capture and mesh", phase_real_capture_and_mesh,
                 torch, card)
    # and the real capture's and the mesh's: rows 1, 2, 3 (its train
    # CLI), 6 and 9 (ENCODE)
    for e, k in ((entry, "composite"), (fwd_entry, "train_fwd"),
                 (bwd_entry, "train_bwd"), (rows_entries[3], "points"),
                 (hash_entries[1], "encode")):
        e["launches"] += mesh[k]
    opts = timed("remaining options", phase_remaining_options, torch, card)
    # phase 21's paths: rows 1-4, ENCODE, BWD and BWD2
    for e, k in ((entry, "composite"), (fwd_entry, "train_fwd"),
                 (bwd_entry, "train_bwd"), (mlp_entry, "flagship"),
                 (hash_entries[1], "encode"), (bwd_entries[0], "bwd"),
                 (bwd_entries[1], "bwd2")):
        e["launches"] += opts[k]
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    assert "jax" not in sys.modules and "mirror_nerf_tpu" not in sys.modules
    print(json.dumps({"kernels": [entry, fwd_entry, bwd_entry, mlp_entry,
                                  *rows_entries, *hash_entries,
                                  *probe_entries, *bwd_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
