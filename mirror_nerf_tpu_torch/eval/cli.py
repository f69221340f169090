"""The port's evaluation CLI: `python -m mirror_nerf_tpu_torch.eval`.

The same flags as the JAX package's `eval.py` and the same result tree
under `results/<dataset>/<exp_name>/`: per-view rgb / depth / mirror-mask /
normal / depth-reflect / x_surface PNGs, GIFs, a globally normalized depth
pass, and `psnr.json` with per-view and mean PSNR/SSIM. It prints the
steady-state render rate (views after the first) in rays/s.

All three models render: the CP grid (`--model_type nerf_tpu`), the
flagship PE-MLP (`nerf`, the default) and the hash-grid model
(`nerf_tcnn`). `--fused_field` runs each through its eval kernel with
in-kernel compositing: the hash-grid model through the fused NGP composite
(ops/fused_hash.py: its levels, nets and compositing in one kernel; a spec
the kernel lacks raises on the card). Without the flag the hash-grid model
encodes through ENCODE (csrc/hashgrid.cu) and runs its small nets and the
compositing in PyTorch, as the JAX package runs them on XLA. `--ckpt_path`
takes an npz (either package's) or a reference torch Lightning `.ckpt` of
the PE-MLP or the hash-grid (MirrorNeRFTcnn) layout. `--device` (default
`cuda`) picks where parameters and rays live; a CUDA run goes through the
port's kernels, a CPU run through their plain versions.

The four applications run with the reference's flags (eval/apps.py):
`--app_place_new_mirror --plane_pos plane_x|plane_y` (run.sh mode 3, a
50-level trace through `eval_trace_deep`), `--app_reflect_newly_placed_objects
--obj_ckpt_path <D-NeRF .tar | nerf_pl .ckpt> --obj_model_type d_nerf|nerf_pl`
(mode 4; the guest's time is the view's index over the split's size),
`--app_control_mirror_roughness --trace_ray_times T --normal_noise_std s
[--normal_noise_std_changes]` (modes 5, 52) and
`--app_reflection_substitution --substitution_ckpt_path <ckpt>` (mode 6).
With `$LPIPS_WEIGHTS` naming a weight file (eval/lpips.py), LPIPS(alex)
joins PSNR and SSIM: each finite per-view score is kept, `Mean LPIPS` is
printed and `mean_lpips` / `lpips` go into `psnr.json`, as the JAX
package's eval.py writes them; without a usable file there is no score.
Not ported: `--megabatch` and `--proposal_drop_levels` (TPU workarounds).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def get_opt(argv=None):
    from ..config import add_common_args, config_from_namespace

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--only_eval_idx", type=int, default=-1)
    parser.add_argument("--not_save_depth", default=False, action="store_true")
    parser.add_argument("--depth_format", type=str, nargs="+", default=["png"])
    parser.add_argument("--render_coarse_rgb", default=False,
                        action="store_true")
    # the fused eval kernel with in-kernel compositing (nerf_tpu: the CP
    # composite kernel; nerf: the PE-MLP kernel; nerf_tcnn: the fused NGP
    # composite)
    parser.add_argument("--fused_field", default=False, action="store_true")
    # drop the coarse proposal pass; one fine pass on
    # N_samples + N_importance stratified samples
    parser.add_argument("--proposal_skip", default=False,
                        action="store_true")
    # reduced sample budget for secondary (bounce level >= 1) renders;
    # -1 = inherit the primary budget
    parser.add_argument("--secondary_N_samples", type=int, default=-1)
    parser.add_argument("--secondary_N_importance", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda")
    # applications
    parser.add_argument("--app_control_mirror_roughness", default=False,
                        action="store_true")
    parser.add_argument("--trace_ray_times", type=int, default=4)
    parser.add_argument("--normal_noise_std", type=float, default=0.01)
    parser.add_argument("--normal_noise_std_changes", default=False,
                        action="store_true")
    parser.add_argument("--app_reflection_substitution", default=False,
                        action="store_true")
    parser.add_argument("--substitution_ckpt_path", type=str, default=None)
    parser.add_argument("--app_place_new_mirror", default=False,
                        action="store_true")
    parser.add_argument("--plane_pos", type=str, default="plane_x",
                        choices=["plane_x", "plane_y"])
    parser.add_argument("--app_reflect_newly_placed_objects", default=False,
                        action="store_true")
    parser.add_argument("--obj_ckpt_path", type=str, default=None)
    parser.add_argument("--obj_model_type", type=str, default="d_nerf",
                        choices=["nerf_pl", "d_nerf"])
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns


def _save_png(path: str, img_u8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img_u8).save(path)


def _save_gif(path: str, frames, fps: int = 15) -> None:
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)


def init_params(field, cfg, device) -> dict:
    """Seeded initial weights (coarse seed 0, fine seed 1), or the
    checkpoint at `cfg.ckpt_path` (npz or a reference Lightning .ckpt)
    loaded into that structure."""
    import torch

    from ..train.checkpoints import load_params_any

    params = {"coarse": field.init(torch.Generator().manual_seed(0), device)}
    if cfg.N_importance > 0 and not cfg.only_one_field:
        params["fine"] = field.init(torch.Generator().manual_seed(1), device)
    if cfg.ckpt_path:
        params = load_params_any(cfg.ckpt_path, params, field)
    return params


def main(argv=None):
    cfg, args = get_opt(argv)

    import torch

    from ..data import get_dataset
    from ..data.depth_utils import save_pfm
    from ..models.fields import make_field
    from ..utils.visualization import visualize_depth
    from .apps import AppContext, run_view
    from .metrics import lpips as lpips_metric
    from .metrics import psnr as psnr_metric
    from .metrics import ssim as ssim_metric

    device = torch.device(args.device)
    w, h = cfg.img_wh
    dataset = get_dataset(cfg.dataset_name)(cfg.root_dir, args.split,
                                            cfg.img_wh, cfg)
    field = make_field(cfg)
    params = init_params(field, cfg, device)
    ctx = AppContext.build(cfg, args, field, params, device)

    dir_name = f"results/{cfg.dataset_name}/{cfg.exp_name}"
    os.makedirs(dir_name, exist_ok=True)
    sub = {}
    for name in ("depth", "depth_unified_normalization", "mirror_mask",
                 "normal", "depth_reflect",
                 "depth_reflect_unified_normalization", "x_surface"):
        sub[name] = os.path.join(dir_name, name)
        os.makedirs(sub[name], exist_ok=True)
    print(f"[info] Results saved to dir {dir_name}.")

    n_views = len(dataset)
    imgs, masks_u8, depth_maps, depth_reflect_maps, masks_float = (
        [], [], [], [], [])
    psnrs, ssims, lpipss = [], [], []
    typ_final = "coarse"
    view_secs = []  # wall seconds per view (the first carries the build)
    for i in range(n_views):
        if args.only_eval_idx >= 0 and i != args.only_eval_idx:
            continue
        sample = dataset.get_image(i)
        progress = i / max(n_views, 1)
        t0 = time.perf_counter()
        results = run_view(ctx, sample, progress, i)  # numpy: synchronized
        view_secs.append(time.perf_counter() - t0)
        if "compact_dropped" in results:
            n_drop = float(np.sum(results["compact_dropped"]))
            if n_drop > 0:
                print(f"[warn] view {i}: {n_drop:.0f} mirror rays exceeded "
                      f"the secondary-ray compaction capacity and render "
                      f"without reflections")
        typ = "fine" if "rgb_fine" in results else "coarse"
        typ_final = typ

        for t in ([typ, "coarse"] if (args.render_coarse_rgb and
                                      typ != "coarse") else [typ]):
            if f"rgb_{t}" not in results:
                continue
            img = np.clip(results[f"rgb_{t}"].reshape(h, w, 3), 0, 1)
            img_u8 = (img * 255).astype(np.uint8)
            _save_png(os.path.join(dir_name, f"rgb_{t}_{i:03d}.png"), img_u8)
            if t == typ:
                imgs.append(img_u8)
                if "rgbs" in sample:
                    gt_img = sample["rgbs"].reshape(h, w, 3)
                    psnrs.append(psnr_metric(gt_img, img))
                    ssims.append(ssim_metric(img, gt_img))
                    # NaN without weights
                    lp = lpips_metric(img, gt_img, device=device)
                    if np.isfinite(lp):
                        lpipss.append(lp)
            if not args.not_save_depth and f"depth_{t}" in results:
                dep = results[f"depth_{t}"].reshape(h, w)
                if t == typ:
                    depth_maps.append(dep)
                if "pfm" in args.depth_format:
                    save_pfm(os.path.join(sub["depth"],
                                          f"depth_{t}_{i:03d}.pfm"), dep)
                if "png" in args.depth_format:
                    _save_png(
                        os.path.join(sub["depth"], f"depth_{t}_{i:03d}.png"),
                        (visualize_depth(dep) * 255).astype(np.uint8))
                if "bytes" in args.depth_format:
                    with open(os.path.join(sub["depth"],
                                           f"depth_{t}_{i:03d}"), "wb") as f:
                        f.write(dep.tobytes())
            if f"mirror_mask_{t}" in results:
                mm = np.clip(results[f"mirror_mask_{t}"].reshape(h, w), 0, 1)
                mm3 = np.repeat(mm[..., None], 3, -1)
                if t == typ:
                    masks_float.append(mm3)
                    masks_u8.append((mm3 * 255).astype(np.uint8))
                _save_png(os.path.join(sub["mirror_mask"],
                                       f"mirror_mask_{t}_{i:03d}.png"),
                          (mm3 * 255).astype(np.uint8))
                if f"depth_{t}_reflect" in results:
                    dr = results[f"depth_{t}_reflect"].reshape(h, w)
                    if t == typ:
                        depth_reflect_maps.append(dr)
                    canvas = visualize_depth(dr) * mm3
                    _save_png(os.path.join(sub["depth_reflect"],
                                           f"depth_reflect_{t}_{i:03d}.png"),
                              (canvas * 255).astype(np.uint8))
            if f"surface_normal_{t}" in results:
                nrm = np.clip(
                    (results[f"surface_normal_{t}"].reshape(h, w, 3) + 1) / 2,
                    0, 1)
                _save_png(os.path.join(sub["normal"],
                                       f"surface_normal_{t}_{i:03d}.png"),
                          (nrm * 255).astype(np.uint8))
            if f"x_surface_{t}" in results:
                xs = results[f"x_surface_{t}"].reshape(h, w, 3)
                xs = (xs - xs.min()) / (xs.max() - xs.min() + 1e-8)
                _save_png(os.path.join(sub["x_surface"],
                                       f"x_surface_{t}_{i:03d}.png"),
                          (np.clip(xs, 0, 1) * 255).astype(np.uint8))
        print(f"[{i + 1}/{n_views}] rendered"
              + (f", psnr={psnrs[-1]:.2f}" if psnrs else ""))

    if imgs:
        _save_gif(os.path.join(dir_name,
                               f"{cfg.exp_name}_rgb_{typ_final}.gif"), imgs)
        if masks_u8:
            _save_gif(os.path.join(
                dir_name, f"{cfg.exp_name}_mirror_mask_{typ_final}.gif"),
                masks_u8)
        if depth_maps and not args.not_save_depth:
            import cv2

            arr = np.stack(depth_maps)
            norm = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-8)
            _save_gif(
                os.path.join(dir_name, f"{cfg.exp_name}_depth_{typ_final}.gif"),
                [cv2.cvtColor(cv2.applyColorMap((d * 255).astype(np.uint8),
                                                cv2.COLORMAP_JET),
                              cv2.COLOR_BGR2RGB) for d in norm])
            # second pass: globally normalized depth PNGs
            vmin, vmax = float(arr.min()), float(arr.max())
            for i, dep in enumerate(depth_maps):
                _save_png(os.path.join(sub["depth_unified_normalization"],
                                       f"depth_{typ_final}_{i:03d}.png"),
                          (visualize_depth(dep, vmin, vmax) * 255
                           ).astype(np.uint8))
        if depth_reflect_maps:
            arr = np.stack(depth_reflect_maps)
            vmin, vmax = float(arr.min()), float(arr.max())
            for i, (dr, mm) in enumerate(zip(depth_reflect_maps, masks_float)):
                canvas = visualize_depth(dr, vmin, vmax) * mm
                _save_png(os.path.join(
                    sub["depth_reflect_unified_normalization"],
                    f"depth_reflect_{typ_final}_{i:03d}.png"),
                    (canvas * 255).astype(np.uint8))
    if psnrs:
        print(f"Mean PSNR ({typ_final}): {np.mean(psnrs):.2f}")
        print(f"Mean SSIM ({typ_final}): {np.mean(ssims):.4f}")
        table = {"mean_psnr": float(np.mean(psnrs)),
                 "psnrs": [float(p) for p in psnrs],
                 "mean_ssim": float(np.mean(ssims)),
                 "ssims": [float(s) for s in ssims]}
        if lpipss:
            print(f"Mean LPIPS ({typ_final}): {np.mean(lpipss):.4f}")
            table["mean_lpips"] = float(np.mean(lpipss))
            table["lpips"] = [float(v) for v in lpipss]
        with open(os.path.join(dir_name, "psnr.json"), "w") as f:
            json.dump(table, f)
    if len(view_secs) > 1:
        # steady-state render rate (the first view pays the kernel build)
        steady = view_secs[1:]
        print(f"[time] steady-state {np.mean(steady):.2f} s/view "
              f"({h * w / np.mean(steady) / 1e3:.1f}k rays/s), "
              f"first view {view_secs[0]:.1f} s")
    return dir_name
