"""The port's training CLI: `python -m mirror_nerf_tpu_torch.train`.

The same flags as the JAX package's `train.py` (reference `opt.py`), plus
`--device cuda|cpu` (default `cuda`): a CUDA run trains through the port's
kernels, a CPU run through their plain versions. Every `--model_type`
trains: `nerf_tpu` (the CP grid's train kernels), `nerf` (the flagship
PE-MLP, plain PyTorch) and `nerf_tcnn` (the hash grid: ENCODE, BWD and
BWD2); a trained run's `last.ckpt.npz` renders through the eval CLI. A run writes
`logs/<time>_<exp_name>/`: `config.json`, `metrics.jsonl` (train losses,
PSNR, lr, every 50 steps), `val_metrics.jsonl` (val PSNR and SSIM, the
epoch's steady-state rays/s), `val_epoch{e}.png`, `last.ckpt.npz` and
`epoch={e}.ckpt.npz` (npz train checkpoints that resume in either package).
TensorBoard and the source snapshot of the JAX entry point are left out.

`--num_gpus N` (default 1, one card) trains data parallel on N ranks
(train/loop.py, parallel/mesh.py): N cards over NCCL, `cuda:0` … `cuda:N−1`
(more than the machine has raises), or with `--device cpu` N processes
over gloo. The CLI starts ranks 1 … N−1 itself; under `torchrun`
(WORLD_SIZE set) each process joins instead. Rank 0 writes the run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

VAL_KEYS = ("rgb_fine", "rgb_coarse", "depth_fine", "depth_coarse",
            "mirror_mask_fine", "mirror_mask_coarse", "rgb_fine_reflect",
            "rgb_fine_direct", "rgb_coarse_reflect", "rgb_coarse_direct",
            "surface_normal_fine", "surface_normal_grad_fine",
            "depth_fine_reflect", "depth_coarse_reflect", "secondary_rays_o",
            "reflect_direction", "x_surface_fine", "x_surface_coarse")


def get_opt(argv=None):
    from ..config import add_common_args, config_from_namespace

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns


def main(argv=None):
    """Train; returns the Trainer (its `workdir` holds the run), rank 0's
    when several ranks train."""
    cfg, args = get_opt(argv)
    from ..parallel.mesh import launch

    return launch(train, cfg.num_gpus, args.device, (cfg, args),
                  batch_size=cfg.batch_size)


def train(group, cfg, args):
    """The run on one device (`group` None) or on one rank of a group."""
    import torch

    from ..data import get_dataset
    from ..eval.metrics import psnr as psnr_metric
    from ..eval.metrics import ssim as ssim_metric
    from ..utils.visualization import save_image, visualize_val_image
    from .loop import Trainer, make_trace_settings, render_image_chunked

    device = torch.device(args.device) if group is None else group.device
    main_rank = group is None or group.is_main
    log_path = os.path.join("logs", time.strftime("%Y%m%d-%H%M%S") + "_"
                            + cfg.exp_name)
    if group is not None:
        log_path = group.broadcast_object(log_path)
    if main_rank:
        os.makedirs(log_path, exist_ok=True)
        print(f"Start with exp_name: {os.path.basename(log_path)}.")
        with open(os.path.join(log_path, "config.json"), "w") as f:
            json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f,
                      indent=1)

    ds_cls = get_dataset(cfg.dataset_name)
    train_ds = ds_cls(cfg.root_dir, "train", cfg.img_wh, cfg)
    val_ds = ds_cls(cfg.root_dir, "val", cfg.img_wh, cfg)
    trainer = Trainer(cfg, train_ds, log_path, device=device, group=group)
    cfg = trainer.cfg  # the schedule may have been rescaled

    def on_epoch_end(tr, epoch, aux):
        # validation: the fixed val image through the eval trace settings
        sample = val_ds.get_image(0)
        geometry_stage = tr.stage_for_epoch(epoch)
        ts = make_trace_settings(cfg, epoch, geometry_stage, is_eval=True,
                                 device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed + epoch)
        res = render_image_chunked(tr.field, tr.params, sample["rays"],
                                   sample["mirror_mask"], ts, cfg.chunk,
                                   device, gen, keys=VAL_KEYS,
                                   group=tr.group)
        if not main_rank:
            return
        typ = "fine" if "rgb_fine" in res else "coarse"
        rgbs = sample["rgbs"]
        if geometry_stage and (sample["mirror_mask"] >= 0).all() \
                and not cfg.woMaskRGBtoBlack:
            rgbs = np.where((sample["mirror_mask"] > 0.5)[:, None], 0.0, rgbs)
        val_psnr = psnr_metric(res[f"rgb_{typ}"], rgbs)
        w, h = cfg.img_wh
        val_ssim = ssim_metric(np.clip(res[f"rgb_{typ}"].reshape(h, w, 3),
                                       0, 1), rgbs.reshape(h, w, 3))
        print(f"[epoch {epoch}] train_psnr={aux.get('psnr', float('nan')):.2f}"
              f" val_psnr={val_psnr:.2f} val_ssim={val_ssim:.4f} "
              f"rays/s={aux.get('rays_per_sec', 0):.0f}", flush=True)
        save_image(os.path.join(log_path, f"val_epoch{epoch}.png"),
                   visualize_val_image(cfg.img_wh, sample, res))
        with open(os.path.join(log_path, "val_metrics.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch, "val_psnr": val_psnr,
                                "val_ssim": val_ssim, **aux}) + "\n")

    trainer.fit(on_epoch_end)
    return trainer
