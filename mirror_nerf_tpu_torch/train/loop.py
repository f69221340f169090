"""Staged training loop (torch counterpart of `mirror_nerf_tpu/train/loop.py`).

  * geometry stage → reflection stage flip at
    `train_geometry_stage_end_epoch`, the dataset switching from masked
    frames to all frames;
  * the per-epoch loss schedule (`EpochStatics`) and the RGB blackout inside
    the mirror during the geometry stage;
  * early-epoch steps whose batch lacks GT masks are gated by loss × 0: Adam
    still steps on the zero gradients, as in the JAX package;
  * Adam + the LR schedule with grid-lr groups (train/optim.py), npz train
    checkpoints each epoch, and a chunked render for validation.

All three models train: the CP grid (`nerf_tpu`, through its train
kernels on the card), the flagship PE-MLP (`nerf`, plain PyTorch: cuBLAS on
the card, as the JAX package leaves it to XLA) and the hash grid
(`nerf_tcnn`: ENCODE, BWD and BWD2 of `csrc/hashgrid.cu` on the card, the
nets in PyTorch). One device, one optimizer step per Python call. The JAX package's TPU
workarounds are not carried over: the K-steps-per-dispatch scan
(`--steps_per_dispatch` is parsed and ignored), `jax.checkpoint`
(`--use_remat` raises) and the chunk-halving retry.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..config import rescale_schedule
from ..core.mathutil import psnr as psnr_fn
from ..core.sampling import stratified_z_vals
from ..models.fields import make_field
from ..ops.cpgrid import cpgrid_tv_loss
from ..render.renderer import RenderSettings
from ..render.tracer import TraceSettings, trace_rays
from .checkpoints import (load_optimizer_state, load_pytree_nonstrict,
                          load_train_ckpt, params_from_numpy, params_to_numpy,
                          save_train_ckpt, tree_leaves)
from .losses import (draw_plane_tuples, make_loss_settings,
                     novel_ray_regularization, total_loss)
from .optim import Optimizer


def resolve_fine_pass(cfg, epoch: int) -> str:
    """only_one_field / N_importance semantics (reference
    rendering.py:309-360)."""
    if cfg.N_importance <= 0:
        return "none"
    if cfg.only_one_field:
        return "coarse" if epoch > cfg.only_one_field_fine_epoch else "none"
    return "fine"


def make_trace_settings(cfg, epoch: int, geometry_stage: bool,
                        is_eval: bool, device,
                        test_time: bool = False) -> TraceSettings:
    dev = torch.device(device)
    if cfg.fused_train == "on" and dev.type != "cuda":
        raise ValueError("--fused_train on needs a CUDA device: the fused "
                         "density kernels have no CPU mode")
    # "auto" engages the kernels for nerf_tpu on the card, and there also
    # for the validation render (is_eval): its σ-gradient runs through the
    # forward kernel, a forward-only call of the same autograd.Function
    # under no_grad. The JAX package renders its validation unfused; the
    # values are the same — this is a dispatch choice, not a feature.
    fused_density = cfg.fused_train == "on" or (
        cfg.fused_train == "auto" and cfg.model_type == "nerf_tpu"
        and dev.type == "cuda")
    rs = RenderSettings(
        N_samples=cfg.N_samples,
        N_importance=cfg.N_importance,
        use_disp=cfg.use_disp,
        perturb=0.0 if cfg.for_vis else cfg.perturb,
        noise_std=0.0 if cfg.for_vis else cfg.noise_std,
        white_back=False,
        test_time=test_time,
        compute_normal=cfg.trace_secondary_rays,
        fine_pass=resolve_fine_pass(cfg, epoch),
        detach_density_outside_mirror_for_mask_loss=(
            cfg.detach_density_outside_mirror_for_mask_loss),
        detach_density_for_mask_loss=cfg.detach_density_for_mask_loss,
        detach_density_for_normal_loss=cfg.detach_density_for_normal_loss,
        fused_density=fused_density,
        fp32_sigma_grad=cfg.fp32_sigma_grad,
        proposal_skip=cfg.train_proposal_skip,
        sigma_activation=cfg.sigma_activation,
    )
    return TraceSettings(
        render=rs,
        trace_secondary_rays=cfg.trace_secondary_rays and not geometry_stage,
        max_recursive_level=cfg.max_recursive_level,
        only_trace_mode="eval" if test_time else "train",
        only_trace_rays_in_mirrors=cfg.only_trace_rays_in_mirrors,
        detach_normal_in_reflection=cfg.detach_normal_in_reflection,
        detach_ref_color_for_blend=(
            cfg.detach_ref_color_for_blend
            and epoch >= cfg.train_geometry_stage_end_epoch + 1),
        is_eval=is_eval,
        compact_frac=(cfg.compact_frac if cfg.only_trace_rays_in_mirrors
                      else 1.0),
    )


def check_compaction_overflow(aux: dict, compact_frac: float,
                              tol: float = 0.01) -> None:
    """Hard-fail when secondary-ray compaction dropped more than `tol` of
    the step's mirror rays: training without those reflections silently
    collapses quality. `aux` carries the step's summed counters."""
    n_drop = aux.get("compact_dropped", 0.0)
    n_mirror = aux.get("compact_mirror", 0.0)
    if n_drop > tol * max(n_mirror, 1.0):
        raise RuntimeError(
            f"secondary-ray compaction overflow: {n_drop:.0f} of "
            f"{n_mirror:.0f} mirror rays dropped this step "
            f"(compact_frac={compact_frac}). Training with dropped "
            "reflections silently collapses quality: raise --compact_frac "
            "(1.0 disables compaction) or use a scene with a smaller "
            "mirror fraction.")


@dataclass(frozen=True)
class EpochStatics:
    """The epoch-dependent switches of one train step."""

    geometry_stage: bool
    fine_pass: str
    enable_mask_loss: bool
    enable_plane_loss: bool
    enable_normal_losses: bool
    detach_ref_blend: bool
    gate_invalid_mask_steps: bool
    enable_novel_reg: bool = False

    @classmethod
    def of(cls, cfg, epoch: int, geometry_stage: bool) -> "EpochStatics":
        return cls(
            geometry_stage=geometry_stage,
            fine_pass=resolve_fine_pass(cfg, epoch),
            enable_mask_loss=(not geometry_stage)
            or epoch >= cfg.train_mirror_mask_start_epoch,
            enable_plane_loss=epoch >= cfg.smooth_mirror_start_epoch,
            enable_normal_losses=(not geometry_stage)
            or epoch >= cfg.train_normal_start_epoch,
            detach_ref_blend=epoch >= cfg.train_geometry_stage_end_epoch + 1,
            gate_invalid_mask_steps=epoch <= cfg.train_mirror_mask_start_epoch,
            enable_novel_reg=(cfg.novel_ray_batch > 0
                              and epoch >= cfg.novel_ray_start_epoch),
        )


class Trainer:
    """Data shuffling, stage flips and train steps on one device.

    `params` (optional) are the initial parameters as a tree of arrays or
    tensors (e.g. another run's, carried over by the npz bridge); by default
    they are drawn from a generator seeded with `cfg.seed`."""

    def __init__(self, cfg, dataset, workdir: str, device="cuda",
                 params: Optional[dict] = None):
        if cfg.num_gpus > 1:
            raise NotImplementedError(
                "multi-device training is not ported yet: ROADMAP.md queue "
                "1, item 9 (torch.distributed data parallel)")
        if cfg.use_remat:
            raise NotImplementedError(
                "--use_remat is not ported yet: ROADMAP.md queue 1, item 8 "
                "(torch.utils.checkpoint around the traced render)")
        self.device = torch.device(device)
        self.dataset = dataset
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.field = make_field(cfg)
        self.steps_per_epoch = max(len(dataset.all_rays) // cfg.batch_size, 1)
        # epoch-indexed knobs rescaled to this dataset (no-op when unset)
        cfg = rescale_schedule(cfg, self.steps_per_epoch)
        self.cfg = cfg

        if params is None:
            g = torch.Generator().manual_seed(cfg.seed)
            params = {"coarse": self.field.init(g)}
            if cfg.N_importance > 0 and not cfg.only_one_field:
                params["fine"] = self.field.init(g)
        self.params = params_from_numpy(params_to_numpy(params), self.device)
        self.global_step = 0
        self.start_epoch = 0
        if cfg.ckpt_path:
            self.params, self.global_step, self.start_epoch = \
                load_train_ckpt(cfg.ckpt_path, self.params)
        elif cfg.weight_path:
            self.params = load_pytree_nonstrict(
                cfg.weight_path, self.params, cfg.prefixes_to_ignore)
        for leaf in tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.opt = Optimizer(cfg, self.params, self.steps_per_epoch)
        if cfg.ckpt_path:
            load_optimizer_state(cfg.ckpt_path, self.opt)
        # draws the perturbation, σ noise, plane tuples, novel-ray jitter
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._buffers: dict = {}
        self._metrics_path = os.path.join(workdir, "metrics.jsonl")

    # ---- one step ----

    def settings(self, statics: EpochStatics):
        """(TraceSettings, LossSettings) of a train step."""
        cfg = self.cfg
        # the epoch reaches the settings only through the statics
        epoch = 0 if statics.geometry_stage else 10**6
        ts = make_trace_settings(cfg, epoch, statics.geometry_stage,
                                 is_eval=False, device=self.device)
        ts = replace(
            ts, render=replace(ts.render, fine_pass=statics.fine_pass),
            detach_ref_color_for_blend=(cfg.detach_ref_color_for_blend
                                        and statics.detach_ref_blend))
        ls = replace(make_loss_settings(cfg, statics.geometry_stage, epoch),
                     enable_mask_loss=statics.enable_mask_loss,
                     enable_plane_loss=statics.enable_plane_loss,
                     enable_normal_losses=statics.enable_normal_losses)
        return ts, ls

    def loss_and_aux(self, statics: EpochStatics, batch: dict):
        """The scheduled loss of one batch (differentiable) and its aux
        values (detached tensors on the device)."""
        cfg, field, params, g = self.cfg, self.field, self.params, \
            self.generator
        ts, ls = self.settings(statics)
        rays, rgbs, mask = batch["rays"], batch["rgbs"], batch["mirror_mask"]
        mask_all_valid = (mask >= 0).all()
        if statics.geometry_stage and not cfg.woMaskRGBtoBlack:
            # black out the GT color inside the mirror (train.py:410-416)
            rgbs = torch.where(mask_all_valid & (mask > 0.5)[:, None],
                               torch.zeros_like(rgbs), rgbs)
        batch_in = {**batch, "rgbs": rgbs}

        results = trace_rays(field, params, rays, mask, ts, g)
        plane_idx = None
        if ls.enable_plane_loss and ls.use_plane_consistent_loss:
            plane_idx = draw_plane_tuples(mask, ls.plane_n_tuples, g)
        loss, loss_dict = total_loss(ls, results, batch_in, plane_idx)
        if statics.enable_novel_reg:
            nr = rays[:cfg.novel_ray_batch]
            o_noise = torch.randn(nr[:, 0:3].shape, generator=g,
                                  dtype=nr.dtype, device=nr.device)
            z = stratified_z_vals(nr[:, 6:7], nr[:, 7:8], cfg.N_samples,
                                  False, 1.0, g)
            nv = cfg.novel_ray_loss_weight * novel_ray_regularization(
                field, params, nr, o_noise, z, cfg.novel_pose_jitter,
                fused=ts.render.fused_density,
                sigma_act=ts.render.sigma_activation)
            loss = loss + nv
            loss_dict["novel_ray_reg"] = nv
        if cfg.cp_tv_loss_weight > 0 and cfg.model_type == "nerf_tpu":
            tv = cfg.cp_tv_loss_weight * sum(
                cpgrid_tv_loss(params[m]["grid"]) for m in params)
            loss = loss + tv
            loss_dict["cp_tv"] = tv
        if statics.gate_invalid_mask_steps:
            # early epochs skip batches without GT masks (train.py:405-408)
            # by gating the loss to zero; the optimizer still steps
            loss = torch.where(mask_all_valid, loss, torch.zeros_like(loss))
        typ = "fine" if "rgb_fine" in results else "coarse"
        aux = {"psnr": psnr_fn(results[f"rgb_{typ}"], rgbs),
               **loss_dict}
        if "rgb_coarse" in results:  # absent under train_proposal_skip
            aux["psnr_coarse"] = psnr_fn(results["rgb_coarse"], rgbs)
        if "compact_dropped" in results:
            aux["compact_dropped"] = results["compact_dropped"].sum()
            aux["compact_mirror"] = (results["mirror_mask_resolved"]
                                     > 0.5).to(torch.float32).sum()
        aux["loss"] = loss
        return loss, {k: v.detach() for k, v in aux.items()}

    def train_step(self, statics: EpochStatics, batch: dict) -> dict:
        """One optimizer step on one batch; returns the aux tensors. The
        backward runs for the parameters only: no gradient of the sample
        positions that the σ-gradient normal differentiated (the hash
        grid's BWD then skips its dx01)."""
        loss, aux = self.loss_and_aux(statics, batch)
        self.opt.zero_grad()
        loss.backward(inputs=self.opt.leaves)
        self.opt.step(self.global_step)
        self.global_step += 1
        return aux

    # ---- epochs ----

    def stage_for_epoch(self, epoch: int) -> bool:
        return (self.cfg.train_geometry_stage
                and epoch < self.cfg.train_geometry_stage_end_epoch)

    def _train_buffers(self):
        """The stage's (rays, rgbs, masks) on the device, uploaded once."""
        arrays = self.dataset.train_buffers()
        key = tuple(id(a) for a in arrays)
        if key not in self._buffers:
            self._buffers = {key: [torch.from_numpy(np.ascontiguousarray(
                a, np.float32)).to(self.device) for a in arrays]}
        return self._buffers[key]

    def run_epoch(self, epoch: int, np_rng: np.random.Generator,
                  log_every: int = 50) -> dict:
        cfg = self.cfg
        geometry_stage = self.stage_for_epoch(epoch)
        if hasattr(self.dataset, "train_geometry_stage"):
            self.dataset.train_geometry_stage = geometry_stage
        rays, rgbs, masks = self._train_buffers()
        statics = EpochStatics.of(cfg, epoch, geometry_stage)
        # the same permutation as the JAX package's loop for the same seed
        perm = np_rng.permutation(rays.shape[0])
        n_steps = rays.shape[0] // cfg.batch_size
        last_aux: dict = {}
        t0, t_skip = time.perf_counter(), 0
        for s in range(n_steps):
            idx = torch.from_numpy(
                perm[s * cfg.batch_size:(s + 1) * cfg.batch_size]).to(
                    self.device)
            aux = self.train_step(statics, {"rays": rays[idx],
                                            "rgbs": rgbs[idx],
                                            "mirror_mask": masks[idx]})
            if s == 0:
                # steady-state rate: the clock starts after the first step
                # (allocator warm-up, kernel builds); reading a value waits
                float(aux["loss"])
                t0, t_skip = time.perf_counter(), 1
            if (s + 1) % max(log_every, 1) == 0 or s + 1 == n_steps:
                last_aux = {k: float(v) for k, v in aux.items()}
                check_compaction_overflow(last_aux, cfg.compact_frac)
                last_aux["lr"] = self.opt.schedule(self.global_step)
                self._log({"epoch": epoch, "step": self.global_step,
                           "stage": "geometry" if geometry_stage else "full",
                           **last_aux})
        dt = time.perf_counter() - t0  # the last log point synchronized
        last_aux["rays_per_sec"] = (max(n_steps - t_skip, 1) * cfg.batch_size
                                    / max(dt, 1e-9))
        last_aux["epoch_wall_s"] = dt
        return last_aux

    def save(self, epoch: int) -> None:
        """`last.ckpt.npz` and `epoch={epoch}.ckpt.npz` (resume at
        epoch + 1)."""
        for name in ("last.ckpt.npz", f"epoch={epoch}.ckpt.npz"):
            save_train_ckpt(os.path.join(self.workdir, name), self.params,
                            self.opt, self.global_step, epoch + 1)

    def fit(self, on_epoch_end=None) -> dict:
        np_rng = np.random.default_rng(self.cfg.seed)
        final: dict = {}
        for epoch in range(self.start_epoch, self.cfg.num_epochs):
            final = self.run_epoch(epoch, np_rng)
            self.save(epoch)
            if on_epoch_end is not None:
                on_epoch_end(self, epoch, final)
        return final

    def _log(self, record: dict) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")


@torch.no_grad()
def render_image_chunked(field, params: dict, rays: np.ndarray,
                         mirror_mask: Optional[np.ndarray],
                         ts: TraceSettings, chunk: int, device,
                         generator: Optional[torch.Generator] = None,
                         keys=("rgb_fine", "rgb_coarse", "depth_fine",
                               "depth_coarse", "mirror_mask_resolved")
                         ) -> dict:
    """Render any number of rays through fixed-size chunks of `trace_rays`
    (the tail chunk padded by repeating its last ray); numpy out."""
    n = rays.shape[0]
    if mirror_mask is None:
        mirror_mask = np.full((n,), -1.0, np.float32)
    rays_t = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(
        device)
    mask_t = torch.from_numpy(np.ascontiguousarray(mirror_mask,
                                                   np.float32)).to(device)
    outs: dict = {}
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        r, m = rays_t[start:end], mask_t[start:end]
        pad = chunk - (end - start)
        if pad:
            r = torch.cat([r, r[-1:].expand(pad, -1)])
            m = torch.cat([m, m[-1:].expand(pad)])
        res = trace_rays(field, params, r, m, ts, generator)
        for k in keys:
            if k in res:
                outs.setdefault(k, []).append(res[k][:end - start])
    return {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
