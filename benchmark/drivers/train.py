"""Back-to-back training epochs through the port's `train/loop.py
Trainer.run_epoch` in the reflection stage.

The traffic file gives the scene: `views` poses of the camera ring at
`view_wh`, rendered by an exact one-bounce trace of a room with a mirror
on one wall (the port's `data/synthetic` room), so every pixel has a
colour and a ground-truth mirror mask that decides which rays are traced;
the epoch index whose loss schedule the steps run (`epoch`), the steps
set-up drives (`warm_steps`) and the traced run's profiler schedule. The
configuration gives the model and the train CLI's flags.

Set-up: the scene, the weights drawn on the card from the seed, one
`Trainer` as the train CLI builds it, then `warm_steps` steps through
`run_epoch` on their own rows (the step's loss, the first gradient as
Adam's first moment holds it, and the parameters after the third step are
kept for the check). The window: whole epochs over every row until
`seconds` have passed. After it the trainer is freed and the plain
reference follows the first three steps from the same seed, rows and
draws.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import roof
from .. import trace as tr
from ..reference import train as ref_train
from ..reference.weights import leaves
from .views import camera_ring, pose_rays, sub_seed

HALF = 2.5
MIRROR_HALF_W, MIRROR_HALF_H = 1.6, 1.4
SPANS = ("train_step",)
_BASE = {(0, 1): (0.85, 0.30, 0.25), (0, -1): (0.25, 0.60, 0.85),
         (1, 1): (0.90, 0.85, 0.70), (1, -1): (0.45, 0.40, 0.35),
         (2, 1): (0.35, 0.75, 0.40), (2, -1): (0.55, 0.55, 0.60)}


def _wall_hit(o, d):
    """The first wall an interior ray meets: t, axis, sign."""
    d_safe = np.where(np.abs(d) < 1e-9, 1e-9, d)
    sign = np.where(d_safe > 0, 1, -1)
    t = (sign * HALF - o) / d_safe
    t = np.where(t <= 1e-6, np.inf, t)
    axis = np.argmin(t, -1)
    pick = axis[:, None]
    return (np.take_along_axis(t, pick, -1)[:, 0], axis,
            np.take_along_axis(sign, pick, -1)[:, 0])


def _wall_color(p, axis, sign):
    out = np.zeros(p.shape[:-1] + (3,), np.float32)
    for (ax, sg), base in _BASE.items():
        sel = (axis == ax) & (sign == sg)
        u, v = (p[sel][:, a] for a in range(3) if a != ax)
        tex = 0.15 * np.sin(1.7 * u) * np.sin(2.3 * v) + 0.08 * np.sin(
            0.9 * (u + v))
        out[sel] = np.clip(np.asarray(base)[None] * (1.0 + tex[:, None]), 0,
                           1)
    return out


def room(o, d):
    """(rgb, mirror mask) of rays in the room: the wall colour, or inside
    the mirror (z = −HALF, |x| < 1.6, |y| < 1.4) the colour it reflects."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    t, axis, sign = _wall_hit(o, d)
    p = o + t[:, None] * d
    mirror = ((axis == 2) & (sign == -1) & (np.abs(p[:, 0]) < MIRROR_HALF_W)
              & (np.abs(p[:, 1]) < MIRROR_HALF_H))
    rgb = _wall_color(p, axis, sign)
    if mirror.any():
        d2 = d[mirror] * np.array([1.0, 1.0, -1.0])
        o2 = p[mirror] + 1e-6 * d2
        t2, axis2, sign2 = _wall_hit(o2, d2)
        rgb[mirror] = _wall_color(o2 + t2[:, None] * d2, axis2, sign2)
    return rgb.astype(np.float32), mirror.astype(np.float32)


class Data:
    """The train rows the Trainer reads (`all_rays`, `train_buffers`);
    `active` selects which rows an epoch runs over."""

    def __init__(self, rays, rgbs, masks):
        self.all_rays, self.all_rgbs, self.all_masks = rays, rgbs, masks
        self.active = (rays, rgbs, masks)

    def train_buffers(self):
        return self.active


def _flag(flags, name):
    return flags[flags.index(name) + 1]


def settings(cfg) -> dict:
    """The reference's knobs, read from the Trainer's resolved config."""
    return {"N_samples": cfg.N_samples, "N_importance": cfg.N_importance,
            "noise_std": cfg.noise_std, "plane_tuples": cfg.batch_size // 4,
            "novel_rays": cfg.novel_ray_batch,
            "novel_jitter": cfg.novel_pose_jitter,
            "weights": {"color": cfg.color_loss_weight,
                        "mask": cfg.mirror_mask_loss_weight,
                        "plane": cfg.plane_consistent_loss_weight,
                        "normal": cfg.normal_loss_weight,
                        "normal_reg": cfg.normal_reg_loss_weight,
                        "novel": cfg.novel_ray_loss_weight}}


def setup(cell, ref, seed: int, device) -> tuple:
    """(data, field, params0, cfg, warm_rows), all made from the seed: the
    scene, the reference field, the weights drawn on the card, the train
    CLI's config (its seed draws the Trainer's random stream), and the
    rows of the warm steps."""
    from mirror_nerf_tpu_torch.train.cli import get_opt

    w, h = cell.get("view_wh")
    flags = list(cell.get("train_flags"))
    near, far = float(_flag(flags, "--near")), float(_flag(flags, "--far"))
    rays = np.concatenate([pose_rays(c2w, w, h, near, far)
                           for c2w in camera_ring(cell.get("views"))])
    rgbs, masks = room(rays[:, 0:3], rays[:, 3:6])
    data = Data(rays, rgbs, masks)
    field = ref.Field(cell.config["field"])
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    params0 = field.init_params(gen, device)
    cfg, _ = get_opt(flags + ["--seed", str(sub_seed(seed, 3) % 2**62),
                              "--img_wh", str(w), str(h),
                              "--device", str(device)])
    rng = np.random.default_rng([seed & (2**63 - 1), 4])
    warm_rows = rng.permutation(len(rays))[:cell.get("warm_steps")
                                           * cfg.batch_size]
    return data, field, params0, cfg, warm_rows


def run(cell, ref, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    from mirror_nerf_tpu_torch.train.loop import Trainer

    data, field, params0, cfg, warm_rows = setup(cell, ref, seed, device)
    workdir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        return _run(cell, field, data, params0, cfg, Trainer, seed, seconds,
                    trace, device, t_process, workdir, warm_rows)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def readings(cell, ref, seed: int, device) -> tuple:
    """The check's readings of the program for this seed without a window:
    set-up's warm steps, then the reference (the controls' and the limits'
    lower readings; the benchmark's runs do not call it)."""
    from mirror_nerf_tpu_torch.train.loop import Trainer

    data, field, params0, cfg, warm_rows = setup(cell, ref, seed, device)
    workdir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        trainer, prog, _, _ = warm(cell, data, params0, cfg, Trainer, seed,
                                   device, workdir, warm_rows)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del trainer
    gc.collect()
    r = reference_steps(field, data, params0, cfg, seed, warm_rows, device)
    return (compare(prog, r, params0, cell.config["limits"]["train"]),
            figures(prog, r, params0))


def _first_moment(trainer, leaf) -> torch.Tensor:
    """Adam's first moment of a leaf (zeros where it holds none)."""
    m = trainer.opt.opt.state.get(leaf, {}).get("exp_avg")
    return torch.zeros_like(leaf) if m is None else m


def warm(cell, data, params0, cfg, Trainer, seed, device, workdir,
         warm_rows) -> tuple:
    """One `Trainer` as the train CLI builds it, driven from the seed's
    weights through `warm_steps` steps of `run_epoch` on their own rows;
    returns it, the first three steps' readings (losses, the first
    gradient's norms as Adam's first moment holds it, the leaves after the
    third step), and the step wrapper with its hooks, for the profiler."""
    data.active = tuple(a[warm_rows] for a in (data.all_rays, data.all_rgbs,
                                               data.all_masks))
    trainer = Trainer(cfg, data, workdir, device=device, params=params0)
    losses, state = [], {}
    step_hook = []

    def train_step(statics, b):
        with torch.profiler.record_function("train_step"):
            aux = Trainer.train_step(trainer, statics, b)
        k = len(losses)
        if k < 3:
            losses.append(aux["loss"].clone())
            if k == 0:
                state["g1"] = {p: _first_moment(trainer, x) / 0.1
                               for p, x in leaves(trainer.params)}
            if k == 2:
                state["p3"] = {p: x.detach().clone()
                               for p, x in leaves(trainer.params)}
        for hook in step_hook:
            hook()
        return aux

    trainer.train_step = train_step
    trainer.run_epoch(cell.get("epoch"),
                      np.random.default_rng([seed & (2**63 - 1), 5]))
    del trainer.train_step  # the window runs the Trainer's own step
    prog = {"losses": [float(x) for x in losses],
            "g1": {p: float(v.norm()) for p, v in state["g1"].items()},
            "p3": state["p3"]}
    return trainer, prog, train_step, step_hook


def _run(cell, field, data, params0, cfg, Trainer, seed, seconds, trace,
         device, t_process, workdir, warm_rows) -> dict:
    batch = cfg.batch_size
    epoch = cell.get("epoch")
    trainer, prog, train_step, step_hook = warm(
        cell, data, params0, cfg, Trainer, seed, device, workdir, warm_rows)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    data.active = (data.all_rays, data.all_rgbs, data.all_masks)
    epoch_rng = np.random.default_rng([seed & (2**63 - 1), 6])
    perms = []
    t_start = time.perf_counter()
    while True:
        state_before = epoch_rng.bit_generator.state
        trainer.run_epoch(epoch, epoch_rng)
        probe = np.random.default_rng()
        probe.bit_generator.state = state_before
        perms.append(probe.permutation(len(data.all_rays)))
        t1 = time.perf_counter()
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    steps = len(perms) * (len(data.all_rays) // batch)
    obs = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "steps": steps, "rays_done": steps * batch}
    obs["window_work"] = work(cell, cfg, data, perms)

    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        wait, warmup, active = cell.get("trace_schedule")
        prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=wait, warmup=warmup, active=active, repeat=1),
            on_trace_ready=lambda p: obs.__setitem__(
                "trace", tr.reduce(tr.export_events(p), SPANS,
                                   "between_steps")))
        step_hook.append(prof.step)
        trainer.train_step = train_step
        with prof:
            trainer.run_epoch(epoch, epoch_rng)
        del trainer.train_step
        step_hook.clear()
        obs["traced_steps"] = active
    obs["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    obs["checks"] = check(cell, field, data, params0, cfg, seed, warm_rows,
                          prog, device)
    obs.update(attempted=steps, failed=0)
    return obs


def work(cell, cfg, data, perms) -> tuple:
    """The step work the inputs need, (operations, bytes), summed over the
    window's steps: every sample a step evaluates, forward once and
    backward twice (its input and weight gradients): level 0's 64 + 128
    samples a ray, level 1's for the rays whose ground truth is a mirror
    (the others are blended out), the novel rays' σ-only samples, and the
    ∇σ pass on level 0's samples (σ-only, its backward once and that
    backward's own backward twice). Recomputation is not counted. Bytes:
    each step's rows once and the parameters read and written once."""
    per = {"mlp": roof.mlp_sample_flop, "hash": roof.hash_sample_flop}[
        cell.config["work"]]
    s = cfg.N_samples + (cfg.N_samples + cfg.N_importance)
    batch = cfg.batch_size
    flop = nbytes = 0.0
    for perm in perms:
        live = data.all_masks[perm].reshape(-1, batch).sum(-1)
        n_steps = len(live)
        full = (batch + live) * s
        flop += float(np.sum(3 * full * per(False)
                             + 3 * batch * s * per(True)))
        flop += n_steps * 3.0 * cfg.novel_ray_batch * cfg.N_samples * per(
            True)
        nbytes += n_steps * batch * (8 + 3 + 1) * 4.0
    return flop, nbytes


def reference_steps(field, data, params0, cfg, seed, warm_rows, device,
                    prec: str = "fp32", rows_kept: float = 1.0) -> dict:
    """The reference's first three steps from the seed's weights, on the
    warm rows in the warm epoch's order and with the Trainer's draws: each
    step's loss, each leaf's first-gradient norm, the leaves after the
    third step. `prec` and `rows_kept` (the share of each batch whose mean
    the loss takes) plant the control's lower precision and the
    half-batch fault."""
    batch = cfg.batch_size
    st = settings(cfg)
    rows = warm_rows[np.random.default_rng(
        [seed & (2**63 - 1), 5]).permutation(len(warm_rows))]
    g = torch.Generator(device=device)
    g.manual_seed(cfg.seed)
    fresh = {p: x.detach().clone().requires_grad_(True)
             for p, x in leaves(params0)}
    tree = _rebuild(params0, fresh)
    names = list(fresh)
    adam = ref_train.Adam([fresh[p] for p in names], cfg.lr, cfg.adam_eps)
    losses, g1, gs = [], None, []
    for k in range(3):
        idx = rows[k * batch:(k + 1) * batch][:int(batch * rows_kept)]
        b = {key: torch.from_numpy(a[idx]).to(device) for key, a in
             (("rays", data.all_rays), ("rgbs", data.all_rgbs),
              ("mirror_mask", data.all_masks))}
        loss, _ = ref_train.step_loss(field, tree, b, g, st, prec)
        grads = torch.autograd.grad(loss, [fresh[p] for p in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(fresh[p]) if gr is None else gr
                 for p, gr in zip(names, grads)]
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = {p: float(gr.norm()) for p, gr in zip(names, grads)}
        gs.append(dict(zip(names, grads)))
        adam.step([fresh[p] for p in names], grads)
    return {"losses": losses, "g1": g1, "grads": gs,
            "p3": {p: fresh[p].detach() for p in names}}


def check(cell, field, data, params0, cfg, seed, warm_rows, prog,
          device) -> dict:
    """`compare`'s readings between `prog` and the reference's first
    three steps, beside their limits; `figures`' numbers on standard
    error."""
    r = reference_steps(field, data, params0, cfg, seed, warm_rows, device)
    for k, v in figures(prog, r, params0).items():
        print(f"[train] figure {k} {v!r}", file=sys.stderr)
    return compare(prog, r, params0, cell.config["limits"]["train"])


def _rebuild(tree, new: dict, path=()):
    """`tree`'s structure with each leaf taken from `new` by its path."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, new, path + (i,)) for i, v in enumerate(tree)]
    return new[path]


MOVED = 1e-3  # of the median leaf's first-gradient norm: a leaf's floor


def _moved(ref: dict) -> list:
    """The leaves the reference moves: first-gradient norm at least a
    thousandth of the median leaf's (the others move by round-off alone
    under Adam)."""
    med = float(np.median(list(ref["g1"].values())))
    return [p for p, v in ref["g1"].items() if v >= MOVED * med]


def _leaf_gaps(prog: dict, ref: dict, p0: dict) -> dict:
    """Each moved leaf's gap of change norms after three steps, |‖Δprog‖ −
    ‖Δref‖|, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    norms = {p: (float((prog["p3"][p] - p0[p]).norm()),
                 float((ref["p3"][p] - p0[p]).norm())) for p in _moved(ref)}
    med = float(np.median([r for _, r in norms.values()]))
    return {p: abs(a - b) / max(b, med, 1e-30) for p, (a, b) in
            norms.items()}


def compare(prog: dict, ref: dict, params0: dict, limits: dict) -> dict:
    """The train check's readings beside their limits: the relative gap of
    the first step's loss; the largest gap of a leaf's first-gradient
    norm, against the reference's norm of that leaf or of the median leaf,
    whichever is larger; the gap of the median leaf's change after three
    steps; and the worst leaf's gap of change (`_leaf_gaps`). Leaves the
    reference moves by round-off alone are left out (`_moved`)."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    g1 = ref["g1"]
    med_g = float(np.median(list(g1.values())))
    grad_gap = max(abs(prog["g1"][p] - v) / max(v, med_g)
                   for p, v in g1.items())
    p0 = dict(leaves(params0))
    moved = _moved(ref)
    ref_c = float(np.median([float((ref["p3"][p] - p0[p]).norm())
                             for p in moved]))
    prog_c = float(np.median([float((prog["p3"][p] - p0[p]).norm())
                              for p in moved]))
    leaf_gap = max(_leaf_gaps(prog, ref, p0).values())
    return {"loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
            "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"]},
            "change_gap": {"value": abs(prog_c - ref_c) / ref_c,
                           "limit": limits["change_gap"]},
            "change_gap_leaf": {"value": leaf_gap,
                                "limit": limits["change_gap_leaf"]}}


def figures(prog: dict, ref: dict, params0: dict) -> dict:
    """Numbers printed beside the check, not compared: the later steps'
    loss gap; the worst leaf and its size; the elements of moved leaves
    whose change has another sign on the two sides, and the largest of
    their reference gradients in units of the leaf's RMS gradient (the
    smallest over the three steps)."""
    p0 = dict(leaves(params0))
    gaps = _leaf_gaps(prog, ref, p0)
    worst = max(gaps, key=gaps.get)
    flipped, top = 0, 0.0
    for p in _moved(ref):
        flip = (torch.sign(prog["p3"][p] - p0[p])
                != torch.sign(ref["p3"][p] - p0[p]))
        if bool(flip.any()):
            flipped += int(flip.sum())
            ratio = torch.stack([g[p].abs() / g[p].pow(2).mean().sqrt()
                                 .clamp_min(1e-30) for g in ref["grads"]])
            top = max(top, float(ratio.min(0).values[flip].max()))
    return {"later_loss_gap": later_loss_gap(prog, ref),
            "worst_leaf": "/".join(map(str, worst)),
            "worst_leaf_size": int(p0[worst].numel()),
            "flipped_elements": flipped,
            "flipped_largest_grad_over_rms": top}


def later_loss_gap(prog: dict, ref: dict) -> float:
    """The largest relative gap of the second and third steps' losses (a
    figure on standard error, not compared)."""
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"][1:], ref["losses"][1:]))
