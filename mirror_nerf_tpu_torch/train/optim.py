"""Optimizers and LR schedules (torch counterpart of
`mirror_nerf_tpu/train/optim.py`).

Schedules are epoch-granular functions of the global step (steplr, cosine,
poly, plus a linear warmup), evaluated at the step count before the update,
as optax does. The grid-lr multipliers (`grid_lr_mult`,
`coarse_grid_lr_mult`) scale the final step of the parameters under a
"grid" key: one parameter group per multiplier, whose lr is the schedule's
times the multiplier — the same update as optax's `scale_grid_updates`
chained after the base optimizer, since Adam's eps sits inside the step
(m̂ / (√v̂ + eps), eps_root 0, in both libraries).

`Optimizer` is the counterpart of the JAX `make_optimizer` chain (its
state is written under the chain's npz leaf names). Parameters that a step
does not reach get a zero gradient, so Adam's
moments decay and its step count advances exactly as optax's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .checkpoints import _leaves


def make_lr_schedule(cfg, steps_per_epoch: int):
    """LR as a function of the global step (a Python float)."""
    base_lr = cfg.lr

    def epoch_of(step):
        return step // max(steps_per_epoch, 1)

    if cfg.lr_scheduler == "steplr":
        milestones = tuple(sorted(cfg.decay_step))

        def sched(step):
            e = epoch_of(step)
            mult = 1.0
            for m in milestones:
                mult *= cfg.decay_gamma ** (e >= m)
            return base_lr * mult
    elif cfg.lr_scheduler == "cosine":
        def sched(step):
            t = min(epoch_of(step) / max(cfg.num_epochs, 1), 1.0)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t)) + 1e-8
    elif cfg.lr_scheduler == "poly":
        def sched(step):
            e = epoch_of(step)
            return base_lr * (1.0 - e / max(cfg.num_epochs, 1)) ** cfg.poly_exp
    else:
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")

    if cfg.warmup_epochs > 0 and cfg.optimizer in ("sgd", "adam"):
        warm_steps = cfg.warmup_epochs * steps_per_epoch

        def warmed(step):
            # GradualWarmupScheduler: ramp lr/multiplier -> lr, then the
            # wrapped schedule
            if step >= warm_steps:
                return sched(step)
            frac = min(step / max(warm_steps, 1), 1.0)
            mult = 1.0 + (cfg.warmup_multiplier - 1.0) * frac
            return cfg.lr * mult / cfg.warmup_multiplier

        return warmed
    return sched


def grid_multipliers(cfg):
    """(fine/other-field grid multiplier, coarse-field grid multiplier), or
    None when neither differs from 1 (no scaling stage in the chain)."""
    mult = cfg.grid_lr_mult
    cmult = mult if cfg.coarse_grid_lr_mult is None else cfg.coarse_grid_lr_mult
    if mult == 1.0 and cmult == 1.0:
        return None
    return mult, cmult


class Optimizer:
    """The configured optimizer over a parameter tree of leaf tensors, with
    the schedule and the grid-lr groups. `step(global_step)` applies one
    update from the leaves' `.grad`."""

    def __init__(self, cfg, params: dict, steps_per_epoch: int):
        if cfg.optimizer in ("radam", "ranger"):
            raise NotImplementedError(
                f"--optimizer {cfg.optimizer} is not ported yet: ROADMAP.md "
                "queue 1, item 7 (radam and ranger)")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        mults = grid_multipliers(cfg) or (1.0, 1.0)
        groups: dict = {}
        self.paths = {}  # id(leaf) -> npz path
        for path, leaf in _leaves(params):
            parts = path.split("/")
            m = 1.0
            if "grid" in parts:
                m = mults[1] if "coarse" in parts else mults[0]
            groups.setdefault(m, []).append(leaf)
            self.paths[id(leaf)] = path
        self.leaves = [leaf for _, leaf in _leaves(params)]
        param_groups = [{"params": v, "mult": m} for m, v in groups.items()]
        if cfg.optimizer == "adam":
            kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.adam_eps)
            self.opt = (torch.optim.AdamW(param_groups,
                                          weight_decay=cfg.weight_decay, **kw)
                        if cfg.weight_decay else
                        torch.optim.Adam(param_groups, **kw))
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(param_groups, lr=cfg.lr,
                                       momentum=cfg.momentum,
                                       weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def step(self, global_step: int) -> None:
        lr = self.schedule(global_step)
        for g in self.opt.param_groups:
            g["lr"] = lr * g["mult"]
        for leaf in self.leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    # ---- the optimizer state under the JAX package's npz leaf names ----

    def _state_names(self):
        """(moment names: torch state key -> npz prefix, count names) of the
        optax chain the JAX package builds for this config: adam or adamw
        (+ the grid-scaling stage) or sgd with momentum."""
        cfg = self.cfg
        pre = "opt/0/" if grid_multipliers(cfg) else "opt/"
        if cfg.optimizer == "adam":
            return ({"exp_avg": pre + "0/.mu", "exp_avg_sq": pre + "0/.nu"},
                    [pre + "0/.count",
                     pre + ("2" if cfg.weight_decay else "1") + "/.count"])
        if cfg.weight_decay:
            return ({"momentum_buffer": pre + "1/0/.trace"},
                    [pre + "1/1/.count"])
        return {"momentum_buffer": pre + "0/.trace"}, [pre + "1/.count"]

    def state_arrays(self, count: int) -> dict:
        """The optimizer state as npz arrays; `count` is the number of
        updates taken (optax's step counters)."""
        moments, counts = self._state_names()
        out = {name: np.asarray(count, np.int32) for name in counts}
        for leaf in self.leaves:
            st = self.opt.state.get(leaf, {})
            for key, prefix in moments.items():
                v = st.get(key)
                out[f"{prefix}/{self.paths[id(leaf)]}"] = (
                    np.zeros(tuple(leaf.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())
        return out

    def load_state_arrays(self, data) -> None:
        """Restore the state written by either package's train checkpoint."""
        moments, counts = self._state_names()
        count = int(data[counts[0]])
        for leaf in self.leaves:
            st = {key: torch.from_numpy(np.array(
                data[f"{prefix}/{self.paths[id(leaf)]}"], copy=True)).to(
                    dtype=leaf.dtype, device=leaf.device)
                for key, prefix in moments.items()}
            if self.cfg.optimizer == "adam":
                st["step"] = torch.tensor(float(count))
            self.opt.state[leaf] = st
