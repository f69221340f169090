"""Optimizers and LR schedules (torch counterpart of
`mirror_nerf_tpu/train/optim.py`).

Schedules are epoch-granular functions of the global step (steplr, cosine,
poly, plus a linear warmup for sgd and adam), evaluated at the step count
before the update, as optax does. The grid-lr multipliers (`grid_lr_mult`,
`coarse_grid_lr_mult`) scale the final step of the parameters under a
"grid" key, as optax's `scale_grid_updates` chained after the base
optimizer does. For adam and sgd that is one parameter group per
multiplier, whose lr is the schedule's times the multiplier (Adam's eps
sits inside the step, m̂ / (√v̂ + eps), eps_root 0, in both libraries).

radam and ranger are written out from optax 0.2.6 (`scale_by_radam`, then
the learning rate), not `torch.optim.RAdam`, which adds eps before the bias
correction, rectifies only above ρ = 5 and scales the unrectified step: here
the step is r·m̂ / (√ν̂ + 1e-8) where ρ ≥ 5, else m̂, times −lr. The scalars
(bias corrections, ρ, r) are float32, as optax takes them. ranger is the JAX
package's `lookahead` around it (slow weights in the optimizer state, sync
every 6th update, slow step 0.5), with the grid multipliers after lookahead
as in JAX: on a sync step a grid leaf moves by mult·(slow − p), not to the
slow weights (the reference's Ranger scales each group's inner step
instead; ROADMAP.md §3).

`Optimizer` is the counterpart of the JAX `make_optimizer` chain (its
state is written under the chain's npz leaf names). Parameters that a step
does not reach get a zero gradient, so the moments decay and the step count
advances exactly as optax's do.
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


# optax's radam defaults (the JAX package passes only the schedule) and the
# JAX package's lookahead (ranger)
_B1, _B2, _EPS, _THRESHOLD = 0.9, 0.999, 1e-8, 5.0
_SYNC_PERIOD, _SLOW_STEP = 6, 0.5


def radam_scalars(count: int):
    """optax's float32 scalars of update `count` (from 1): (the first and
    second moments' bias corrections 1 − β^t, ρ_t, r_t; r_t is used only
    where ρ_t ≥ 5)."""
    f = np.float32
    b2t = f(_B2) ** f(count)
    ro_inf64 = 2.0 / (1.0 - _B2) - 1.0
    ro_inf = f(ro_inf64)
    ro = ro_inf - f(2 * count) * b2t / (f(1.0) - b2t)
    r = None
    if ro >= _THRESHOLD:
        r = np.sqrt((ro - f(4.0)) * (ro - f(2.0)) * ro_inf
                    / (f((ro_inf64 - 4.0) * (ro_inf64 - 2.0)) * ro))
    return f(1.0) - f(_B1) ** f(count), f(1.0) - b2t, ro, r


class Optimizer:
    """The configured optimizer over a parameter tree of leaf tensors, with
    the schedule and the grid-lr groups. `step(global_step)` applies one
    update from the leaves' `.grad`."""

    def __init__(self, cfg, params: dict, steps_per_epoch: int):
        if cfg.optimizer not in ("adam", "sgd", "radam", "ranger"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        mults = grid_multipliers(cfg) or (1.0, 1.0)
        groups: dict = {}
        self.paths = {}  # id(leaf) -> npz path
        self.mults = []  # each leaf's grid multiplier
        for path, leaf in _leaves(params):
            parts = path.split("/")
            m = 1.0
            if "grid" in parts:
                m = mults[1] if "coarse" in parts else mults[0]
            groups.setdefault(m, []).append(leaf)
            self.paths[id(leaf)] = path
            self.mults.append(m)
        self.leaves = [leaf for _, leaf in _leaves(params)]
        self.opt = None  # the torch optimizer of adam and sgd
        if cfg.optimizer in ("radam", "ranger"):
            # optax's state: the moments and the update count; lookahead's
            # slow weights (from the initial parameters) and its own count
            self.mu = [torch.zeros_like(x) for x in self.leaves]
            self.nu = [torch.zeros_like(x) for x in self.leaves]
            self.count = 0
            self.slow = ([x.detach().clone() for x in self.leaves]
                         if cfg.optimizer == "ranger" else None)
            self.lookahead_step = 0
            return
        param_groups = [{"params": v, "mult": m} for m, v in groups.items()]
        if cfg.optimizer == "adam":
            kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.adam_eps)
            self.opt = (torch.optim.AdamW(param_groups,
                                          weight_decay=cfg.weight_decay, **kw)
                        if cfg.weight_decay else
                        torch.optim.Adam(param_groups, **kw))
        else:
            self.opt = torch.optim.SGD(param_groups, lr=cfg.lr,
                                       momentum=cfg.momentum,
                                       weight_decay=cfg.weight_decay)

    def step(self, global_step: int) -> None:
        lr = self.schedule(global_step)
        for leaf in self.leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        if self.opt is None:
            self._radam_step(lr)
            return
        for g in self.opt.param_groups:
            g["lr"] = lr * g["mult"]
        self.opt.step()

    @torch.no_grad()
    def _radam_step(self, lr: float) -> None:
        """One update of optax's radam chain (then lookahead for ranger,
        then the grid multipliers), in optax's order of operations."""
        grads = [x.grad for x in self.leaves]
        # μ ← (1 − β1)·g + β1·μ, ν ← (1 − β2)·g² + β2·ν
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - _B2)
        self.count += 1
        bc1, bc2, _, r = radam_scalars(self.count)
        upd = torch._foreach_div(self.mu, float(bc1))  # m̂
        if r is not None:
            den = torch._foreach_div(self.nu, float(bc2))  # ν̂
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _EPS)
            torch._foreach_mul_(upd, float(r))
            torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, float(-np.float32(lr)))
        if self.slow is not None:
            self.lookahead_step += 1
            if self.lookahead_step % _SYNC_PERIOD == 0:
                # slow ← slow + 0.5·(fast − slow); the update lands the
                # fast weights on the slow ones
                fast = torch._foreach_add(self.leaves, upd)
                torch._foreach_sub_(fast, self.slow)
                torch._foreach_mul_(fast, _SLOW_STEP)
                torch._foreach_add_(self.slow, fast)
                upd = torch._foreach_sub(self.slow, self.leaves)
        scaled = [i for i, m in enumerate(self.mults) if m != 1.0]
        for i in scaled:
            upd[i].mul_(self.mults[i])
        torch._foreach_add_(self.leaves, upd)

    def zero_grad(self) -> None:
        for leaf in self.leaves:
            leaf.grad = None

    # ---- the optimizer state under the JAX package's npz leaf names ----

    def _state_names(self):
        """(moment names: state key -> npz prefix, count names) of the
        optax chain the JAX package builds for this config: adam or adamw,
        sgd with momentum, radam, or lookahead(radam) for ranger, each
        followed by the grid-scaling stage when a multiplier differs from
        1. ranger's "slow" and "lookahead_step" are lookahead's slow weights
        and step."""
        cfg = self.cfg
        pre = "opt/0/" if grid_multipliers(cfg) else "opt/"
        if cfg.optimizer == "ranger":
            return ({"mu": pre + "inner/0/.mu", "nu": pre + "inner/0/.nu",
                     "slow": pre + "slow"},
                    [pre + "inner/0/.count", pre + "inner/1/.count",
                     pre + "step"])
        if cfg.optimizer == "radam":
            return ({"mu": pre + "0/.mu", "nu": pre + "0/.nu"},
                    [pre + "0/.count", pre + "1/.count"])
        if cfg.optimizer == "adam":
            return ({"exp_avg": pre + "0/.mu", "exp_avg_sq": pre + "0/.nu"},
                    [pre + "0/.count",
                     pre + ("2" if cfg.weight_decay else "1") + "/.count"])
        if cfg.weight_decay:
            return ({"momentum_buffer": pre + "1/0/.trace"},
                    [pre + "1/1/.count"])
        return {"momentum_buffer": pre + "0/.trace"}, [pre + "1/.count"]

    def _moment(self, i: int, key: str):
        """Leaf i's state tensor `key`, or None where it has none yet."""
        if self.opt is None:
            return getattr(self, key)[i]
        return self.opt.state.get(self.leaves[i], {}).get(key)

    def state_arrays(self, count: int) -> dict:
        """The optimizer state as npz arrays; `count` is the number of
        updates taken (optax's step counters, lookahead's step too)."""
        moments, counts = self._state_names()
        out = {name: np.asarray(count, np.int32) for name in counts}
        for i, leaf in enumerate(self.leaves):
            for key, prefix in moments.items():
                v = self._moment(i, key)
                out[f"{prefix}/{self.paths[id(leaf)]}"] = (
                    np.zeros(tuple(leaf.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())
        return out

    def load_state_arrays(self, data) -> None:
        """Restore the state written by either package's train checkpoint."""
        moments, counts = self._state_names()
        count = int(data[counts[0]])
        for i, leaf in enumerate(self.leaves):
            st = {key: torch.from_numpy(np.array(
                data[f"{prefix}/{self.paths[id(leaf)]}"], copy=True)).to(
                    dtype=leaf.dtype, device=leaf.device)
                for key, prefix in moments.items()}
            if self.opt is None:
                for key, v in st.items():
                    getattr(self, key)[i] = v
                continue
            if self.cfg.optimizer == "adam":
                st["step"] = torch.tensor(float(count))
            self.opt.state[leaf] = st
        if self.opt is None:
            self.count = count
            if self.slow is not None:
                self.lookahead_step = int(data[counts[2]])
