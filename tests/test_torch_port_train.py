"""Port parity, the training slice as a whole: the optimizer and schedules
against the optax chain; `trace_rays` in training settings (level 1,
compaction that fits and that overflows, valid and invalid GT masks),
values and the parameter gradient of a loss; a short Trainer trajectory
against the JAX Trainer (plain path, `fused_train off`); the train
checkpoint round trip between the packages; and the train CLI running with
jax and `mirror_nerf_tpu` blocked from import."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.config import Config as JaxConfig
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.tracer import TraceSettings as JaxTS
from mirror_nerf_tpu.render.tracer import trace_rays as jax_trace_rays
from mirror_nerf_tpu.train.optim import make_lr_schedule as jax_schedule
from mirror_nerf_tpu.train.optim import make_optimizer as jax_optimizer
from mirror_nerf_tpu_torch.config import Config
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.render.renderer import RenderSettings
from mirror_nerf_tpu_torch.render.tracer import TraceSettings, trace_rays
from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                     tree_leaves)
from mirror_nerf_tpu_torch.train.optim import Optimizer, make_lr_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = ((16, 8), (32, 8))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---- (c) optimizer ----


def _small_tree(rng):
    def side():
        return {"grid": {"axes": [[rng.normal(size=(4, 3))] for _ in range(3)],
                         "fold": rng.normal(size=(3, 2))},
                "sigma_net": [{"w": rng.normal(size=(2, 5))}]}

    t = {"coarse": side(), "fine": side()}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)


@pytest.mark.parametrize("opt", [
    dict(optimizer="adam", grid_lr_mult=20.0, coarse_grid_lr_mult=3.0,
         adam_eps=1e-15),
    dict(optimizer="adam", weight_decay=0.01),
    dict(optimizer="sgd", momentum=0.9, grid_lr_mult=5.0),
], ids=["adam_grid_mult", "adamw", "sgd"])
def test_optimizer_matches_optax(opt):
    """Five steps across an epoch boundary (2 steps/epoch, decay at epoch
    1), the fine sigma_net never getting a gradient (zeros in optax)."""
    kw = dict(lr=1e-2, lr_scheduler="steplr", decay_step=(1,),
              decay_gamma=0.5, **opt)
    rng = np.random.default_rng(0)
    p = _small_tree(rng)
    tx = jax_optimizer(JaxConfig(**kw), 2)
    pj, state = p, tx.init(p)
    pt = params_from_numpy(p)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    port = Optimizer(Config(**kw), pt, 2)
    for step in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), p)
        g["fine"]["sigma_net"][0]["w"][:] = 0.0
        upd, state = tx.update(g, state, pj)
        pj = jax.tree_util.tree_map(lambda a, u: a + u, pj, upd)
        port.zero_grad()
        for (leaf, gl, path) in zip(tree_leaves(pt), tree_leaves(g),
                                    [port.paths[id(x)]
                                     for x in tree_leaves(pt)]):
            if path != "fine/sigma_net/0/w":
                leaf.grad = torch.from_numpy(np.array(gl))
        port.step(step)
    # optax takes Adam's bias corrections 1 − β^t in float32 (1 − 0.999 has
    # a relative error of 1.3e-5 there), torch in double: ~1e-5 of each
    # update, and the grid leaves move by up to lr × 20 = 0.2 a step
    for a, b in zip(tree_leaves(_np_tree(pj)), tree_leaves(pt)):
        np.testing.assert_allclose(b.detach().numpy(), a, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("sched", [
    dict(lr_scheduler="cosine", num_epochs=6),
    dict(lr_scheduler="poly", num_epochs=6, poly_exp=0.9),
    dict(lr_scheduler="steplr", decay_step=(2, 4), warmup_epochs=2,
         warmup_multiplier=4.0),
], ids=["cosine", "poly", "warmup_steplr"])
def test_lr_schedules_match(sched):
    got = make_lr_schedule(Config(**sched), 3)
    want = jax_schedule(JaxConfig(**sched), 3)
    for step in range(20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


# ---- (d) trace_rays in training settings ----


def _trace_scene():
    """JAX-initialized params with σ ≥ 0 and the mirror head biased on, and
    256 rays; GT masks with 40 % or 60 % mirror pixels, and an invalid one."""
    jf = JaxField(bound=2.0, grid_levels=LEVELS)
    tf = TorchField(bound=2.0, grid_levels=LEVELS)
    params = {}
    for side, seed in (("coarse", 0), ("fine", 1)):
        p = _np_tree(jf.init(jax.random.PRNGKey(seed)))
        p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
        p["is_mirror"][1]["b"][:] = 1.0
        params[side] = p
    rng = np.random.default_rng(0)
    n = 256
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), 1.5, np.float32)], axis=1)
    u = rng.uniform(size=n)
    masks = {"valid40": (u < 0.4).astype(np.float32),
             "valid60": (u < 0.6).astype(np.float32),
             "invalid": np.where(u < 0.05, -1.0, (u < 0.4)).astype(
                 np.float32)}
    return jf, tf, params, rays, masks


RS_TRAIN = dict(N_samples=4, N_importance=4, perturb=0.0, noise_std=0.0,
                compute_normal=True, fine_pass="fine",
                detach_density_outside_mirror_for_mask_loss=True)


def _trace_loss(res, xp):
    s = xp.sum
    return (s(res["rgb_fine"] * 0.7) + s(res["rgb_coarse"] * 0.3)
            + s(res["normal_dif_fine"]) + s(res["mirror_mask_fine"] * 0.5)
            + s(res["depth_fine"] * 0.1))


@pytest.mark.parametrize("compact_frac", [1.0, 0.5], ids=["masked", "compact"])
def test_trace_rays_training_matches_jax(compact_frac):
    jf, tf, params, rays, masks = _trace_scene()
    kw = dict(trace_secondary_rays=True, max_recursive_level=1,
              only_trace_rays_in_mirrors=True, compact_frac=compact_frac)
    jts = JaxTS(render=JaxRS(**RS_TRAIN), **kw)
    ts = TraceSettings(render=RenderSettings(**RS_TRAIN), **kw)

    @jax.jit
    def jax_fn(p, m):
        def f(pp):
            res = jax_trace_rays(jf, pp, jnp.asarray(rays), m,
                                 jax.random.PRNGKey(0), jts)
            return _trace_loss(res, jnp), res
        return jax.value_and_grad(f, has_aux=True)(p)

    for kind, mask in masks.items():
        (l0, want), g0 = jax_fn(params, jnp.asarray(mask))
        pt = params_from_numpy(params)
        for leaf in tree_leaves(pt):
            leaf.requires_grad_(True)
        got = trace_rays(tf, pt, torch.from_numpy(rays),
                         torch.from_numpy(mask), ts)
        loss = _trace_loss(got, torch)
        loss.backward()
        assert set(got) == set(want), kind
        for k in want:
            # per-sample σ-gradient normals are normalized from gradients
            # that can be small, which scales their rounding up
            atol = 5e-5 if k.startswith("normal_") else 2e-5
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), atol=atol,
                                       rtol=0, err_msg=f"{kind} {k}")
        np.testing.assert_allclose(float(loss.detach()), float(l0), rtol=1e-5)
        g1 = [np.zeros(tuple(x.shape), np.float32) if x.grad is None
              else x.grad.numpy() for x in tree_leaves(pt)]
        for a, b in zip(tree_leaves(_np_tree(g0)), g1):
            scale = float(np.abs(a).max()) + 1e-8
            assert float(np.abs(a - b).max()) / scale < 5e-4, kind
        overflow = "compact_dropped" in got and float(
            got["compact_dropped"].sum()) > 0
        # capacity 128 of 256 rays: 60 % GT mirror pixels overflow, and so
        # does the invalid mask, which takes the prediction (all mirrors)
        assert overflow == (compact_frac < 1.0 and kind != "valid40"), kind


# ---- (e) trajectory against the JAX Trainer ----


def _scene(tmp_path):
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path / "scene")
    generate_scene(root, n_train=2, n_val=1, n_test=1, img_wh=(16, 16))
    return root


TRAJ = dict(img_wh=(16, 16), near=0.05, far=12.0, bound=6.0,
            model_type="nerf_tpu", grid_levels="16:8,32:8", N_samples=6,
            N_importance=6, batch_size=96, num_epochs=2, predict_normal=True,
            predict_mirror_mask=True, trace_secondary_rays=True,
            only_trace_rays_in_mirrors=True, smooth_mirror_start_epoch=0,
            train_mirror_mask_start_epoch=0, train_normal_start_epoch=0,
            chunk=256, perturb=0.0, noise_std=0.0, fused_train="off",
            train_geometry_stage=True, train_geometry_stage_end_epoch=1)


def test_trainer_trajectory_matches_jax(tmp_path):
    """Three reflection-stage steps, then one geometry-stage step, on the
    same batches from the same initial parameters."""
    from mirror_nerf_tpu.data.blender import BlenderDataset as JaxDS
    from mirror_nerf_tpu.parallel.mesh import get_mesh
    from mirror_nerf_tpu.train.loop import EpochStatics as JaxStatics
    from mirror_nerf_tpu.train.loop import Trainer as JaxTrainer
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    root = _scene(tmp_path)
    jcfg = JaxConfig(root_dir=root, **TRAJ)
    cfg = Config(root_dir=root, **TRAJ)
    jds = JaxDS(root, "train", jcfg.img_wh, jcfg)
    jt = JaxTrainer(jcfg, jds, str(tmp_path / "jax"), mesh=get_mesh())
    p0 = _np_tree(jt.params)
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    pt = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu", params=p0)
    ds.train_geometry_stage = jds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()

    plan = [(JaxStatics.of(jcfg, 1, False), EpochStatics.of(cfg, 1, False))
            ] * 3 + [(JaxStatics.of(jcfg, 0, True),
                      EpochStatics.of(cfg, 0, True))]
    params, opt = jt.params, jt.opt_state
    for i, (js, ps) in enumerate(plan):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        step = jt.get_step_fn(js)
        params, opt, aux = step(params, opt, {
            "rays": jnp.asarray(rays[sl]), "rgbs": jnp.asarray(rgbs[sl]),
            "mirror_mask": jnp.asarray(masks[sl])}, jax.random.PRNGKey(i))
        got = pt.train_step(ps, {"rays": torch.from_numpy(rays[sl]),
                                 "rgbs": torch.from_numpy(rgbs[sl]),
                                 "mirror_mask": torch.from_numpy(masks[sl])})
        np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
        assert float(masks[sl].max()) > 0.5  # batches with mirror pixels
    for a, b in zip(tree_leaves(_np_tree(params)), tree_leaves(pt.params)):
        np.testing.assert_allclose(b.detach().numpy(), a, atol=5e-5,
                                   rtol=5e-4)


def test_compaction_overflow_hard_fails_above_one_percent():
    from mirror_nerf_tpu_torch.train.loop import check_compaction_overflow

    check_compaction_overflow({"compact_dropped": 1.0,
                               "compact_mirror": 100.0}, 0.5)
    check_compaction_overflow({}, 1.0)
    with pytest.raises(RuntimeError, match="compact_frac"):
        check_compaction_overflow({"compact_dropped": 2.0,
                                   "compact_mirror": 100.0}, 0.5)


def test_fused_train_on_needs_a_card():
    from mirror_nerf_tpu_torch.train.loop import make_trace_settings

    with pytest.raises(ValueError, match="CUDA"):
        make_trace_settings(Config(fused_train="on"), 0, False, False, "cpu")
    ts = make_trace_settings(Config(model_type="nerf_tpu"), 0, False, False,
                             "cpu")
    assert not ts.render.fused_density  # "auto" takes the plain version


# ---- (f) train checkpoint round trip ----


def test_train_ckpt_round_trip_bitwise(tmp_path):
    """JAX save_train_ckpt → port load → port save → JAX load, bit for bit,
    Adam moments and step counters included."""
    from mirror_nerf_tpu.train.checkpoints import load_train_ckpt as jload
    from mirror_nerf_tpu.train.checkpoints import save_train_ckpt as jsave
    from mirror_nerf_tpu_torch.train.checkpoints import (
        load_optimizer_state, load_train_ckpt, save_train_ckpt)

    kw = dict(optimizer="adam", grid_lr_mult=20.0, adam_eps=1e-15)
    rng = np.random.default_rng(1)
    p = _small_tree(rng)
    tx = jax_optimizer(JaxConfig(**kw), 4)
    state = tx.init(p)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), p)
        upd, state = tx.update(g, state, p)
        p = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), p, upd)
    src, dst = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave(src, p, jax.device_get(state), 2, 1)

    like = params_from_numpy(jax.tree_util.tree_map(np.zeros_like, p))
    params, step, epoch = load_train_ckpt(src, like)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = Optimizer(Config(**kw), params, 4)
    load_optimizer_state(src, opt)
    save_train_ckpt(dst, params, opt, step, epoch)
    a, b = np.load(src), np.load(dst)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    jp, jopt, jstep, jepoch = jload(dst, p, state)
    assert (jstep, jepoch) == (2, 1)


# ---- (g) the train CLI, jax blocked ----


def test_train_cli_runs_with_jax_blocked(tmp_path):
    """Two tiny epochs (a geometry and a reflection epoch with novel-ray
    reg) on the CPU in a process where importing jax fails; the
    checkpoint's parameters load in the JAX package."""
    code = textwrap.dedent("""
        import os, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "mirror_nerf_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        from mirror_nerf_tpu_torch.data.synthetic import generate_scene
        from mirror_nerf_tpu_torch.train import cli
        generate_scene("scene", n_train=2, n_val=1, n_test=1,
                       img_wh=(12, 12))
        tr = cli.main(["--dataset_name", "blender", "--root_dir", "scene",
            "--img_wh", "12", "12", "--near", "0.05", "--far", "12",
            "--model_type", "nerf_tpu", "--predict_normal",
            "--predict_mirror_mask", "--trace_secondary_rays", "--bound",
            "6", "--grid_levels", "16:8,32:8", "--N_samples", "6",
            "--N_importance", "6", "--batch_size", "96", "--num_epochs", "2",
            "--chunk", "256", "--train_geometry_stage",
            "--train_geometry_stage_end_epoch", "1",
            "--use_plane_consistent_loss", "--smooth_mirror_start_epoch", "1",
            "--only_trace_rays_in_mirrors", "--novel_ray_batch", "32",
            "--novel_ray_start_epoch", "1", "--grid_lr_mult", "20",
            "--adam_eps", "1e-15", "--device", "cpu", "--exp_name", "t"])
        print(tr.workdir)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    run = tmp_path / res.stdout.strip().splitlines()[-1]
    files = set(os.listdir(run))
    for name in ("config.json", "metrics.jsonl", "val_metrics.jsonl",
                 "val_epoch0.png", "val_epoch1.png", "last.ckpt.npz",
                 "epoch=1.ckpt.npz"):
        assert name in files, name
    lines = (run / "val_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2

    from mirror_nerf_tpu.train.checkpoints import load_params_any

    jf = JaxField(bound=6.0, grid_levels=LEVELS, predict_normal=True,
                  predict_mirror_mask=True)
    like = {"coarse": jf.init(jax.random.PRNGKey(0)),
            "fine": jf.init(jax.random.PRNGKey(1))}
    loaded = load_params_any(str(run / "last.ckpt.npz"), like)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(loaded))
