"""Port parity, `--optimizer radam` and `ranger`: the port's update against
the JAX package's `make_optimizer` (optax 0.2.6's radam, the package's
lookahead, the grid multipliers after both) update by update, the warmup
both ignore, their train checkpoints in both directions, and a short CP
Trainer trajectory with ranger against the JAX Trainer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.config import Config as JaxConfig
from mirror_nerf_tpu.train.optim import make_lr_schedule as jax_schedule
from mirror_nerf_tpu.train.optim import make_optimizer as jax_optimizer
from mirror_nerf_tpu_torch.config import Config
from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                     tree_leaves)
from mirror_nerf_tpu_torch.train.optim import (Optimizer, make_lr_schedule,
                                               radam_scalars)

# optax takes every scalar in float32 as the port does; what is left is the
# elementwise order (an FMA here or there): a few ulps of a parameter ~1
ATOL, RTOL = 2e-6, 2e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _small_tree(rng):
    def side():
        return {"grid": {"axes": [[rng.normal(size=(4, 3))] for _ in range(3)],
                         "fold": rng.normal(size=(3, 2))},
                "sigma_net": [{"w": rng.normal(size=(2, 5))}]}

    t = {"coarse": side(), "fine": side()}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)


def _port(kw, p, steps_per_epoch=2):
    pt = params_from_numpy(p)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    return pt, Optimizer(Config(**kw), pt, steps_per_epoch)


def _set_grads(port, pt, g, skip=()):
    port.zero_grad()
    for leaf, gl in zip(tree_leaves(pt), tree_leaves(g)):
        if port.paths[id(leaf)] not in skip:
            leaf.grad = torch.from_numpy(np.array(gl))


def _grads(rng, p):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), p)


CASES = {
    "radam": dict(optimizer="radam"),
    "radam_grid20": dict(optimizer="radam", grid_lr_mult=20.0,
                         coarse_grid_lr_mult=1.0),
    "ranger": dict(optimizer="ranger"),
    "ranger_grid20": dict(optimizer="ranger", grid_lr_mult=20.0,
                          coarse_grid_lr_mult=1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_by_update_matches_make_optimizer(case):
    """13 updates across two epoch boundaries (2 steps an epoch, decay at
    epoch 1 and 4), ρ crossing 5 between updates 5 and 6, lookahead's syncs
    at 6 and 12; the fine sigma_net gets no gradient (zeros in optax).
    After each update every leaf agrees within ATOL + RTOL·|p|."""
    kw = dict(lr=1e-2, lr_scheduler="steplr", decay_step=(1, 4),
              decay_gamma=0.5, **CASES[case])
    rng = np.random.default_rng(0)
    p = _small_tree(rng)
    tx = jax_optimizer(JaxConfig(**kw), 2)
    pj, state = p, tx.init(p)
    update = jax.jit(tx.update)
    pt, port = _port(kw, p)
    for step in range(13):
        g = _grads(rng, p)
        g["fine"]["sigma_net"][0]["w"][:] = 0.0
        upd, state = update(g, state, pj)
        before = [np.array(x.detach()) for x in tree_leaves(pt)]
        pj = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), pj, upd)
        _set_grads(port, pt, g, skip=("fine/sigma_net/0/w",))
        port.step(step)
        for a, b in zip(tree_leaves(pj), tree_leaves(pt)):
            np.testing.assert_allclose(b.detach().numpy(), a, atol=ATOL,
                                       rtol=RTOL, err_msg=f"update {step + 1}")
        if "ranger" in case and step + 1 == 6:
            # the sync step: the slow weights s' = s + 0.5·(p + u − s), and
            # a grid leaf under the multiplier moves by mult·(s' − p), the
            # JAX chain's order (lookahead, then scale_grid_updates)
            i = _index(pt, "fine/grid/fold")  # port.leaves' order too
            slow = port.slow[i]
            moved = tree_leaves(pt)[i].detach().numpy() - before[i]
            mult = 20.0 if case == "ranger_grid20" else 1.0
            by_hand = mult * (slow.numpy() - before[i])
            np.testing.assert_allclose(moved, by_hand, atol=1e-6)
            np.testing.assert_allclose(
                tree_leaves(pj)[i] - before[i], by_hand, atol=ATOL * 20)
            if mult != 1.0:  # the leaf left the slow weights behind
                assert np.abs(tree_leaves(pj)[i] - slow.numpy()).max() > 1e-3


def _index(pt, path):
    from mirror_nerf_tpu_torch.train.checkpoints import _leaves

    return [p for p, _ in _leaves(pt)].index(path)


def test_radam_scalars_are_optax_float32():
    """Bias corrections, ρ_t and r_t of updates 1–13 bit for bit with
    optax's own arithmetic (jit, float32); ρ < 5 through update 5."""
    from optax._src import numerics

    b1, b2 = 0.9, 0.999
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    @jax.jit
    def optax_scalars(count):
        b2t = b2 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        r = jnp.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                     / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return 1 - b1 ** count, 1 - b2t, ro, r

    count = jnp.zeros([], jnp.int32)
    for t in range(1, 14):
        count = numerics.safe_increment(count)
        want = [np.float32(x) for x in optax_scalars(count)]
        bc1, bc2, ro, r = radam_scalars(t)
        assert (bc1, bc2, ro) == tuple(want[:3]), t
        assert (r is None) == (t <= 5) == (ro < 5.0), t
        if r is not None:
            assert r == want[3], t


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_warmup_is_ignored(name):
    """JAX applies the warmup to sgd and adam only."""
    kw = dict(optimizer=name, lr_scheduler="steplr", decay_step=(2, 4),
              warmup_epochs=2, warmup_multiplier=4.0)
    plain = make_lr_schedule(Config(**dict(kw, warmup_epochs=0)), 3)
    got = make_lr_schedule(Config(**kw), 3)
    want = jax_schedule(JaxConfig(**kw), 3)
    for step in range(20):
        assert got(step) == plain(step)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def _jax_run(kw, p, rng, n):
    tx = jax_optimizer(JaxConfig(**kw), 2)
    state = tx.init(p)
    update = jax.jit(tx.update)
    for _ in range(n):
        upd, state = update(_grads(rng, p), state, p)
        p = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), p, upd)
    return tx, p, state


@pytest.mark.parametrize("case", ["radam_grid20", "ranger", "ranger_grid20"])
def test_checkpoints_resume_across_packages(case, tmp_path):
    """A JAX checkpoint after 4 updates resumes in the port and a port
    checkpoint in JAX: the npz names and arrays bit for bit, then 4 more
    updates (the ranger sync at 6 among them) agree within ATOL."""
    from mirror_nerf_tpu.train.checkpoints import load_train_ckpt as jload
    from mirror_nerf_tpu.train.checkpoints import save_train_ckpt as jsave
    from mirror_nerf_tpu_torch.train.checkpoints import (
        load_optimizer_state, load_train_ckpt, save_train_ckpt)

    kw = dict(lr=1e-2, lr_scheduler="steplr", decay_step=(3,), **CASES[case])
    rng = np.random.default_rng(1)
    p0 = _small_tree(rng)
    tx, p, state = _jax_run(kw, p0, rng, 4)
    src, dst = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave(src, p, jax.device_get(state), 4, 2)

    like = params_from_numpy(jax.tree_util.tree_map(np.zeros_like, p))
    params, step, epoch = load_train_ckpt(src, like)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    port = Optimizer(Config(**kw), params, 2)
    load_optimizer_state(src, port)
    save_train_ckpt(dst, params, port, step, epoch)
    a, b = np.load(src), np.load(dst)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    # both continue: the port from JAX's checkpoint, JAX from the port's
    jp, jstate, jstep, _ = jload(dst, p, state)
    assert jstep == 4
    update = jax.jit(tx.update)
    for i in range(4, 8):
        g = _grads(rng, p)
        upd, jstate = update(g, jstate, jp)
        jp = jax.tree_util.tree_map(lambda x, u: np.asarray(x + u), jp, upd)
        _set_grads(port, params, g)
        port.step(i)
    for x, y in zip(tree_leaves(jp), tree_leaves(params)):
        np.testing.assert_allclose(y.detach().numpy(), x, atol=ATOL,
                                   rtol=RTOL)


def test_ranger_cp_trainer_trajectory_matches_jax(tmp_path):
    """Three reflection-stage steps of the CP Trainer with --optimizer
    ranger and --grid_lr_mult 20 against the JAX Trainer (plain path), on
    the same batches from the same initial parameters."""
    from mirror_nerf_tpu.data.blender import BlenderDataset as JaxDS
    from mirror_nerf_tpu.parallel.mesh import get_mesh
    from mirror_nerf_tpu.train.loop import EpochStatics as JaxStatics
    from mirror_nerf_tpu.train.loop import Trainer as JaxTrainer
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    root = str(tmp_path / "scene")
    generate_scene(root, n_train=2, n_val=1, n_test=1, img_wh=(16, 16))
    traj = dict(img_wh=(16, 16), near=0.05, far=12.0, bound=6.0,
                model_type="nerf_tpu", grid_levels="16:8,32:8", N_samples=6,
                N_importance=6, batch_size=96, num_epochs=2,
                predict_normal=True, predict_mirror_mask=True,
                trace_secondary_rays=True, only_trace_rays_in_mirrors=True,
                smooth_mirror_start_epoch=0, train_mirror_mask_start_epoch=0,
                train_normal_start_epoch=0, chunk=256, perturb=0.0,
                noise_std=0.0, fused_train="off", optimizer="ranger",
                grid_lr_mult=20.0, lr=5e-4)
    jcfg = JaxConfig(root_dir=root, **traj)
    cfg = Config(root_dir=root, **traj)
    jds = JaxDS(root, "train", jcfg.img_wh, jcfg)
    # one device: on the 8-device CPU mesh XLA's in-process all-reduce in
    # the JAX ranger step waits for a participant that never arrives
    jt = JaxTrainer(jcfg, jds, str(tmp_path / "jax"), mesh=get_mesh(1))
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    p0 = _np_tree(jt.params)
    pt = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu", params=p0)
    ds.train_geometry_stage = jds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    js, ps = JaxStatics.of(jcfg, 1, False), EpochStatics.of(cfg, 1, False)
    # lookahead's slow weights are the initial parameters' own buffers on
    # one device, and the step donates both: give the state its own copies
    params = jt.params
    opt = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                 jt.opt_state)
    step = jt.get_step_fn(js)
    for i in range(3):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        params, opt, aux = step(params, opt, {
            "rays": jnp.asarray(rays[sl]), "rgbs": jnp.asarray(rgbs[sl]),
            "mirror_mask": jnp.asarray(masks[sl])}, jax.random.PRNGKey(i))
        got = pt.train_step(ps, {"rays": torch.from_numpy(rays[sl]),
                                 "rgbs": torch.from_numpy(rgbs[sl]),
                                 "mirror_mask": torch.from_numpy(masks[sl])})
        np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
    # the same bar as the adam trajectory (test_torch_port_train.py)
    for a, b in zip(tree_leaves(_np_tree(params)), tree_leaves(pt.params)):
        np.testing.assert_allclose(b.detach().numpy(), a, atol=5e-5,
                                   rtol=5e-4)
    # the slow weights are still the initial parameters (no sync yet)
    for s, x in zip(pt.opt.slow, tree_leaves(p0)):
        np.testing.assert_array_equal(s.numpy(), x)
