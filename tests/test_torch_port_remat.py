"""Port parity, `--use_remat` (train/loop.py `checkpointed`): for the three
models, a reflection-stage step's loss, gradients and generator state
with and without remat, perturbation and σ noise on (the recompute draws
what the forward drew); and a 2-step trajectory against the JAX Trainer
with `use_remat=True`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu_torch.config import Config
from mirror_nerf_tpu_torch.train.checkpoints import tree_leaves

# full-width fields but for the flagship's positional encoding
MODELS = {"nerf_tpu": dict(grid_levels="16:8,32:8"),
          "nerf_tcnn": {},
          "nerf": dict(N_emb_xyz=4, N_emb_dir=2)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("remat") / "scene")
    generate_scene(root, n_train=2, n_val=1, n_test=1, img_wh=(16, 16))
    return root


def _step(root, work, model, remat, replay=True):
    """One reflection-stage loss and backward: (loss, grads, the
    generator's state after it)."""
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train import loop
    from test_torch_port_train import TRAJ

    cfg = Config(root_dir=root, **dict(TRAJ, perturb=1.0, noise_std=1.0,
                                       model_type=model, use_remat=remat,
                                       **MODELS[model]))
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    tr = loop.Trainer(cfg, ds, work, device="cpu")
    ds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    batch = {"rays": torch.from_numpy(rays[:96]),
             "rgbs": torch.from_numpy(rgbs[:96]),
             "mirror_mask": torch.from_numpy(masks[:96])}
    start = tr.generator.get_state()
    saved = loop._Replay.__enter__, loop._Replay.__exit__
    if not replay:
        loop._Replay.__enter__ = lambda self: None
        loop._Replay.__exit__ = lambda self, *exc: False
    try:
        loss, _ = tr.loss_and_aux(loop.EpochStatics.of(tr.cfg, 1, False),
                                  batch)
        loss.backward(inputs=tr.opt.leaves)
    finally:
        loop._Replay.__enter__, loop._Replay.__exit__ = saved
    assert not torch.equal(tr.generator.get_state(), start)  # it drew
    grads = [torch.zeros_like(x) if x.grad is None else x.grad
             for x in tr.opt.leaves]
    return float(loss.detach()), grads, tr.generator.get_state()


def _worst(a, b) -> float:
    return max(float((x - y).abs().max()) / (float(x.abs().max()) + 1e-12)
               for x, y in zip(a, b))


@pytest.mark.parametrize("model", list(MODELS))
def test_remat_gradients_and_generator(scene, tmp_path, model):
    loss0, g0, s0 = _step(scene, str(tmp_path), model, remat=False)
    loss1, g1, s1 = _step(scene, str(tmp_path), model, remat=True)
    assert loss1 == loss0
    assert _worst(g0, g1) < 1e-5  # the backward's summation order only
    assert torch.equal(s0, s1)
    # not vacuous: a recompute that draws anew changes the gradients
    _, g2, _ = _step(scene, str(tmp_path), model, remat=True, replay=False)
    assert _worst(g0, g2) > 1e-3


def test_remat_trajectory_matches_jax(scene, tmp_path):
    """Two reflection-stage steps of test_torch_port_train's trajectory
    with `use_remat=True` in both packages."""
    from mirror_nerf_tpu.config import Config as JaxConfig
    from mirror_nerf_tpu.data.blender import BlenderDataset as JaxDS
    from mirror_nerf_tpu.parallel.mesh import get_mesh
    from mirror_nerf_tpu.train.loop import EpochStatics as JaxStatics
    from mirror_nerf_tpu.train.loop import Trainer as JaxTrainer
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer
    from test_torch_port_train import TRAJ

    kw = dict(TRAJ, use_remat=True)
    jcfg = JaxConfig(root_dir=scene, **kw)
    cfg = Config(root_dir=scene, **kw)
    jds = JaxDS(scene, "train", jcfg.img_wh, jcfg)
    jt = JaxTrainer(jcfg, jds, str(tmp_path / "jax"), mesh=get_mesh(1))
    ds = BlenderDataset(scene, "train", cfg.img_wh, cfg)
    pt = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu",
                 params=jax.tree_util.tree_map(np.array, jt.params))
    ds.train_geometry_stage = jds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    params, opt = jt.params, jt.opt_state
    step = jt.get_step_fn(JaxStatics.of(jcfg, 1, False))
    for i in range(2):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        params, opt, aux = step(params, opt, {
            "rays": jnp.asarray(rays[sl]), "rgbs": jnp.asarray(rgbs[sl]),
            "mirror_mask": jnp.asarray(masks[sl])}, jax.random.PRNGKey(i))
        got = pt.train_step(EpochStatics.of(cfg, 1, False), {
            "rays": torch.from_numpy(rays[sl]),
            "rgbs": torch.from_numpy(rgbs[sl]),
            "mirror_mask": torch.from_numpy(masks[sl])})
        np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    tree_leaves(pt.params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=5e-5, rtol=5e-4)
