"""Port parity, the training losses: each loss of `train/losses.py`, the
total, the masked means and `cpgrid_tv_loss`, against the JAX package on
the same numpy results and batch — GT mask valid, invalid (−1) and without
a mirror pixel; the geometry-stage color branches; the plane loss with the
tuple indices JAX draws, injected; the novel-ray regularization with JAX's
origin jitter and depths, injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.core.sampling import stratified_z_vals as jax_strat
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.ops.cpgrid import cpgrid_tv_loss as jax_tv
from mirror_nerf_tpu.train import losses as jl
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.ops.cpgrid import cpgrid_tv_loss
from mirror_nerf_tpu_torch.train import losses as tl
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

ATOL = 1e-6
N, S = 64, 8


def _results(rng):
    r = {}
    for typ in ("coarse", "fine"):
        r[f"rgb_{typ}"] = rng.uniform(0, 1, (N, 3))
        r[f"mirror_mask_{typ}"] = rng.uniform(0, 1, (N,))
        r[f"normal_dif_{typ}"] = rng.uniform(0, 2, (N,))
        nrm = rng.normal(size=(N, S, 3))
        r[f"pred_normal_{typ}"] = nrm / np.linalg.norm(nrm, axis=-1,
                                                       keepdims=True)
        r[f"weights_{typ}"] = rng.uniform(0, 0.3, (N, S))
        r[f"z_vals_{typ}"] = np.sort(rng.uniform(0.1, 4, (N, S)), -1)
        r[f"x_surface_{typ}"] = rng.normal(size=(N, 3))
    nrm = rng.normal(size=(N, S, 3))
    r["normal_fine"] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    return {k: v.astype(np.float32) for k, v in r.items()}


def _mask(rng, kind):
    m = (rng.uniform(size=N) < 0.4).astype(np.float32)
    if kind == "invalid":
        m[::7] = -1.0
    elif kind == "empty":
        m[:] = 0.0
    return m


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    res = _results(rng)
    rays = np.concatenate([rng.normal(size=(N, 3)), rng.normal(size=(N, 3)),
                           np.full((N, 1), 0.1), np.full((N, 1), 3.0)],
                          1).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    masks = {k: _mask(rng, k) for k in ("valid", "invalid", "empty")}
    return res, rays, rgbs, masks


def _both(res, batch):
    rt = {k: torch.from_numpy(v) for k, v in res.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    rj = {k: jnp.asarray(v) for k, v in res.items()}
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    return rt, bt, rj, bj


def _close(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_allclose(float(got), float(want), atol=ATOL,
                                   rtol=1e-6)


@pytest.mark.parametrize("geometry", [False, True], ids=["full", "geometry"])
@pytest.mark.parametrize("wo_black", [False, True],
                         ids=["blackout", "woMaskRGBtoBlack"])
@pytest.mark.parametrize("kind", ["valid", "invalid", "empty"])
def test_each_loss_matches_jax(data, kind, geometry, wo_black):
    res, rays, rgbs, masks = data
    batch = {"rgbs": rgbs, "rays": rays, "mirror_mask": masks[kind]}
    rt, bt, rj, bj = _both(res, batch)
    kw = dict(train_geometry_stage=geometry, woMaskRGBtoBlack=wo_black)
    lst, lsj = tl.LossSettings(**kw), jl.LossSettings(**kw)
    _close(tl.color_loss(lst, rt, bt), jl.color_loss(lsj, rj, bj))
    _close(tl.normal_loss(lst, rt, bt), jl.normal_loss(lsj, rj, bj))
    _close(tl.normal_reg_loss(lst, rt, bt), jl.normal_reg_loss(lsj, rj, bj))
    _close(tl.mirror_mask_loss(lst, rt, bt),
           jl.mirror_mask_loss(lsj, rj, bj))
    inside = dict(normal_loss_only_inside_mirror=True)
    _close(tl.normal_loss(tl.LossSettings(**inside), rt, bt),
           jl.normal_loss(jl.LossSettings(**inside), rj, bj))
    # the total with the plane loss off (it draws its own indices in JAX)
    got, parts = tl.total_loss(lst, rt, bt)
    want, jparts = jl.total_loss(lsj, rj, bj, jax.random.PRNGKey(0))
    assert set(parts) == set(jparts)
    _close(got, want)


@pytest.mark.parametrize("kind", ["valid", "invalid", "empty"])
def test_plane_loss_with_injected_tuples(data, kind):
    """JAX draws its 4-tuples inside the loss; the same categorical draw is
    repeated here and its indices handed to the port."""
    res, rays, rgbs, masks = data
    batch = {"rgbs": rgbs, "rays": rays, "mirror_mask": masks[kind]}
    rt, bt, rj, bj = _both(res, batch)
    ls = dict(plane_n_tuples=16, use_plane_consistent_loss=True,
              enable_plane_loss=True)
    key = jax.random.PRNGKey(3)
    inside = bj["mirror_mask"] > 0.5
    logits = jnp.where(inside, 0.0, -jnp.inf)
    logits = jnp.where(jnp.sum(inside) > 0, logits, jnp.zeros_like(logits))
    idx = jax.random.categorical(key, logits, shape=(16, 4))
    want = jl.plane_consistent_loss(jl.LossSettings(**ls), rj, bj, key)
    got = tl.plane_consistent_loss(tl.LossSettings(**ls), rt, bt,
                                   torch.from_numpy(np.array(idx)))
    _close(got, want)
    if kind == "valid":
        assert float(got) > 0  # not vacuous
    # the port's own draw lands on mirror pixels only
    g = torch.Generator().manual_seed(0)
    drawn = tl.draw_plane_tuples(bt["mirror_mask"], 16, g)
    if kind != "empty":
        assert bool((bt["mirror_mask"][drawn] > 0.5).all())


def test_distortion_and_masked_mean(data):
    res, _, _, masks = data
    rt = {k: torch.from_numpy(v) for k, v in res.items()}
    rj = {k: jnp.asarray(v) for k, v in res.items()}
    ls = dict(distortion_loss_weight=0.5)
    _close(tl.distortion_loss(tl.LossSettings(**ls), rt),
           jl.distortion_loss(jl.LossSettings(**ls), rj))
    from mirror_nerf_tpu.core.mathutil import masked_mean as jmm
    from mirror_nerf_tpu_torch.core.mathutil import masked_mean

    v = res["normal_dif_fine"]
    for m in (masks["valid"] > 0.5, np.zeros(N, bool)):
        _close(masked_mean(torch.from_numpy(v), torch.from_numpy(m)),
               jmm(jnp.asarray(v), jnp.asarray(m)))
    assert float(masked_mean(torch.from_numpy(v),
                             torch.zeros(N, dtype=torch.bool))) == 0.0


def test_novel_ray_reg_with_injected_draws(data):
    _, rays, _, _ = data
    kw = dict(bound=6.0, grid_levels=((16, 8), (32, 8)))
    jf, tf = JaxField(**kw), TorchField(**kw)
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
    params = {"coarse": p, "fine": p}
    key = jax.random.PRNGKey(5)
    want = jl.novel_ray_regularization(jf, params, jnp.asarray(rays), key,
                                       S, 0.2)
    k_o, k_z = jax.random.split(key)
    o_noise = np.asarray(jax.random.normal(k_o, (N, 3)))
    z = np.asarray(jax_strat(k_z, jnp.asarray(rays[:, 6:7]),
                             jnp.asarray(rays[:, 7:8]), S, False, 1.0))
    pt = params_from_numpy(params)
    got = tl.novel_ray_regularization(tf, pt, torch.from_numpy(rays),
                                      torch.from_numpy(o_noise),
                                      torch.from_numpy(z), 0.2)
    assert float(want) > 0  # not vacuous
    _close(got, want)


def test_cpgrid_tv_loss_matches_jax():
    jf = JaxField(bound=2.0, grid_levels=((16, 8), (32, 8)))
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(1)))
    got = cpgrid_tv_loss(params_from_numpy(p)["grid"])
    _close(got, jax_tv(p["grid"]))


def test_loss_settings_schedule_matches_jax():
    from mirror_nerf_tpu.config import Config as JCfg
    from mirror_nerf_tpu_torch.config import Config

    for geo in (False, True):
        for epoch in (0, 1, 2, 5):
            got = tl.make_loss_settings(Config(train_geometry_stage=geo),
                                        geo, epoch)
            want = jl.make_loss_settings(JCfg(train_geometry_stage=geo), geo,
                                         epoch)
            assert got.__dict__ == want.__dict__
