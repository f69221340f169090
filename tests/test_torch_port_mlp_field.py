"""Port parity, the flagship PE-MLP field: the positional encoding, the
`MirrorNeRFField` modules and its σ-gradient of `mirror_nerf_tpu_torch`
against `mirror_nerf_tpu` on the same numpy inputs and the same
(JAX-initialized) parameters; the npz weights bridge both ways; and a
reference-layout torch Lightning checkpoint (written by the port's
`save_torch_ckpt` with the reference's key names, with and without the
normal and mirror heads) loaded by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

# fp32 against fp32 with different summation orders
ATOL = 1e-5
SMALL = dict(depth=4, width=64, skips=(2,), N_emb_xyz=4, N_emb_dir=2)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=0)


def _jax_params(jf, seed=0):
    return jax.tree_util.tree_map(np.array,
                                  jf.init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-8.0, 8.0, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return xyz, d


@pytest.mark.parametrize("n_freqs", [10, 4])
def test_posenc_matches_jax(points, n_freqs):
    """|x| up to 8: the top band's argument reaches 2⁹·8 = 4096 rad, where
    the phase-shifted cos band sin(f·x + π/2) and cos(f·x) would differ by
    up to 2.4e-4; the port keeps the JAX formulation."""
    from mirror_nerf_tpu.models.embedding import posenc as jposenc
    from mirror_nerf_tpu_torch.models.embedding import posenc, posenc_dim

    x = points[0]
    got = posenc(torch.from_numpy(x), n_freqs)
    assert got.shape == (64, posenc_dim(3, n_freqs))
    _close(jposenc(jnp.asarray(x), n_freqs), got)
    # layout: raw input first, then per band a sin block and a cos block
    np.testing.assert_array_equal(got[:, :3].numpy(), x)
    f = 2.0 ** (n_freqs - 1)
    np.testing.assert_allclose(got[:, -6:-3].numpy(),
                               np.sin(np.float64(f) * x), atol=1e-3)


@pytest.mark.parametrize("arch", ["small", "full"])
def test_field_modules_match_jax(points, arch):
    kw = SMALL if arch == "small" else {}
    jf, tf = JaxField(**kw), TorchField(**kw)
    assert tf.in_xyz == jf.in_xyz and tf.in_dir == jf.in_dir
    pj = _jax_params(jf)
    pt = params_from_numpy(pj)
    n = 64 if arch == "small" else 8
    xyz, d = points[0][:n], points[1][:n]
    s_j, g_j = jf.density(pj, jnp.asarray(xyz))
    s_t, g_t = tf.density(pt, torch.from_numpy(xyz))
    _close(s_j, s_t)
    _close(g_j, g_t)
    _close(jf.color(pj, g_j, jnp.asarray(d)),
           tf.color(pt, g_t, torch.from_numpy(d)))
    _close(jf.normal_head(pj, g_j), tf.normal_head(pt, g_t))
    _close(jf.mirror_head(pj, g_j), tf.mirror_head(pt, g_t))


def test_init_has_the_jax_structure():
    """Same leaves, shapes and init bounds U(±1/sqrt(fan_in)) as the JAX
    field, so npz checkpoints of either package load in the other."""
    from mirror_nerf_tpu_torch.train.checkpoints import _leaves

    for kw in (SMALL, {}):
        jf, tf = JaxField(**kw), TorchField(**kw)
        pj = dict(_leaves(_jax_params(jf)))
        pt = dict(_leaves(tf.init(torch.Generator().manual_seed(0))))
        assert set(pj) == set(pt)
        for k in pj:
            assert tuple(pt[k].shape) == pj[k].shape, k
            bound = 1.0 / np.sqrt(pj[k.rsplit("/", 1)[0] + "/w"].shape[0])
            assert float(pt[k].abs().max()) <= bound + 1e-7, k


def test_sigma_gradient_matches_jax(points):
    """∇σ through the plain renderer's autograd path
    (`density_with_grad_reference`) vs JAX `_density_with_grad`."""
    from mirror_nerf_tpu.render.renderer import _density_with_grad
    from mirror_nerf_tpu_torch.ops.fused_cp_train import \
        density_with_grad_reference

    jf, tf = JaxField(**SMALL), TorchField(**SMALL)
    pj = _jax_params(jf, seed=1)
    xyz = points[0][:32] * 0.25  # |x| ≤ 2: gradients of order 1-100
    s_j, g_j, grad_j = _density_with_grad(jf, pj, jnp.asarray(xyz))
    s_t, g_t, grad_t = density_with_grad_reference(
        tf, params_from_numpy(pj), torch.from_numpy(xyz))
    _close(s_j, s_t)
    _close(g_j, g_t)
    # ∇σ sums posenc derivatives up to 2³ = 8 times larger than the values
    scale = max(1.0, float(np.abs(np.asarray(grad_j)).max()))
    _close(grad_j, grad_t, atol=ATOL * scale)


def test_npz_round_trip_both_ways(tmp_path):
    from mirror_nerf_tpu.train import checkpoints as jck
    from mirror_nerf_tpu_torch.train import checkpoints as tck

    jf, tf = JaxField(**SMALL), TorchField(**SMALL)
    pj = {"coarse": _jax_params(jf, 0), "fine": _jax_params(jf, 1)}
    jck.save_pytree(str(tmp_path / "jax.npz"), pj)
    like = {"coarse": tf.init(), "fine": tf.init()}
    got = tck.load_params_any(str(tmp_path / "jax.npz"), like)
    tck.save_pytree(str(tmp_path / "torch.npz"), got)
    back = jck.load_pytree(str(tmp_path / "torch.npz"), pj)
    for (k, a), (_, b), (_, c) in zip(tck._leaves(pj), tck._leaves(got),
                                      tck._leaves(back)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=k)


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "no_heads"])
def test_lightning_ckpt_loads_like_jax(tmp_path, heads):
    from mirror_nerf_tpu.train import checkpoints as jck
    from mirror_nerf_tpu_torch.train import checkpoints as tck

    kw = dict(predict_normal=heads, predict_mirror_mask=heads)
    jf, tf = JaxField(**kw), TorchField(**kw)
    pj = {"coarse": _jax_params(jf, 0), "fine": _jax_params(jf, 1)}
    path = str(tmp_path / "epoch=3.ckpt")
    tck.save_torch_ckpt(path, pj)
    sd = torch.load(path, weights_only=False)["state_dict"]
    assert tuple(sd["nerf_fine.xyz_encoding_5.0.weight"].shape) == (256, 319)
    assert ("nerf_coarse.is_mirror_net.2.bias" in sd) == heads
    assert ("nerf_fine.normal_net.1.weight" in sd) == heads
    like = {"coarse": tf.init(), "fine": tf.init()}
    got = tck.load_params_any(path, like)
    want = jck.load_params_any(path, pj)
    leaves = list(tck._leaves(got))
    assert [k for k, _ in leaves] == [k for k, _ in tck._leaves(pj)]
    for (k, a), (_, b), (_, c) in zip(leaves, tck._leaves(want),
                                      tck._leaves(pj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
        np.testing.assert_array_equal(a.numpy(), c, err_msg=k)


def test_hash_grid_ckpt_is_refused(tmp_path):
    from mirror_nerf_tpu_torch.train.checkpoints import load_params_any

    path = str(tmp_path / "tcnn.ckpt")
    torch.save({"state_dict": {"nerf_coarse.encoder.params":
                               torch.zeros(16)}}, path)
    tf = TorchField(**SMALL)
    # the hash-grid layout loads into the hash-grid model only
    # (tests/test_torch_port_ngp_slice.py loads it there)
    with pytest.raises(ValueError, match="nerf_tcnn only"):
        load_params_any(path, {"coarse": tf.init()})
