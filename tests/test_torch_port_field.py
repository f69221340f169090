"""Port parity, field and sampling: the CP-grid encoder, SH, the field heads
and depth sampling of `mirror_nerf_tpu_torch` against `mirror_nerf_tpu` on
the same numpy inputs and the same (JAX-initialized) parameters, carried
over by the npz weights bridge. Plus the bridge's bitwise round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

LEVELS = ((16, 8), (32, 8))
# fp32 against fp32 with different summation orders
ATOL = 1e-5


@pytest.fixture(scope="module")
def fields():
    jf = JaxField(bound=2.0, grid_levels=LEVELS)
    tf = TorchField(bound=2.0, grid_levels=LEVELS)
    pj = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(0)))
    return jf, tf, pj, params_from_numpy(pj)


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-2.4, 2.4, (64, 3)).astype(np.float32)  # some outside
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return xyz, d


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=0)


def test_cpgrid_encode_matches_jax(fields, points):
    from mirror_nerf_tpu.ops.cpgrid import cpgrid_encode as jenc
    from mirror_nerf_tpu_torch.ops.cpgrid import cpgrid_encode as tenc

    jf, tf, pj, pt = fields
    x01 = (points[0] + 2.0) / 4.0
    _close(jenc(pj["grid"], x01, jf.cp_spec),
           tenc(pt["grid"], torch.from_numpy(x01), tf.cp_spec))


def test_sh_encode_matches_jax(points):
    from mirror_nerf_tpu.ops.sh import sh_encode as jsh
    from mirror_nerf_tpu_torch.ops.sh import sh_encode as tsh

    d = points[1]
    for degree in (1, 2, 3, 4):
        _close(jsh(d, degree), tsh(torch.from_numpy(d), degree))


def test_field_heads_match_jax(fields, points):
    jf, tf, pj, pt = fields
    xyz, d = points
    sj, gj = jf.density(pj, xyz)
    st, gt = tf.density(pt, torch.from_numpy(xyz))
    _close(sj, st)
    _close(gj, gt)
    _close(jf.color(pj, gj, d), tf.color(pt, gt, torch.from_numpy(d)))
    _close(jf.normal_head(pj, gj), tf.normal_head(pt, gt))
    _close(jf.mirror_head(pj, gj), tf.mirror_head(pt, gt))


def test_sampling_det_matches_jax():
    from mirror_nerf_tpu.core import sampling as js
    from mirror_nerf_tpu_torch.core import sampling as ts

    rng = np.random.default_rng(1)
    n, s = 32, 16
    near = rng.uniform(0.05, 0.5, (n, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    zj = js.stratified_z_vals(key, near, far, s, False, 0.0)
    zt = ts.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far),
                              s, False, 0.0)
    np.testing.assert_allclose(np.asarray(zj), zt.numpy(), atol=1e-6, rtol=0)
    zdj = js.stratified_z_vals(key, near, far, s, True, 0.0)
    zdt = ts.stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far),
                               s, True, 0.0)
    # disparity sampling goes through two reciprocals: a few ulp, relative
    np.testing.assert_allclose(np.asarray(zdj), zdt.numpy(), rtol=1e-6,
                               atol=0)

    z = np.asarray(zj)
    w = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32)
    w[:4] = 0.0  # empty rays: the eps floor makes the PDF uniform
    w[4:8, 5] = 50.0  # peaked rays
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    pj = js.sample_pdf(key, bins, w[:, 1:-1], 24, det=True)
    pt = ts.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w[:, 1:-1]),
                       24, det=True)
    # The inverse CDF divides by a bin's pdf, which amplifies ulp-level CDF
    # differences (XLA:CPU accumulates the cumsum in float32 left to right,
    # torch's CPU cumsum in float64): measured up to 6.6e-6 on these depths.
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-5, rtol=0)
    mj = js.merge_fine_z_vals(key, z, w, 24, 0.0)
    mt = ts.merge_fine_z_vals(torch.from_numpy(z), torch.from_numpy(w), 24,
                              0.0)
    np.testing.assert_allclose(np.asarray(mj), mt.numpy(), atol=1e-5, rtol=0)
    assert (np.diff(mt.numpy(), axis=-1) >= 0).all()


def test_mathutil_matches_jax(points):
    from mirror_nerf_tpu.core import mathutil as jm
    from mirror_nerf_tpu_torch.core import mathutil as tm

    xyz, d = points
    v = np.concatenate([xyz, np.zeros((2, 3), np.float32)])  # zero rows
    _close(jm.l2_normalize(v), tm.l2_normalize(torch.from_numpy(v)))
    n = np.array(jm.l2_normalize(xyz))
    _close(jm.reflect(d, n), tm.reflect(torch.from_numpy(d),
                                        torch.from_numpy(n)))


def test_npz_bridge_round_trip_is_bitwise(fields, tmp_path):
    """JAX save_pytree -> port load -> port save -> JAX load_pytree."""
    from mirror_nerf_tpu.train import checkpoints as jck
    from mirror_nerf_tpu_torch.train import checkpoints as tck

    jf, tf, _, _ = fields
    pj = {"coarse": jf.init(jax.random.PRNGKey(3)),
          "fine": jf.init(jax.random.PRNGKey(4))}
    jck.save_pytree(str(tmp_path / "jax.npz"), pj)

    like = {"coarse": tf.init(torch.Generator().manual_seed(0)),
            "fine": tf.init(torch.Generator().manual_seed(1))}
    pt = tck.load_params_any(str(tmp_path / "jax.npz"), like)
    assert torch.equal(pt["coarse"]["grid"]["axes"][0][1],
                       torch.from_numpy(np.asarray(
                           pj["coarse"]["grid"]["axes"][0][1])))
    tck.save_pytree(str(tmp_path / "torch.npz"), pt)

    back = jck.load_pytree(str(tmp_path / "torch.npz"), pj)
    flat_a = jax.tree_util.tree_leaves_with_path(pj)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for (path, a), b in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    with np.load(tmp_path / "jax.npz") as fa, \
            np.load(tmp_path / "torch.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert "coarse/grid/axes/0/1" in fb.files
        assert "fine/sigma_net/0/w" in fb.files


def test_params_from_numpy_keeps_jax_layout(fields):
    jf, tf, pj, pt = fields
    assert tuple(pt["sigma_net"][0]["w"].shape) == (32, 64)  # (in, out)
    assert tuple(pt["is_mirror"][0]["b"].shape) == (32,)
    assert len(pt["grid"]["axes"]) == 3
    assert tuple(pt["grid"]["fold"].shape) == (16, 32)
    np.testing.assert_array_equal(pt["color_net"][2]["w"].numpy(),
                                  np.asarray(pj["color_net"][2]["w"]))
    # the port's own init has the same tree structure and shapes
    own = tf.init(torch.Generator().manual_seed(0))
    shapes_own = jax.tree_util.tree_map(lambda t: tuple(t.shape), own)
    shapes_jax = jax.tree_util.tree_map(lambda a: tuple(jnp.shape(a)), pj)
    assert shapes_own == shapes_jax
