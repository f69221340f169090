"""Port parity, the fused CP composite: the port's plain version
(`cp_rays_composite_reference`, what CPU tensors run) against the JAX Pallas
kernel `fused_cp_rays_composite` in interpret mode, the δ_inf regressions
ported from tests/test_fused_cp.py, the CPU/CUDA dispatch contract, and —
on a machine with a card only — the CUDA kernel against the plain version.
"""

import jax
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.ops.pallas.fused_cp import \
    fused_cp_rays_composite as jax_composite
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.ops import fused_cp
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

LEVELS = ((16, 8), (32, 8))
KEYS = ("weights", "opacity", "rgb", "normal", "mirror", "depth")
# fp32 against fp32; the kernel sums in another order than the plain version
ATOL = 1e-5


def _params(jf, sigma_scale: float):
    """JAX-initialized params with the σ column made positive and scaled:
    random-init σ is mostly negative, which would make relu weights all 0."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    p["sigma_net"][1]["w"][:, 0] = (np.abs(p["sigma_net"][1]["w"][:, 0])
                                    * sigma_scale)
    return p


@pytest.fixture(scope="module")
def setup():
    jf = JaxField(bound=2.0, grid_levels=LEVELS)
    tf = TorchField(bound=2.0, grid_levels=LEVELS)
    rng = np.random.default_rng(0)
    n, s = 6, 16
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 2.5, (n, s)), -1).astype(np.float32)
    return jf, tf, o, d, z


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_plain_composite_matches_jax_kernel(setup, act, sigma_only):
    jf, tf, o, d, z = setup
    p = _params(jf, 5.0)
    want = jax_composite(jf, p, o, d, d, z, sigma_only=sigma_only,
                         interpret=True, sigma_act=act)
    got = fused_cp.fused_cp_rays_composite(
        tf, params_from_numpy(p), *_torch(o, d, d, z),
        sigma_only=sigma_only, sigma_act=act)
    assert set(got) == set(want)
    assert float(got["weights"].max()) > 0.1  # not vacuous
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_prefix_weights_with_delta_inf_sentinel():
    """Port of tests/test_fused_cp.py::test_prefix_weights_with_delta_inf_
    sentinel: the exclusive prefix must not be inclusive-minus-self, which
    cancels against the 1e10 sentinel on each ray's last sample."""
    s, n = 16, 8
    rng = np.random.default_rng(0)
    sd = rng.uniform(0.0, 1.5, (n, s)).astype(np.float32)
    sd[:, -1] = 1e10
    got = fused_cp.prefix_weights(torch.from_numpy(sd)).numpy()
    x = sd.astype(np.float64)
    cum = np.cumsum(x, -1) - x
    want = np.exp(-cum) * (1.0 - np.exp(-x))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got.sum(-1) <= 1.0 + 1e-5).all()


def test_composite_opaque_scene_weights_sum_le_one(setup):
    """Port of tests/test_fused_cp.py::test_composite_opaque_scene_weights_
    sum_le_one: on a saturating-σ field per-ray weights sum to ≤ 1 and match
    the cumprod compositing of the unfused renderer — and the JAX kernel."""
    from mirror_nerf_tpu_torch.render.renderer import _composite_weights

    jf, tf, o, d, z = setup
    p = _params(jf, 40.0)
    pt = params_from_numpy(p)
    ot, dt, zt = _torch(o, d, z)
    got = fused_cp.fused_cp_rays_composite(tf, pt, ot, dt, dt, zt)
    n, s = z.shape
    xyz = (ot[:, None, :] + dt[:, None, :] * zt[..., None]).reshape(-1, 3)
    sigma, _ = tf.density(pt, xyz)
    w_ref = _composite_weights(sigma.reshape(n, s), zt, torch.zeros_like(zt))
    np.testing.assert_allclose(got["weights"].numpy(), w_ref.numpy(),
                               atol=2e-3)
    assert (got["weights"].sum(-1) <= 1.0 + 1e-4).all()
    assert float(got["opacity"].min()) > 0.99  # really saturated
    want = jax_composite(jf, p, o, d, d, z, interpret=True)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_cpu_tensors_take_the_plain_version(setup):
    jf, tf, o, d, z = setup
    pt = params_from_numpy(_params(jf, 5.0))
    before = fused_cp.launches
    got = fused_cp.fused_cp_rays_composite(tf, pt, *_torch(o, d, d, z))
    ref = fused_cp.cp_rays_composite_reference(tf, pt, *_torch(o, d, d, z))
    assert fused_cp.launches == before  # no kernel on the CPU
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k


def test_cuda_launcher_refuses_cpu_tensors(setup):
    """No quiet fallback: the kernel path raises on tensors off the card."""
    jf, tf, o, d, z = setup
    pt = params_from_numpy(_params(jf, 5.0))
    with pytest.raises(ValueError, match="CUDA"):
        fused_cp.fused_cp_composite_cuda(tf, pt, *_torch(o, d, d, z),
                                         sigma_only=False, sigma_act="relu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build fails loudly; nothing is built or
    loaded in its place."""
    from mirror_nerf_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library(fused_cp._LIB)
    assert not (tmp_path / "kernels").exists()


def test_packed_nets_match_kernel_layout(setup):
    """The packed buffer has the float count the .cu expects (`NETS` after
    the fold): the fold ΣR'×32 with each level's rank R' padded to 16, then
    s1 32×64, s2 64×16, c1 32×64, c2 64×64, c3 64×8, n1 16×64, n2 64×8,
    m1 16×32, m2 32×8, m1 b 32, m2 b 1; s2's σ column and the biases land
    where the kernel reads them, padded rows and columns are zero; the
    tables are padded to R' with zeros at the offsets the entry takes."""
    jf, tf, _, _, _ = setup
    pt = params_from_numpy(_params(jf, 1.0))
    nets = fused_cp._pack_nets(pt, LEVELS)
    sum_rp = sum(fused_cp.padded_rank(r) for _, r in LEVELS)
    assert sum_rp == 32
    assert fused_cp.NETS == (32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 8
                             + 16 * 64 + 64 * 8 + 16 * 32 + 32 * 8 + 32 + 1)
    assert nets.numel() == sum_rp * 32 + fused_cp.NETS
    s2 = pt["sigma_net"][1]["w"]
    off = sum_rp * 32 + 32 * 64
    s2p = nets[off:off + 64 * 16].reshape(64, 16)
    assert torch.equal(s2p, s2[fused_cp.c_order(64)])
    assert float(nets[-1]) == float(pt["is_mirror"][1]["b"][0])
    assert torch.equal(nets[-33:-1], pt["is_mirror"][0]["b"])
    # each level's ranks 8..15 are padding: zero fold rows
    fold = nets[:sum_rp * 32].reshape(sum_rp, 32)
    src = fused_cp.quad_order(16)
    for lvl in range(2):
        for row in range(16):
            want = (pt["grid"]["fold"][8 * lvl + src[row]] if src[row] < 8
                    else torch.zeros(32))
            assert torch.equal(fold[16 * lvl + row], want), (lvl, row)
    tables, offsets = fused_cp._pack_tables(pt, LEVELS)
    assert offsets[:4] == [0, 16 * 16, 2 * 16 * 16, 3 * 16 * 16]
    assert tables.numel() == 3 * (16 + 32) * 16
    assert list(fused_cp._levels_c(LEVELS)[2]) == offsets
    t0 = tables[:16 * 16].reshape(16, 16)
    assert torch.equal(t0[:, :8], pt["grid"]["axes"][0][0])
    assert not t0[:, 8:].any()


@pytest.mark.gpu
# 80 and 192 (64 + 128, the default N_importance) leave threads of the
# 256-thread block without a ray
@pytest.mark.parametrize("n_samples", [16, 80, 192],
                         ids=["one_warp", "three_warps_padded",
                              "six_warps_one_ray"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_cuda_kernel_matches_plain(setup, act, sigma_only, n_samples):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    jf, tf, o, d, _ = setup
    rng = np.random.default_rng(1)
    n = 37  # not a multiple of the rays per block
    o = np.resize(o, (n, 3))
    d = np.resize(d, (n, 3))
    z = np.sort(rng.uniform(0.1, 2.5, (n, n_samples)), -1).astype(np.float32)
    pt = params_from_numpy(_params(jf, 5.0), device="cuda")
    args = [t.cuda() for t in _torch(o, d, d, z)]
    before = fused_cp.launches
    got = fused_cp.fused_cp_rays_composite(tf, pt, *args,
                                           sigma_only=sigma_only,
                                           sigma_act=act)
    torch.cuda.synchronize()
    assert fused_cp.launches == before + 1
    ref = fused_cp.cp_rays_composite_reference(tf, pt, *args,
                                               sigma_only=sigma_only,
                                               sigma_act=act)
    for k in ref:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
