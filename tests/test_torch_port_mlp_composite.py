"""Port parity, the flagship PE-MLP composite: the port's plain version
(`mlp_rays_composite_reference`, what CPU tensors run) against the JAX
Pallas kernel `fused_t_rays_eval` in interpret mode at full width (the JAX
kernel's only width), a saturating field against the cumprod compositing,
the CPU/CUDA dispatch contract, the gradient guard and the packed layout —
and, on a machine with a card only, the CUDA kernel against the plain
version."""

import jax
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.ops.pallas.fused_mlp_t import fused_t_rays_eval
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.ops import fused_mlp_t
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

KEYS = ("weights", "opacity", "rgb", "normal", "mirror", "depth")
# fp32 against fp32 (the JAX kernel runs fp32 in interpret mode): other
# summation orders through the 8-layer trunk only; measured ≤ 4e-7
ATOL = 1e-5


def _params(jf, sigma_scale: float):
    """JAX-initialized params with the σ column made positive and scaled:
    random-init σ is about half negative, and relu weights would be thin."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * sigma_scale
    return p


def _rays(n: int, s: int, seed: int):
    """Rays from |o| ~ 2 through the field; positions reach |x| ≈ 8."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, (n, s)), -1).astype(np.float32)
    return o, d, z


@pytest.fixture(scope="module")
def fields():
    return JaxField(), TorchField()


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n_samples", [16, 64])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_plain_composite_matches_jax_kernel(fields, act, sigma_only,
                                            n_samples):
    jf, tf = fields
    o, d, z = _rays(4, n_samples, seed=n_samples)
    p = _params(jf, 5.0)
    want = fused_t_rays_eval(jf, p, o, d, d, z, sigma_only=sigma_only,
                             interpret=True, sigma_act=act)
    got = fused_mlp_t.fused_t_rays_composite(
        tf, params_from_numpy(p), *_torch(o, d, d, z),
        sigma_only=sigma_only, sigma_act=act)
    assert set(got) == set(want)
    assert float(got["weights"].max()) > 0.1  # not vacuous
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_saturating_field_weights_sum_le_one(fields):
    """σ ×2000: per-ray Σw ≤ 1, the weights match the cumprod compositing
    of the unfused renderer, and the whole output matches the JAX kernel."""
    from mirror_nerf_tpu_torch.render.renderer import _composite_weights

    jf, tf = fields
    o, d, z = _rays(4, 16, seed=3)
    p = _params(jf, 2000.0)
    pt = params_from_numpy(p)
    ot, dt, zt = _torch(o, d, z)
    got = fused_mlp_t.fused_t_rays_composite(tf, pt, ot, dt, dt, zt)
    n, s = z.shape
    xyz = (ot[:, None, :] + dt[:, None, :] * zt[..., None]).reshape(-1, 3)
    sigma, _ = tf.density(pt, xyz)
    w_ref = _composite_weights(sigma.reshape(n, s), zt, torch.zeros_like(zt))
    np.testing.assert_allclose(got["weights"].numpy(), w_ref.numpy(),
                               atol=1e-5)
    assert (got["weights"].sum(-1) <= 1.0 + 1e-5).all()
    assert float(got["opacity"].min()) > 0.99  # really saturated
    want = fused_t_rays_eval(jf, p, o, d, d, z, interpret=True)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_cpu_tensors_take_the_plain_version(fields):
    jf, tf = fields
    o, d, z = _rays(3, 8, seed=4)
    pt = params_from_numpy(_params(jf, 5.0))
    before = fused_mlp_t.launches
    got = fused_mlp_t.fused_t_rays_composite(tf, pt, *_torch(o, d, d, z))
    ref = fused_mlp_t.mlp_rays_composite_reference(tf, pt,
                                                   *_torch(o, d, d, z))
    assert fused_mlp_t.launches == before  # no kernel on the CPU
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k


def test_other_devices_and_cpu_launch_raise(fields):
    """No quiet fallback: a device that is neither the CPU nor CUDA raises,
    and the kernel's launcher refuses tensors off the card."""
    jf, tf = fields
    o, d, z = _rays(3, 8, seed=5)
    pt = params_from_numpy(_params(jf, 5.0))
    args = [t.to("meta") for t in _torch(o, d, d, z)]
    with pytest.raises(ValueError, match="no fused PE-MLP path"):
        fused_mlp_t.fused_t_rays_composite(tf, pt, *args)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_t.fused_t_composite_cuda(tf, pt, *_torch(o, d, d, z),
                                           sigma_only=False,
                                           sigma_act="relu")


def test_grad_guard(fields):
    """The forward-only kernel refuses, under grad mode, a parameter or an
    input that requires grad (its outputs would carry no graph); the guard
    comes before any other check, so it holds for CPU tensors too."""
    jf, tf = fields
    o, d, z = _rays(2, 8, seed=6)
    pt = params_from_numpy(_params(jf, 5.0))
    pt["trunk"][3]["w"].requires_grad_(True)
    args = _torch(o, d, d, z)
    with pytest.raises(ValueError, match="forward-only"):
        fused_mlp_t.fused_t_composite_cuda(tf, pt, *args, sigma_only=False,
                                           sigma_act="relu")
    pt["trunk"][3]["w"].requires_grad_(False)
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        fused_mlp_t.fused_t_composite_cuda(tf, pt, *args, sigma_only=True,
                                           sigma_act="relu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fused_mlp_t.fused_t_composite_cuda(tf, pt, *args, sigma_only=True,
                                           sigma_act="relu")


# head and posenc variants the kernel takes, as the JAX kernel does
VARIANTS = {"no_normal": dict(predict_normal=False),
            "no_mirror": dict(predict_mirror_mask=False),
            "no_heads": dict(predict_normal=False, predict_mirror_mask=False),
            "emb6_2": dict(N_emb_xyz=6, N_emb_dir=2)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_composite_matches_jax_kernel_variants(variant):
    """A field without one or both heads, or with other posenc
    frequencies: the plain version against the JAX kernel, which takes them
    all; a missing head has no output key."""
    kw = VARIANTS[variant]
    jf, tf = JaxField(**kw), TorchField(**kw)
    assert tf.supports_fused
    o, d, z = _rays(4, 16, seed=7)
    p = _params(jf, 5.0)
    want = fused_t_rays_eval(jf, p, o, d, d, z, interpret=True)
    got = fused_mlp_t.fused_t_rays_composite(tf, params_from_numpy(p),
                                             *_torch(o, d, d, z))
    assert ("normal" in got) == tf.predict_normal
    assert ("mirror" in got) == tf.predict_mirror_mask
    assert float(got["weights"].max()) > 0.1  # not vacuous
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_supports_fused_is_the_kernels_architecture():
    """The dispatch: `supports_fused` is the JAX property's range (a width
    that is a multiple of 128, any depth and skips, ≤ 20 posenc
    frequencies each, any heads), which the rows kernels take;
    `supports_fused_t`, the composite kernel's, is the default trunk
    within it; outside the range neither."""
    jf = JaxField()
    assert TorchField().supports_fused and TorchField().supports_fused_t
    for kw in (*VARIANTS.values(), dict(N_emb_xyz=20, N_emb_dir=0)):
        assert TorchField(**kw).supports_fused, kw
        assert TorchField(**kw).supports_fused_t, kw
    for kw in (dict(width=128), dict(width=384), dict(depth=6),
               dict(skips=(3,)), dict(depth=6, skips=(2, 4)),
               dict(width=512, depth=1, skips=())):
        f = TorchField(**kw)
        assert f.supports_fused and not f.supports_fused_t, kw
        assert f.supports_fused == JaxField(**kw).supports_fused, kw
    for kw in (dict(width=96), dict(width=200), dict(N_emb_xyz=21),
               dict(N_emb_dir=21)):
        f = TorchField(**kw)
        assert not f.supports_fused and not f.supports_fused_t, kw
        assert f.supports_fused == JaxField(**kw).supports_fused, kw
    assert jf.supports_fused


def test_fused_field_off_the_kernel_raises_off_the_cpu():
    """--fused_field with a flagship field outside the rows kernels'
    range: the CPU renders it through the plain field modules (as the JAX
    package does), any other device raises, naming the limit. A trunk
    inside the range but not the default (width 128) takes the rows route
    on every device, whatever `fused_t` says: the CPU its plain version,
    another device the kernel's dispatch (which refuses a meta tensor)."""
    from mirror_nerf_tpu_torch.render.renderer import (RenderSettings,
                                                       _inference)

    o, d, z = _torch(*_rays(2, 8, seed=8))
    meta = [t.to("meta") for t in (o, d, z)]
    rs = RenderSettings(fused_field=True, compute_normal=False,
                        noise_std=0.0, test_time=True)
    tf = TorchField(width=96)
    p = tf.init(torch.Generator().manual_seed(0))
    res = _inference(tf, p, "fine", o, d, z, d, rs, {}, False)
    assert res["rgb_fine"].shape == (2, 3)
    with pytest.raises(NotImplementedError,
                       match="multiple of 128 and at most 20 posenc"):
        _inference(tf, p, "fine", meta[0], meta[1], meta[2], meta[1], rs,
                   {}, False)
    tf = TorchField(width=128)
    p = tf.init(torch.Generator().manual_seed(0))
    res = _inference(tf, p, "fine", o, d, z, d, rs, {}, False)
    want = _inference(tf, p, "fine", o, d, z, d,
                      RenderSettings(fused_field=False, compute_normal=False,
                                     noise_std=0.0, test_time=True), {},
                      False)
    for k in ("rgb_fine", "depth_fine", "weights_fine"):
        np.testing.assert_allclose(res[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="no fused PE-MLP rows path"):
        _inference(tf, p, "fine", meta[0], meta[1], meta[2], meta[1], rs,
                   {}, False)


def test_packed_weights_match_kernel_layout(fields):
    """The packed buffer holds the weight stream in `net_offsets` order
    (.cu): each streamed layer (trunk 0..7 with K 64, 256 ×3, 320, 256 ×3;
    normal0 and mirror0 256→128, xyz_final 256→256, dir_enc 288→128) as
    K/8 k-steps of a TF32 hi and a lo plane, a plane N rows of 8 K values
    in the 32-byte swizzle; then the fp32 leaves, each padded to 4 floats:
    the trunk's biases, σ 256 + 1, xyz_final b, dir_enc b, rgb 128×3 + 3,
    normal 128 + 128×3 + 3, mirror 128 + 128 + 1."""
    from mirror_nerf_tpu_torch.ops.fused_cp import tf32_round

    jf, tf = fields
    pt = params_from_numpy(_params(jf, 1.0))
    nets = fused_mlp_t._pack(pt)
    trunk = 2 * 256 * (64 + 256 * 6 + 320)
    heads = 2 * (256 * 128 * 2 + 256 * 256 + 288 * 128)
    raw = (8 * 256 + 256 + 4 + 256 + 128 + 128 * 3 + 4
           + 128 + 128 * 3 + 4 + 128 + 128 + 4)
    assert nets.numel() == trunk + heads + raw
    at = trunk + heads
    assert torch.equal(nets[at + 3 * 256:at + 4 * 256], pt["trunk"][3]["b"])
    sw = at + 8 * 256
    assert torch.equal(nets[sw:sw + 256], pt["sigma"]["w"][:, 0])
    assert float(nets[sw + 256]) == float(pt["sigma"]["b"][0])
    # the skip layer's first k-step: posenc rows 0..7 in their own order, a
    # row n of the hi plane their TF32 values in column n, the two 16-B
    # halves swapped where n mod 8 ≥ 4
    off4 = 2 * 256 * (64 + 3 * 256)
    plane = nets[off4:off4 + 8 * 256].reshape(256, 8)
    hi = tf32_round(pt["trunk"][4]["w"][:8]).T
    swapped = ((torch.arange(256) // 4) % 2 == 1)[:, None]
    assert torch.equal(plane, torch.where(
        swapped, hi[:, [4, 5, 6, 7, 0, 1, 2, 3]], hi))
    assert float(nets[-4]) == float(pt["is_mirror"][1]["b"][0])
    # without heads the stream loses normal0 and mirror0, the buffer ends at
    # rgb's bias
    bare = {k: v for k, v in pt.items() if k not in ("normal", "is_mirror")}
    nets = fused_mlp_t._pack(bare)
    assert nets.numel() == trunk + 2 * (256 * 256 + 288 * 128) + (
        8 * 256 + 256 + 4 + 256 + 128 + 128 * 3 + 4)
    assert torch.equal(nets[-4:-1], pt["rgb"]["b"])


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples,n_rays",
                         [(64, 300), (128, 301), (80, 237), (192, 37)],
                         ids=["s64", "s128", "s80_ragged", "s192_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_cuda_kernel_matches_plain(fields, act, sigma_only, n_samples,
                                   n_rays):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    jf, tf = fields
    o, d, z = _rays(n_rays, n_samples, seed=n_samples)
    pt = params_from_numpy(_params(jf, 5.0), device="cuda")
    args = [t.cuda() for t in _torch(o, d, d, z)]
    before = fused_mlp_t.launches
    with torch.no_grad():
        got = fused_mlp_t.fused_t_rays_composite(
            tf, pt, *args, sigma_only=sigma_only, sigma_act=act)
        torch.cuda.synchronize()
        assert fused_mlp_t.launches == before + 1
        ref = fused_mlp_t.mlp_rays_composite_reference(
            tf, pt, *args, sigma_only=sigma_only, sigma_act=act)
    assert float(got["weights"].sum(-1).max()) <= 1.0 + 1e-5
    for k in ref:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_kernel_variants_match_plain(variant, sigma_only):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = VARIANTS[variant]
    jf, tf = JaxField(**kw), TorchField(**kw)
    o, d, z = _rays(203, 96, seed=9)
    pt = params_from_numpy(_params(jf, 5.0), device="cuda")
    args = [t.cuda() for t in _torch(o, d, d, z)]
    before = fused_mlp_t.launches
    with torch.no_grad():
        got = fused_mlp_t.fused_t_rays_composite(tf, pt, *args,
                                                 sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert fused_mlp_t.launches == before + 1
        ref = fused_mlp_t.mlp_rays_composite_reference(
            tf, pt, *args, sigma_only=sigma_only)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
