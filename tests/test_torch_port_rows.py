"""Port parity, the per-sample kernels of the σ-noise passes and point
queries: the port's plain versions (what CPU tensors run) against the JAX
package —

  * CP rows (`fused_cp_rays_eval`) and the CP composite from per-sample
    inputs (`fused_cp_forward_composite`) against the JAX Pallas kernels in
    interpret mode, which run fp32 there (the latter with MNERF_CP_RAYMODE=0
    for the JAX call, its only route to that kernel);
  * flagship rows (`fused_rays_eval`) and points (`fused_packed_eval`,
    `fused_field_eval`) against the JAX field modules in fp32, and against
    the JAX Pallas kernels in interpret mode at the JAX tests' own bars
    (those kernels cast the weights and rows to bf16);

the CPU/CUDA dispatch contract and the gradient guard — and, on a machine
with a card only, each CUDA mode against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.core.mathutil import l2_normalize as jax_l2_normalize
from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxMLP
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxCP
from mirror_nerf_tpu.ops.pallas import fused_cp as jax_fused_cp
from mirror_nerf_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchMLP
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchCP
from mirror_nerf_tpu_torch.ops import fused_cp, fused_mlp
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

LEVELS = ((16, 8), (32, 8))
# fp32 against fp32 (the field modules, or a JAX kernel that runs fp32 in
# interpret mode): summation order only. Scaled by the magnitude above 1:
# the saturating fields' raw σ reaches ~1e3
ATOL = 1e-5
# the JAX flagship kernels' bf16 weights and rows, at the bars of
# tests/test_fused_mlp.py (ray mode :111-115, point mode :38-45)
RAY_BARS = {"sigma": 3e-2, "rgb": 1e-2, "normal": 3e-2, "mirror": 1e-2}
POINT_BARS = {"sigma": 2e-2, "rgb": 5e-3, "normal": 2e-2, "mirror": 5e-3}
MLP_VARIANTS = {"both_heads": {}, "no_normal": dict(predict_normal=False),
                "no_mirror": dict(predict_mirror_mask=False),
                "no_heads": dict(predict_normal=False,
                                 predict_mirror_mask=False)}


def _close(got, want, atol=ATOL, err_msg=""):
    """|got − want| ≤ atol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    bar = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=bar, rtol=0,
                               err_msg=err_msg)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rays(n: int, s: int, seed: int, scale: float = 0.3, z_max: float = 2.5):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, z_max, (n, s)), -1).astype(np.float32)
    return o, d, z


# ---------------------------------------------------------------- CP grid


@pytest.fixture(scope="module")
def cp():
    jf = JaxCP(bound=2.0, grid_levels=LEVELS)
    return jf, TorchCP(bound=2.0, grid_levels=LEVELS)


def _cp_params(jf, sigma_scale: float):
    """σ column made positive and scaled: random-init σ is mostly negative."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    p["sigma_net"][1]["w"][:, 0] = (np.abs(p["sigma_net"][1]["w"][:, 0])
                                    * sigma_scale)
    return p


@pytest.mark.parametrize("n_samples", [16, 64])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("sigma_scale", [5.0, 2000.0],
                         ids=["seeded", "saturating"])
def test_cp_rows_match_jax_kernel(cp, sigma_scale, sigma_only, n_samples):
    """37 rays (no multiple of any block), σ raw, rgb, unit normal and
    mirror per sample, against JAX `fused_cp_rays_eval` (fp32 interpret);
    the port keeps the JAX keys, sample-major."""
    jf, tf = cp
    o, d, z = _rays(37, n_samples, seed=n_samples)
    p = _cp_params(jf, sigma_scale)
    want = jax_fused_cp.fused_cp_rays_eval(jf, p, o, d, d, z,
                                           sigma_only=sigma_only,
                                           interpret=True)
    got = fused_cp.fused_cp_rays_eval(tf, params_from_numpy(p),
                                      *_torch(o, d, d, z),
                                      sigma_only=sigma_only)
    assert set(got) == set(want)
    assert float(got["sigma"].max()) > 1.0  # not vacuous
    for k in got:
        w = np.asarray(want[k])
        if k in ("rgb3", "normal3"):  # JAX: channel-major (3, N, S)
            w = np.moveaxis(w, 0, -1)
        assert got[k].shape == w.shape, k
        _close(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_cp_samples_composite_matches_jax_kernel(cp, monkeypatch, act,
                                                 sigma_only):
    """The composite from per-sample x, view dir, z and δ against the JAX
    sample-input composite kernel (`_kernel_composite`, reached with
    MNERF_CP_RAYMODE=0), and against the port's own ray composite."""
    jf, tf = cp
    o, d, z = _rays(37, 16, seed=1)
    p = _cp_params(jf, 5.0)
    monkeypatch.setenv("MNERF_CP_RAYMODE", "0")
    want = jax_fused_cp.fused_cp_rays_composite(
        jf, p, o, d, d, z, sigma_only=sigma_only, interpret=True,
        sigma_act=act)
    monkeypatch.delenv("MNERF_CP_RAYMODE")
    pt = params_from_numpy(p)
    ot, dt, zt = _torch(o, d, z)
    xyz = ot[:, None, :] + dt[:, None, :] * zt[..., None]
    deltas = torch.cat([zt[:, 1:] - zt[:, :-1],
                        torch.full_like(zt[:, :1], 1e10)], -1)
    got = fused_cp.fused_cp_forward_composite(
        tf, pt, xyz, dt[:, None, :].expand_as(xyz), zt, deltas,
        sigma_only=sigma_only, sigma_act=act)
    ray = fused_cp.fused_cp_rays_composite(tf, pt, ot, dt, dt, zt,
                                           sigma_only=sigma_only,
                                           sigma_act=act)
    assert set(got) == set(want) == set(ray)
    assert float(got["weights"].max()) > 0.1  # not vacuous
    for k in got:
        _close(got[k].numpy(), want[k], err_msg=k)
        _close(got[k].numpy(), ray[k].numpy(), atol=1e-6, err_msg=k)


def test_cp_samples_composite_saturating(cp, monkeypatch):
    """σ ×2000: per-ray Σw ≤ 1 (δ_inf = 1e10 on the last sample) and the
    result matches the JAX sample-input kernel."""
    jf, tf = cp
    o, d, z = _rays(9, 16, seed=2)
    p = _cp_params(jf, 2000.0)
    monkeypatch.setenv("MNERF_CP_RAYMODE", "0")
    want = jax_fused_cp.fused_cp_rays_composite(jf, p, o, d, d, z,
                                                interpret=True)
    monkeypatch.delenv("MNERF_CP_RAYMODE")
    ot, dt, zt = _torch(o, d, z)
    xyz = ot[:, None, :] + dt[:, None, :] * zt[..., None]
    deltas = torch.cat([zt[:, 1:] - zt[:, :-1],
                        torch.full_like(zt[:, :1], 1e10)], -1)
    got = fused_cp.fused_cp_forward_composite(
        tf, params_from_numpy(p), xyz, dt[:, None, :].expand_as(xyz), zt,
        deltas)
    assert (got["weights"].sum(-1) <= 1.0 + 1e-5).all()
    assert float(got["opacity"].min()) > 0.99  # really saturated
    for k in got:
        _close(got[k].numpy(), want[k], err_msg=k)


def test_cp_cpu_dispatch_and_refusals(cp):
    """CPU tensors take the plain versions (no launch); another device
    raises; the CUDA launchers refuse CPU tensors and, under grad mode, a
    parameter that requires grad."""
    jf, tf = cp
    o, d, z = _rays(3, 8, seed=3)
    pt = params_from_numpy(_cp_params(jf, 5.0))
    args = _torch(o, d, d, z)
    xyz = args[0][:, None, :] + args[1][:, None, :] * args[3][..., None]
    v = args[1][:, None, :].expand_as(xyz).contiguous()
    before = (fused_cp.launches, fused_cp.launches_rows,
              fused_cp.launches_samples)
    got = fused_cp.fused_cp_rays_eval(tf, pt, *args)
    ref = fused_cp.cp_rays_rows_reference(tf, pt, *args)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    got = fused_cp.fused_cp_forward_composite(tf, pt, xyz, v, args[3],
                                              args[3])
    ref = fused_cp.cp_samples_composite_reference(tf, pt, xyz, v, args[3],
                                                  args[3])
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert (fused_cp.launches, fused_cp.launches_rows,
            fused_cp.launches_samples) == before
    with pytest.raises(ValueError, match="no fused CP path"):
        fused_cp.fused_cp_rays_eval(tf, pt, *[t.to("meta") for t in args])
    with pytest.raises(ValueError, match="CUDA"):
        fused_cp.fused_cp_rows_cuda(tf, pt, *args, sigma_only=False)
    with pytest.raises(ValueError, match="CUDA"):
        fused_cp.fused_cp_samples_composite_cuda(
            tf, pt, xyz.contiguous(), v, args[3], args[3], sigma_only=False,
            sigma_act="relu")
    pt["grid"]["fold"].requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        fused_cp.fused_cp_rows_cuda(tf, pt, *args, sigma_only=True)


# ------------------------------------------------------ flagship PE-MLP


@pytest.fixture(scope="module")
def mlp_params():
    """Full-width JAX-initialized params per head variant, σ column made
    positive (×5), trunk and mirror-head weights ×√6 (He's variance: at the
    plain init the 8 ReLU layers shrink the features to their biases)."""
    out = {}
    for name, kw in MLP_VARIANTS.items():
        p = _plain_init(kw)
        p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * 5.0
        for layer in p["trunk"] + p.get("is_mirror", []):
            layer["w"] *= np.float32(np.sqrt(6.0))
        out[name] = p
    return out


def _plain_init(kw) -> dict:
    """The JAX init as it is, which the JAX kernel tests' bars were set on
    (the bf16 error grows with the values)."""
    return jax.tree_util.tree_map(
        np.array, JaxMLP(**kw).init(jax.random.PRNGKey(0)))


def _jax_field_rows(jf, p, xyz, dirs, sigma_only: bool) -> dict:
    """The JAX field modules (fp32): σ and, unless σ-only, rgb, the unit
    normal and mirror (None where the field lacks the head)."""
    sigma, geo = jf.density(p, jnp.asarray(xyz))
    res = {"sigma": np.asarray(sigma)}
    if sigma_only:
        return res
    res["rgb"] = np.asarray(jf.color(p, geo, jnp.asarray(dirs)))
    res["normal"] = (np.asarray(jax_l2_normalize(jf.normal_head(p, geo)))
                     if jf.predict_normal else None)
    res["mirror"] = (np.ravel(np.asarray(jf.mirror_head(p, geo)))
                     if jf.predict_mirror_mask else None)
    return res


def _split(rows, field, sigma_only: bool, port: bool = True) -> dict:
    """(B, 8) rows (the port's, or a JAX kernel's (B, 128)) -> the keys of
    `_jax_field_rows`. The port's lanes of a missing head are 0 (the JAX
    kernel's epilogue leaves sigmoid(0) = 0.5 in a missing mirror's lane;
    nothing reads it)."""
    rows = np.asarray(rows, np.float32)
    res = {"sigma": rows[:, 0]}
    if sigma_only:
        return res
    res["rgb"] = rows[:, 1:4]
    res["normal"] = rows[:, 4:7] if field.predict_normal else None
    res["mirror"] = rows[:, 7] if field.predict_mirror_mask else None
    if port and not field.predict_normal:
        assert not rows[:, 4:7].any()
    if port and not field.predict_mirror_mask:
        assert not rows[:, 7].any()
    return res


# the JAX kernel runs bf16 matmuls in interpret mode, slowly on the CPU:
# held against it in these cases; every case is held against the modules
_JAX_RAY_KERNEL_CASES = {("both_heads", 16, False), ("both_heads", 64, True),
                         ("no_heads", 16, False)}


# the σ-only rows read no head: the default field covers them
_RAY_CASES = [(v, False, s) for v in sorted(MLP_VARIANTS) for s in (16, 64)]
_RAY_CASES += [("both_heads", True, 16), ("both_heads", True, 64)]


@pytest.mark.parametrize("variant,sigma_only,n_samples", _RAY_CASES,
                         ids=[f"{v}-{'sigma_only' if so else 'full'}-{s}"
                              for v, so, s in _RAY_CASES])
def test_mlp_rays_rows(mlp_params, variant, sigma_only, n_samples):
    """`fused_rays_eval` rows on 5 rays (no multiple of the JAX kernel's
    2048 // S rays a block): the JAX field modules at 1e-5; the JAX kernel
    `fused_rays_eval` (interpret) at its own test's bars."""
    kw = MLP_VARIANTS[variant]
    jf, tf = JaxMLP(**kw), TorchMLP(**kw)
    p = mlp_params[variant]
    o, d, z = _rays(5, n_samples, seed=n_samples, scale=1.0, z_max=4.0)
    rows = fused_mlp.fused_rays_eval(tf, params_from_numpy(p),
                                     *_torch(o, d, d, z),
                                     sigma_only=sigma_only)
    assert rows.shape == (5 * n_samples, 1 if sigma_only else 8)
    got = _split(rows, tf, sigma_only)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    want = _jax_field_rows(jf, p, xyz, np.repeat(d, n_samples, 0),
                           sigma_only)
    assert float(got["sigma"].std()) > 0.1  # not vacuous
    for k, v in want.items():
        assert (got[k] is None) == (v is None), k
        if v is not None:
            _close(got[k], v, err_msg=k)
    if (variant, n_samples, sigma_only) in _JAX_RAY_KERNEL_CASES:
        p = _plain_init(kw)
        got = _split(fused_mlp.fused_rays_eval(
            tf, params_from_numpy(p), *_torch(o, d, d, z),
            sigma_only=sigma_only), tf, sigma_only)
        kern = _split(jax_fused_mlp.fused_rays_eval(
            jf, p, o, d, d, z, sigma_only=sigma_only, interpret=True), jf,
            sigma_only, port=False)
        for k, v in kern.items():
            if v is not None:
                np.testing.assert_allclose(got[k], v, atol=RAY_BARS[k],
                                           err_msg=k)


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("variant", ["both_heads", "no_normal"])
def test_mlp_points(mlp_params, variant, sigma_only):
    """`fused_field_eval` / `fused_packed_eval` on 300 points (no multiple
    of the JAX kernel's 1024 tile): the JAX field modules at 1e-5, the JAX
    kernel `fused_field_eval` (interpret) at its own test's bars, a missing
    head as None."""
    kw = MLP_VARIANTS[variant]
    jf, tf = JaxMLP(**kw), TorchMLP(**kw)
    p = mlp_params[variant]
    pt = params_from_numpy(p)
    rng = np.random.default_rng(5)
    xyz = (rng.normal(size=(300, 3)) * 0.5).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xt, dt = _torch(xyz, dirs)
    got = fused_mlp.fused_field_eval(tf, pt, xt, dt, sigma_only=sigma_only)
    want = _jax_field_rows(jf, p, xyz, dirs, sigma_only)
    keys = ("sigma",) if sigma_only else ("sigma", "rgb", "normal", "mirror")
    assert len(got) == len(keys)
    for k, g in zip(keys, got):
        assert (g is None) == (want[k] is None), k
        if g is not None:
            _close(g.numpy(), want[k], err_msg=k)
    packed = fused_mlp.fused_packed_eval(tf, pt, xt, dt,
                                         sigma_only=sigma_only)
    assert torch.equal(packed[:, 0], got[0])
    p = _plain_init(kw)
    got = fused_mlp.fused_field_eval(tf, params_from_numpy(p), xt, dt,
                                     sigma_only=sigma_only)
    kern = jax_fused_mlp.fused_field_eval(jf, p, xyz, dirs,
                                          sigma_only=sigma_only,
                                          interpret=True)
    assert len(kern) == len(keys)
    for k, g, kv in zip(keys, got, kern):
        assert (g is None) == (kv is None), k
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(kv),
                                       atol=POINT_BARS[k], err_msg=k)


def test_mlp_saturating_rows(mlp_params):
    """σ ×2000 (raw σ ~1e3): the rows stay raw σ, held at 1e-5 scaled."""
    jf, tf = JaxMLP(), TorchMLP()
    p = jax.tree_util.tree_map(np.copy, mlp_params["both_heads"])
    p["sigma"]["w"][:, 0] *= 400.0
    o, d, z = _rays(3, 16, seed=6, scale=1.0, z_max=4.0)
    got = _split(fused_mlp.fused_rays_eval(tf, params_from_numpy(p),
                                           *_torch(o, d, d, z)), tf, False)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    want = _jax_field_rows(jf, p, xyz, np.repeat(d, 16, 0), False)
    assert float(np.abs(want["sigma"]).max()) > 300.0
    for k in want:
        _close(got[k], want[k], err_msg=k)


def test_mlp_cpu_dispatch_and_refusals(mlp_params):
    """CPU tensors take the plain version (no launch); another device
    raises; the CUDA launcher refuses CPU tensors and, under grad mode, an
    input or parameter that requires grad; points need view dirs unless
    σ-only."""
    tf = TorchMLP()
    pt = params_from_numpy(mlp_params["both_heads"])
    o, d, z = _torch(*_rays(2, 8, seed=7))
    before = (fused_mlp.launches_general_rays,
              fused_mlp.launches_general_points)
    rows = fused_mlp.fused_rays_eval(tf, pt, o, d, d, z)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    ref = fused_mlp.mlp_rows_reference(tf, pt, xyz, d.repeat_interleave(8, 0))
    assert torch.equal(rows, ref)
    fused_mlp.fused_packed_eval(tf, pt, xyz, sigma_only=True)
    assert (fused_mlp.launches_general_rays,
            fused_mlp.launches_general_points) == before
    with pytest.raises(ValueError, match="view dirs"):
        fused_mlp.fused_packed_eval(tf, pt, xyz)
    with pytest.raises(ValueError, match="no fused PE-MLP rows path"):
        fused_mlp.fused_field_eval(tf, pt, xyz.to("meta"), xyz.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_rows_cuda(tf, pt, o, d, d, z, sigma_only=False)
    pt["trunk"][2]["w"].requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        fused_mlp.fused_rows_cuda(tf, pt, o, d, d, z, sigma_only=True)


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_close(got, ref, what):
    """Kernel against plain on the card: 1e-4, scaled above 1."""
    for k in ref:
        _close(got[k].cpu().numpy(), ref[k].cpu().numpy(), atol=1e-4,
               err_msg=f"{what} {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples,n_rays",
                         [(64, 300), (128, 301), (80, 237), (192, 37)],
                         ids=["s64", "s128", "s80_ragged", "s192_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
def test_cuda_cp_rows_match_plain(cp, sigma_only, n_samples, n_rays):
    _needs_card()
    jf, tf = cp
    o, d, z = _rays(n_rays, n_samples, seed=n_samples)
    pt = params_from_numpy(_cp_params(jf, 5.0), device="cuda")
    args = [t.cuda() for t in _torch(o, d, d, z)]
    before = fused_cp.launches_rows
    with torch.no_grad():
        got = fused_cp.fused_cp_rays_eval(tf, pt, *args,
                                          sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert fused_cp.launches_rows == before + 1
        ref = fused_cp.cp_rays_rows_reference(tf, pt, *args,
                                              sigma_only=sigma_only)
    _cuda_close(got, ref, "cp rows")


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [64, 80, 192])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_cuda_cp_samples_composite_matches_plain(cp, act, sigma_only,
                                                 n_samples):
    _needs_card()
    jf, tf = cp
    o, d, z = _rays(37, n_samples, seed=n_samples)
    pt = params_from_numpy(_cp_params(jf, 5.0), device="cuda")
    ot, dt, zt = [t.cuda() for t in _torch(o, d, z)]
    xyz = (ot[:, None, :] + dt[:, None, :] * zt[..., None]).contiguous()
    v = dt[:, None, :].expand_as(xyz).contiguous()
    deltas = torch.cat([zt[:, 1:] - zt[:, :-1],
                        torch.full_like(zt[:, :1], 1e10)], -1)
    before = fused_cp.launches_samples
    with torch.no_grad():
        got = fused_cp.fused_cp_forward_composite(
            tf, pt, xyz, v, zt, deltas, sigma_only=sigma_only, sigma_act=act)
        torch.cuda.synchronize()
        assert fused_cp.launches_samples == before + 1
        ref = fused_cp.cp_samples_composite_reference(
            tf, pt, xyz, v, zt, deltas, sigma_only=sigma_only, sigma_act=act)
    assert float(got["weights"].sum(-1).max()) <= 1.0 + 1e-5
    _cuda_close(got, ref, "cp per-sample composite")


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples,n_rays",
                         [(64, 300), (128, 301), (80, 237), (192, 37)],
                         ids=["s64", "s128", "s80_ragged", "s192_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
def test_cuda_mlp_rows_match_plain(mlp_params, sigma_only, n_samples,
                                   n_rays):
    _needs_card()
    tf = TorchMLP()
    pt = params_from_numpy(mlp_params["both_heads"], device="cuda")
    args = [t.cuda() for t in _torch(*_rays(n_rays, n_samples,
                                            seed=n_samples, scale=1.0,
                                            z_max=4.0))]
    args.insert(2, args[1])
    before = fused_mlp.launches_general_rays
    with torch.no_grad():
        got = fused_mlp.fused_rays_eval(tf, pt, *args,
                                        sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert fused_mlp.launches_general_rays == before + 1
        o, d, _, z = args
        xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        ref = fused_mlp.mlp_rows_reference(
            tf, pt, xyz, d.repeat_interleave(n_samples, 0), sigma_only)
    _cuda_close({"rows": got}, {"rows": ref}, "mlp rows")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(set(MLP_VARIANTS) - {"both_heads"}))
def test_cuda_mlp_rows_variants_match_plain(mlp_params, variant):
    """The head-less instances: a missing head's lanes are 0."""
    _needs_card()
    tf = TorchMLP(**MLP_VARIANTS[variant])
    pt = params_from_numpy(mlp_params[variant], device="cuda")
    o, d, z = [t.cuda() for t in _torch(*_rays(203, 96, seed=9, scale=1.0,
                                                z_max=4.0))]
    with torch.no_grad():
        got = fused_mlp.fused_rays_eval(tf, pt, o, d, d, z)
        torch.cuda.synchronize()
        xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        ref = fused_mlp.mlp_rows_reference(tf, pt, xyz,
                                           d.repeat_interleave(96, 0))
    _cuda_close({"rows": got}, {"rows": ref}, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("n_points", [1, 255, 256, 1000 + 3])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
def test_cuda_mlp_points_match_plain(mlp_params, sigma_only, n_points):
    """Points as one-sample rays: S = 1, 256 points a block, a ragged last
    block."""
    _needs_card()
    tf = TorchMLP()
    pt = params_from_numpy(mlp_params["both_heads"], device="cuda")
    rng = np.random.default_rng(n_points)
    xyz = torch.from_numpy((rng.normal(size=(n_points, 3)) * 2.0
                            ).astype(np.float32)).cuda()
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n_points, 3)).astype(
            np.float32)).cuda(), dim=-1)
    before = fused_mlp.launches_general_points
    with torch.no_grad():
        got = fused_mlp.fused_packed_eval(tf, pt, xyz, dirs,
                                          sigma_only=sigma_only)
        torch.cuda.synchronize()
        assert fused_mlp.launches_general_points == before + 1
        ref = fused_mlp.mlp_rows_reference(tf, pt, xyz, dirs, sigma_only)
    _cuda_close({"rows": got}, {"rows": ref}, "mlp points")
