"""Port parity, the fused NGP composite (`ops/fused_hash.py`, the
`hash_field_kernel` of `csrc/fused_cp_composite.cu`) for the hash-grid model
(`--model_type nerf_tcnn`), at full width (16 levels × 2, 2¹⁹ rows a level,
bound 6):

  * the plain version, `hash_rays_composite_reference`, against the JAX
    package's render pass (`render/renderer.py _inference`, `NGPField` on
    XLA) on the same samples: σ-only and full, relu and softplus, and a
    saturating σ field whose weights sum to at most 1 with the δ_inf
    sentinel; and `render_rays(fused_field=True)` against JAX's
    `render_rays`;
  * the kernel's layout emulated on the CPU: lane t of a fragment
    interpolates levels t, t+4, t+8 and t+12, whose two features are its A
    columns t and t+4, against s1 packed without the CP fold
    (`fused_cp._pack_nets(params, ())`), every product by the 3×TF32
    `mma3_reference`, the heads in the CP composite's fragment orders: the
    plain σ-net and composite, and JAX through them, at 16 levels and a
    count padded with zero levels (12);
  * the routing: `render_rays(fused_field=True)` on CPU tensors takes the
    plain version and never the ENCODE dispatcher on noise-free passes
    (σ-noise passes keep it), the counter does not move, `TPUGridField`
    still routes to the CP kernel, the grad guard raises, and
    `supports_fused_hash` is false for every spec the kernel lacks;

and, on a machine with a card only: the kernel against its plain version at
S ∈ {1, 63, 64, 128, 192, 256} on 2048 + 37 rays, both variants and both
activations, seeded and saturating, with samples out of bound; a padded
level count; HMMA in every instance's SASS.

Tables are the ±1e-4 init with the dense levels ×1e4, as in
tests/test_torch_port_ngp_slice.py, and the samples are those whose x01
JAX's division and the port's fp32 reciprocal round alike (the two differ
by an ulp for a third of the coordinates, which the ×1e4 levels turn into
~1e-5): both sides interpolate at the same positions. The emulation sums
in float64, the plain version in fp32: order only, 1e-5 scaled above 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
from mirror_nerf_tpu.render import renderer as jax_renderer
from mirror_nerf_tpu_torch.models import ngp as ngp_module
from mirror_nerf_tpu_torch.models.ngp import NGPField as TorchNGP
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_hash, hashgrid
from mirror_nerf_tpu_torch.ops.sh import sh_encode
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

# fp32 against fp32 (or float64 emulation) on the same samples: order only
ATOL = 1e-5
KEYS = ("weights", "opacity", "rgb", "normal", "mirror", "depth")
JAX_KEYS = {"weights": "weights", "opacity": "opacity", "rgb": "rgb",
            "normal": "surface_normal", "mirror": "mirror_mask",
            "depth": "depth"}


def _close(got, want, atol=ATOL, err_msg=""):
    """|got − want| ≤ atol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    bar = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=bar,
                               rtol=0, err_msg=err_msg)


def _params(jf, seed: int, sigma_scale: float = 5.0) -> dict:
    """JAX-initialized params: the dense levels ×1e4, the hashed ones at
    the init; the σ column |w|·sigma_scale, so most samples have σ ≥ 0."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    for lv in jf.grid_spec.levels():
        if not lv.use_hash:
            p["grid"][lv.offset:lv.offset + lv.size] *= np.float32(1e4)
    p["sigma_net"][1]["w"][:, 0] = (np.abs(p["sigma_net"][1]["w"][:, 0])
                                    * sigma_scale)
    return p


def _rays(n: int, s: int, seed: int, bound: float = 6.0):
    """Rays from x = ±1 with depths 0.1 … 1.5 (inside the cube), their
    directions mostly along y and z (the NGP slice's scene). Each ray keeps
    the first s of 400 sorted candidate depths whose sample o + d·z (two
    roundings, as both packages form it here) has the same x01 under JAX's
    division by 2·bound and the port's fp32 reciprocal, so both interpolate
    at the same positions."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    o[:, 1:] = rng.normal(size=(n, 2)) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] *= 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cand = np.sort(rng.uniform(0.1, 1.5, (n, 400)), -1).astype(np.float32)
    xyz = o[:, None, :] + d[:, None, :] * cand[..., None]
    b = np.float32(bound)
    same = (((xyz + b) / (b + b))
            == ((xyz + b) * (np.float32(1) / (b + b)))).all(-1)
    z = np.stack([c[m][:s] for c, m in zip(cand, same)])
    assert z.shape == (n, s)
    return o, d, z


@pytest.fixture(scope="module")
def full():
    return JaxNGP(bound=6.0), TorchNGP(bound=6.0)


def _jax_pass(jf, p, o, d, z, sigma_only: bool, act: str) -> dict:
    """The JAX renderer's pass on these samples (XLA, noise 0), in the
    composite's keys."""
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    rs = jax_renderer.RenderSettings(
        N_samples=z.shape[1], N_importance=0, perturb=0.0, noise_std=0.0,
        compute_normal=False, sigma_activation=act)
    res = jax_renderer._inference(
        jf, p, "fine", jnp.asarray(xyz), jnp.asarray(z), jnp.asarray(d),
        jax.random.PRNGKey(0), rs, {}, sigma_only, None, None)
    keys = ("weights",) if sigma_only else KEYS
    return {k: np.asarray(res[f"{JAX_KEYS[k]}_fine"]) for k in keys}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------- the plain version against JAX


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_plain_version_matches_jax(full, act, sigma_only):
    jf, tf = full
    p = _params(jf, 0)
    o, d, z = _rays(16, 24, seed=1)
    got = fused_hash.hash_rays_composite_reference(
        tf, params_from_numpy(p), *_torch(o, d, d, z), sigma_only, act)
    want = _jax_pass(jf, p, o, d, z, sigma_only, act)
    assert set(got) == set(want)
    assert float(got["weights"].max()) > 0.1  # not vacuous
    for k in want:
        _close(got[k].numpy(), want[k], err_msg=k)


def test_plain_version_saturating_weights_sum_le_one(full):
    """σ ≳ 1e3: the first samples are opaque, every later transmittance
    underflows, and the last sample's δ_inf = 1e10 must not cancel the
    prefix (the exclusive scan): Σw ≤ 1 + 1e-5, as JAX."""
    jf, tf = full
    p = _params(jf, 2, sigma_scale=2000.0)
    o, d, z = _rays(16, 24, seed=3)
    got = fused_hash.hash_rays_composite_reference(
        tf, params_from_numpy(p), *_torch(o, d, d, z))
    want = _jax_pass(jf, p, o, d, z, False, "relu")
    wsum = got["weights"].sum(-1)
    assert float(wsum.max()) <= 1.0 + 1e-5
    assert float(wsum.min()) > 0.99  # saturated
    for k in want:
        _close(got[k].numpy(), want[k], err_msg=k)


def test_fused_render_rays_matches_jax(full):
    """The renderer end to end with fused_field on CPU tensors (the fused
    route's plain version on both passes, coarse σ-only S = 8 and fine
    full S = 16) against JAX's render_rays, noise 0 and perturb 0. Its
    depths come from the sampler, so every position counts: the hashed
    levels stay at the init, where a position's ulp moves nothing."""
    jf, tf = full
    p = {"coarse": _params(jf, 8), "fine": _params(jf, 9)}
    o, d, _ = _rays(32, 1, seed=10)
    rays = np.concatenate([o, d, np.full((32, 1), 0.1, np.float32),
                           np.full((32, 1), 1.5, np.float32)], 1)
    rs = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
              test_time=True, compute_normal=False)
    want = jax_renderer.render_rays(jf, p, jnp.asarray(rays),
                                    jax.random.PRNGKey(0),
                                    jax_renderer.RenderSettings(**rs))
    pt = {k: params_from_numpy(v) for k, v in p.items()}
    got = render_rays(tf, pt, torch.from_numpy(rays),
                      RenderSettings(**rs, fused_field=True))
    assert float(got["opacity_fine"].max()) > 0.1  # not vacuous
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse", "weights_fine"):
        _close(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------ the kernel's layout, emulated


def _mm3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A fragment product as the kernel takes it: 3×TF32, float64 sums."""
    return fused_cp.mma3_reference(a.float(), w.float())


def lane_a_columns(feats: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The σ-net's A matrix as the kernel's lanes write it: in k-tile kt,
    lane t interpolates level 4kt + t and holds its features 0 and 1 as A
    columns t and t + 4; a level past n_levels is zero. feats: the plain
    encoder's (M, 2·n_levels), level-major."""
    a = torch.zeros((feats.shape[0], 32), dtype=feats.dtype)
    for kt in range(4):
        for t in range(4):
            level = 4 * kt + t
            if level < n_levels:
                a[:, 8 * kt + t] = feats[:, 2 * level]
                a[:, 8 * kt + t + 4] = feats[:, 2 * level + 1]
    return a


def kernel_order_rows(field, params, xyz, dirs) -> dict:
    """The field's per-sample outputs from the buffers the wrapper hands
    the kernel, in the kernel's order: the plain encoder's features as the
    lanes place them, then every layer of the packed nets (no fold) by
    3×TF32 products, each layer fed by the previous one's C fragments
    (A = C[:, c_order]), c1's SH rows in quad order."""
    nets = fused_cp._pack_nets(params, ())
    mats, at = {}, 0
    for name, k, n in fused_cp.NET_LAYOUT:
        mats[name] = nets[at:at + k * n].reshape(k, n)
        at += k * n
    feats = hashgrid.hashgrid_encode_reference(
        params["grid"], (xyz + field.bound) * field.inv_2b, field.grid_spec)
    a0 = lane_a_columns(feats, field.n_levels)
    c16, c32, c64 = (fused_cp.c_order(k) for k in (16, 32, 64))
    h = torch.relu(_mm3(a0, mats["s1"]))
    sg = _mm3(h[:, c64], mats["s2"])
    geo = sg[:, c16]
    d = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    sh = sh_encode(d)[:, fused_cp.quad_order(16)]
    hc = torch.relu(_mm3(torch.cat([sh.double(), geo], -1), mats["c1"]))
    hc = torch.relu(_mm3(hc[:, c64], mats["c2"]))
    rgb = torch.sigmoid(_mm3(hc[:, c64], mats["c3"])[:, :3])
    hn = torch.relu(_mm3(geo, mats["n1"]))
    nrm = _mm3(hn[:, c64], mats["n2"])[:, :3]
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    hm = _mm3(geo, mats["m1"]) + mats["m1b"][0].double()
    hm = torch.where(hm >= 0, hm, 0.01 * hm)
    mir = torch.sigmoid(_mm3(hm[:, c32], mats["m2"])[:, 0]
                        + mats["m2b"][0, 0].double())
    return {"sigma": sg[:, 0], "geo": sg[:, 1:], "rgb3": rgb,
            "normal3": nrm, "mirror": mir, "a0": a0, "feats": feats}


@pytest.fixture(scope="module", params=[16, 12], ids=["16_levels",
                                                      "12_levels"])
def emulated(request):
    """The field at 16 levels and at 12 (padded with four zero levels),
    seeded params, rays and the kernel-order rows of their samples."""
    jf = JaxNGP(bound=6.0, n_levels=request.param)
    tf = TorchNGP(bound=6.0, n_levels=request.param)
    p = _params(jf, 4)
    pt = params_from_numpy(p)
    o, d, z = _rays(9, 24, seed=5)
    ot, dt, zt = _torch(o, d, z)
    xyz = (ot[:, None, :] + dt[:, None, :] * zt[..., None]).reshape(-1, 3)
    rows = kernel_order_rows(tf, pt, xyz, dt.repeat_interleave(24, 0))
    return jf, tf, p, pt, (o, d, z), xyz, rows


def test_lane_levels_are_c_order(emulated):
    """The lanes' A columns are the encoder's features in s1's K order
    (`c_order(32)`): the wrapper's packed s1 needs no other permutation,
    and a padded level count leaves zero columns against zero rows."""
    _, tf, _, pt, _, _, rows = emulated
    feats, a0 = rows["feats"], rows["a0"]
    padded = torch.nn.functional.pad(feats, (0, 32 - feats.shape[1]))
    assert torch.equal(a0, padded[:, fused_cp.c_order(32)])
    s1p = fused_cp._pack_nets(pt, ())[:32 * 64].reshape(32, 64)
    s1 = pt["sigma_net"][0]["w"]
    for j, r in enumerate(fused_cp.c_order(32)):
        want = s1[r] if r < s1.shape[0] else torch.zeros(64)
        assert torch.equal(s1p[j], want), j
    if tf.n_levels < 16:
        assert not a0[:, fused_cp.c_order(32).index(2 * tf.n_levels):].any()


def test_kernel_order_sigma_net_matches_plain(emulated):
    """σ and geo through the lanes' fragments and 3×TF32 products: the
    plain density's (plain encoder), and JAX's NGPField.density on the
    same x01 features."""
    jf, tf, p, pt, _, xyz, rows = emulated
    sig, geo = fused_hash.hash_density_reference(tf, pt, xyz)
    _close(rows["sigma"].numpy(), sig.numpy(), err_msg="sigma")
    _close(rows["geo"].numpy(), geo.numpy(), err_msg="geo")
    # JAX's σ-net on the port's features (the encoders agree on identical
    # positions: tests/test_torch_port_hashgrid.py)
    h = jnp.asarray(rows["feats"].numpy())
    for i, layer in enumerate(p["sigma_net"]):
        h = h @ layer["w"]
        if i == 0:
            h = jax.nn.relu(h)
    _close(rows["sigma"].numpy(), np.asarray(h[:, 0]), err_msg="jax sigma")
    _close(rows["geo"].numpy(), np.asarray(h[:, 1:]), err_msg="jax geo")


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
def test_kernel_order_composite_matches_plain_and_jax(emulated, sigma_only):
    """The kernel-order rows composited by the exclusive prefix: the plain
    version's weights and per-ray sums, and JAX's render pass."""
    jf, tf, p, pt, (o, d, z), _, rows = emulated
    ot, dt, zt = _torch(o, d, z)
    n, s = z.shape
    per_sample = {k: rows[k].reshape(n, s, *rows[k].shape[1:]).float()
                  for k in ("sigma", "rgb3", "normal3", "mirror")}
    deltas = torch.cat([zt[:, 1:] - zt[:, :-1],
                        torch.full_like(zt[:, :1], 1e10)], -1)
    got = fused_cp.composite_rows(per_sample, zt, deltas, sigma_only,
                                  "relu")
    want = fused_hash.hash_rays_composite_reference(tf, pt, ot, dt, dt, zt,
                                                    sigma_only)
    jax_want = _jax_pass(jf, p, o, d, z, sigma_only, "relu")
    assert float(want["weights"].max()) > 0.1  # not vacuous
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), err_msg=k)
        if k in jax_want:
            _close(got[k].numpy(), jax_want[k], err_msg=f"jax {k}")


# -------------------------------------------------------------- routing


@pytest.fixture(scope="module")
def small():
    """A 4-level field (its table small) with seeded params for both
    passes, and 12 rays."""
    jf = JaxNGP(bound=6.0, n_levels=4, log2_hashmap_size=12)
    tf = TorchNGP(bound=6.0, n_levels=4, log2_hashmap_size=12)
    p = {"coarse": params_from_numpy(_params(jf, 6)),
         "fine": params_from_numpy(_params(jf, 7))}
    o, d, _ = _rays(12, 1, seed=8)
    rays = np.concatenate([o, d, np.full((12, 1), 0.1, np.float32),
                           np.full((12, 1), 1.5, np.float32)], 1)
    return tf, p, torch.from_numpy(rays)


RS = dict(N_samples=8, N_importance=8, perturb=0.0, test_time=True,
          compute_normal=False)


def test_fused_field_on_cpu_takes_the_plain_version(small, monkeypatch):
    """fused_field on CPU tensors: every noise-free pass goes through the
    adapter's plain version, never through the ENCODE dispatcher (on the
    card: no ENCODE launch), and the kernel's counter stays; the render
    matches the unfused route (two formulations of the same transmittance:
    1e-5)."""
    tf, p, rays = small
    calls = []
    plain = fused_hash.hash_rays_composite_reference

    def spy(*a, **k):
        calls.append(a[5].shape)
        return plain(*a, **k)

    def no_dispatch(*a, **k):
        raise AssertionError("the ENCODE dispatcher was called")

    monkeypatch.setattr(fused_hash, "hash_rays_composite_reference", spy)
    monkeypatch.setattr(ngp_module, "hashgrid_encode", no_dispatch)
    before = fused_hash.launches
    on = render_rays(tf, p, rays, RenderSettings(**RS, noise_std=0.0,
                                                 fused_field=True))
    assert calls == [(12, 8), (12, 16)]  # coarse σ-only, fine full
    assert fused_hash.launches == before
    monkeypatch.undo()
    off = render_rays(tf, p, rays, RenderSettings(**RS, noise_std=0.0))
    assert float(off["opacity_fine"].max()) > 0.1  # not vacuous
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse", "weights_fine"):
        _close(on[k].numpy(), off[k].numpy(), err_msg=k)


def test_sigma_noise_passes_keep_the_encode_route(small, monkeypatch):
    """With σ noise the hash grid's passes take ENCODE (the dispatcher) and
    the PyTorch nets, with or without fused_field, and draw the same
    noise: equal renders."""
    tf, p, rays = small
    calls = []
    dispatch = ngp_module.hashgrid_encode

    def spy(*a, **k):
        calls.append(a[1].shape)
        return dispatch(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the fused kernel's adapter was called")

    monkeypatch.setattr(ngp_module, "hashgrid_encode", spy)
    monkeypatch.setattr(fused_hash, "fused_hash_rays_composite", no_kernel)
    out = [render_rays(tf, p, rays, RenderSettings(**RS, noise_std=1.0,
                                                   fused_field=f),
                       generator=torch.Generator().manual_seed(0))
           for f in (True, False)]
    assert len(calls) == 4
    for k in ("rgb_fine", "depth_fine", "weights_coarse"):
        torch.testing.assert_close(out[0][k], out[1][k], atol=0, rtol=0)


def test_cp_field_still_routes_to_the_cp_kernel(monkeypatch):
    """TPUGridField subclasses NGPField: it reports supports_fused_cp, not
    supports_fused_hash, and its fused passes go to the CP adapter."""
    field = TPUGridField(bound=2.0, grid_levels=((16, 8),))
    assert field.supports_fused_cp and not field.supports_fused_hash
    p = {k: field.init(torch.Generator().manual_seed(i))
         for i, k in enumerate(("coarse", "fine"))}
    called = []
    cp_plain = fused_cp.cp_rays_composite_reference

    def spy(*a, **k):
        called.append("cp")
        return cp_plain(*a, **k)

    def no_hash(*a, **k):
        raise AssertionError("the hash kernel's adapter was called")

    monkeypatch.setattr(fused_cp, "cp_rays_composite_reference", spy)
    monkeypatch.setattr(fused_hash, "fused_hash_rays_composite", no_hash)
    rays = torch.tensor([[0.0, 0.0, -1.5, 0.0, 0.0, 1.0, 0.1, 3.0]])
    render_rays(field, p, rays, RenderSettings(**RS, noise_std=0.0,
                                               fused_field=True))
    assert called == ["cp", "cp"]


def test_grad_guard_raises(small):
    tf, p, rays = small
    params = {k: (v.clone().requires_grad_(True) if k == "grid" else v)
              for k, v in p["fine"].items()}
    o, d = rays[:, :3].contiguous(), rays[:, 3:6].contiguous()
    z = torch.linspace(0.1, 1.5, 8).expand(12, 8).contiguous()
    with pytest.raises(ValueError, match="forward-only"):
        fused_hash.fused_hash_composite_cuda(tf, params, o, d, d, z, False,
                                             "relu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fused_hash.fused_hash_composite_cuda(tf, params, o, d, d, z, False,
                                             "relu")


@pytest.mark.parametrize("spec", [
    dict(n_levels=17), dict(n_levels=20), dict(hidden_dim=32),
    dict(num_layers=3), dict(geo_feat_dim=7), dict(num_layers_color=2),
    dict(hidden_dim_color=128), dict(sh_degree=3),
    dict(predict_normal=False), dict(predict_mirror_mask=False)],
    ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
def test_supports_fused_hash_only_for_the_kernels_specs(spec):
    assert TorchNGP(bound=6.0).supports_fused_hash
    assert TorchNGP(bound=2.0, n_levels=12).supports_fused_hash
    field = TorchNGP(bound=6.0, **spec)
    assert not field.supports_fused_hash
    with pytest.raises(ValueError, match="supports_fused_hash"):
        fused_hash.fused_hash_composite_cuda(
            field, {}, *(torch.zeros((1, 3)),) * 3, torch.ones((1, 4)),
            False, "relu")


# --------------------------------------------------- on a card only

SAMPLES_PER_RAY = [1, 63, 64, 128, 192, 256]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_params(field, scale: float) -> dict:
    """Seeded params on the card: the dense levels ×1e4, the σ column
    |w|·scale (5 seeded, 2000 saturating)."""
    p = field.init(torch.Generator().manual_seed(0), "cuda")
    n = sum(lv.size for lv in field.grid_spec.levels() if not lv.use_hash)
    p["grid"][:n] *= 1e4
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * scale
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    return p


def _cuda_rays(n: int, s: int, seed: int):
    """Rays from around the origin over depths up to 1.6·bound: ~10 % of
    the samples lie outside the bound-6 cube."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g) * 0.6
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    z = torch.sort(torch.rand((n, s), generator=g) * 9.6 + 0.05, -1).values
    return o.cuda(), d.cuda(), z.cuda()


def _every_variant(field, params, o, d, z):
    for so in (False, True):
        for act in ("relu", "softplus"):
            tag = f"{act} so={so} S={z.shape[1]}"
            before = fused_hash.launches
            with torch.no_grad():
                got = fused_hash.fused_hash_rays_composite(
                    field, params, o, d, d, z, so, act)
                torch.cuda.synchronize()
                ref = fused_hash.hash_rays_composite_reference(
                    field, params, o, d, d, z, so, act)
            assert fused_hash.launches == before + 1, tag
            assert set(got) == set(ref), tag
            for k in ref:
                assert bool(torch.isfinite(got[k]).all()), (tag, k)
                _close(got[k].cpu().numpy(), ref[k].cpu().numpy(),
                       atol=1e-4, err_msg=f"{tag} {k}")
            assert float(got["weights"].sum(-1).max()) <= 1.0 + 1e-5, tag


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", SAMPLES_PER_RAY)
def test_cuda_kernel_matches_plain(n_samples):
    """The full-width field (16 levels, bound 6), seeded and saturating,
    2048 + 37 rays with samples out of bound: both variants, relu and
    softplus, at 1e-4 scaled above 1."""
    _needs_card()
    field = TorchNGP(bound=6.0)
    o, d, z = _cuda_rays(2048 + 37, n_samples, seed=n_samples)
    x01 = ((o[:, None] + d[:, None] * z[..., None]) + 6.0) / 12.0
    assert 0.01 < float(((x01 < 0) | (x01 > 1)).any(-1).float().mean())
    for scale in (5.0, 2000.0):
        _every_variant(field, _cuda_params(field, scale), o, d, z)


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [17, 128])
def test_cuda_padded_levels_match_plain(n_samples):
    """12 levels (four zero levels in K), bound 2, 37 rays."""
    _needs_card()
    field = TorchNGP(bound=2.0, n_levels=12)
    o, d, z = _cuda_rays(37, n_samples, seed=3)
    _every_variant(field, _cuda_params(field, 5.0), o / 3, d, z / 3)


@pytest.mark.gpu
def test_cuda_hash_kernel_runs_on_the_tensor_cores():
    """Each of the four instances (σ-only / full × relu / softplus) holds
    HMMA in its SASS."""
    _needs_card()
    fused_hash._library()
    sass = _build.sass_counts(_build.library_path(fused_hash._LIB),
                              "hash_field_kernel")
    assert len(sass) == 4, list(sass)
    for name, counts in sass.items():
        assert counts["HMMA"] > 0, name
