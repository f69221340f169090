"""Port parity over the whole range of two kernels' specs:

  * the PE-MLP rows kernels for every trunk JAX's `fused_mlp.py` adapters
    build (width a multiple of 128, any depth and skips, ≤ 20 posenc
    frequencies, either head): the port's rows path (its plain version on
    the CPU) against the JAX field modules and the JAX adapters (Pallas in
    interpret mode, bf16 weights, at the JAX tests' own bars); a render of
    a non-default trunk with `fused_field` against the JAX renderer; and
    what JAX's `fused_t` route does with such trunks (the rows kernels'
    packings: tests/test_torch_port_rows_tc.py and _rows_layers.py);
  * the hash-grid encoder for every `HashGridSpec` (input_dim 1..7,
    level_dim 1..4, align_corners, smoothstep, hashed and tiled): the
    plain ENCODE, BWD and BWD2 against JAX's `hashgrid_encode`, its
    `jax.grad` and the grad of a gradient, through the mode functions and
    through the `hashgrid_encode` autograd graph; smoothstep's diagonal
    Hessian term alone (1-d); and the general kernel's BWD2 walk (the
    trees with the tangent along g, their reverse) emulated in float64
    (`test_torch_port_hash_any_plan.walk_bwd2`) against JAX.

On a card, the CUDA kernels against their plain versions (marked `gpu`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.ops import hashgrid as jhg
from mirror_nerf_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from mirror_nerf_tpu.ops.pallas.fused_mlp_t import fused_t_rays_eval
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.renderer import render_rays as jax_render_rays
from mirror_nerf_tpu_torch.models.encoding import GridEncoder, get_encoder
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.ops import fused_mlp
from mirror_nerf_tpu_torch.ops.fused_mlp_t import mlp_rays_composite_reference
from mirror_nerf_tpu_torch.ops import hashgrid as thg
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy
from test_torch_port_hash_any_plan import walk_bwd2

# the rows path against the fp32 JAX field modules: summation order over
# up to 6 layers of width 384, scaled by the magnitude above 1
ROWS_ATOL = 5e-5
# the JAX flagship kernels' bf16 weights and rows, at the bars of
# tests/test_fused_mlp.py (ray mode :111-115, point mode :38-45)
RAY_BARS = {"sigma": 3e-2, "rgb": 1e-2, "normal": 3e-2, "mirror": 1e-2}
POINT_BARS = {"sigma": 2e-2, "rgb": 5e-3, "normal": 2e-2, "mirror": 5e-3}
# the hash grid: features at identical positions (dense levels are the
# same fp32 sums in another order), and gradients, of the scale
VALUE_REL = 1e-6
GRAD_REL = 1e-4

TRUNKS = {
    "w128_d6_s24": dict(width=128, depth=6, skips=(2, 4)),
    "w384_d6_s3": dict(width=384, depth=6, skips=(3,)),
    "w128_d3_plain_f20": dict(width=128, depth=3, skips=(),
                              predict_normal=False, predict_mirror_mask=False,
                              N_emb_xyz=20, N_emb_dir=0),
}


def _close(got, want, atol, err_msg=""):
    """|got − want| ≤ atol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    bar = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=bar, rtol=0,
                               err_msg=err_msg)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rays(n: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 4.0, (n, s)), -1).astype(np.float32)
    return o, d, z


def _trunk_params(kw: dict, seed: int = 0, he: bool = True) -> dict:
    """The field's init (numpy leaves, the JAX layout), σ column made
    positive ×5 and (he) the trunk weights ×√6, so that the deep ReLU
    trunk keeps its features."""
    p = jax.tree_util.tree_map(lambda t: t.numpy(), TorchField(**kw).init(
        torch.Generator().manual_seed(seed)))
    if he:
        p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * 5
        for layer in p["trunk"]:
            layer["w"] *= np.float32(np.sqrt(6.0))
    return p


@functools.partial(jax.jit, static_argnames=("jf",))
def _jax_rows(p, xyz, dirs, jf):
    from mirror_nerf_tpu.core.mathutil import l2_normalize

    sigma, geo = jf.density(p, xyz)
    b = xyz.shape[0]
    nrm = (l2_normalize(jf.normal_head(p, geo)) if jf.predict_normal
           else jnp.zeros((b, 3), jnp.float32))
    mir = (jf.mirror_head(p, geo).reshape(b, 1) if jf.predict_mirror_mask
           else jnp.zeros((b, 1), jnp.float32))
    return jnp.concatenate([sigma[:, None], jf.color(p, geo, dirs), nrm,
                            mir], axis=1)


def _field_rows(jf, p, xyz, dirs, sigma_only: bool) -> np.ndarray:
    """The JAX field modules (fp32, jitted) as (B, 8) rows (0 for a
    missing head), or (B, 1) raw σ."""
    rows = np.asarray(_jax_rows(p, jnp.asarray(xyz), jnp.asarray(dirs), jf))
    return rows[:, :1] if sigma_only else rows


# ------------------------------------------------------ the PE-MLP rows


def test_supports_fused_takes_the_jax_range():
    for kw in TRUNKS.values():
        tf = TorchField(**kw)
        assert tf.supports_fused and not tf.supports_fused_t
        assert JaxField(**kw).supports_fused


@functools.lru_cache(maxsize=None)
def _trunk_case(trunk: str):
    """Seeded params of a trunk, 5 rays × 16 samples and 300 points with
    view dirs, and the JAX field modules' rows at the rays' samples and at
    the points (one jitted call)."""
    kw = TRUNKS[trunk]
    p = _trunk_params(kw)
    o, d, z = _rays(5, 16, seed=1)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    want = _field_rows(JaxField(**kw), p, np.concatenate([xyz, pts]),
                       np.concatenate([np.repeat(d, 16, 0), dirs]), False)
    return p, (o, d, z), (pts, dirs), want


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_rows_match_jax_field_modules(trunk, sigma_only):
    """Rays (5 × 16) and points (300): the port's rows path against the
    JAX field modules at 5e-5."""
    tf = TorchField(**TRUNKS[trunk])
    p, (o, d, z), (pts, dirs), want = _trunk_case(trunk)
    if sigma_only:
        want = want[:, :1]
    pt = params_from_numpy(p)
    rows = fused_mlp.fused_rays_eval(tf, pt, *_t(o, d, d, z),
                                     sigma_only=sigma_only)
    assert rows.shape == (80, want.shape[1])
    assert float(want[:, 0].std()) > 0.1  # not vacuous
    _close(rows.numpy(), want[:80], ROWS_ATOL, f"{trunk} rays")
    got = fused_mlp.fused_packed_eval(tf, pt, *_t(pts, dirs),
                                      sigma_only=sigma_only)
    _close(got.numpy(), want[80:], ROWS_ATOL, f"{trunk} points")


@pytest.mark.parametrize("trunk", ["w128_d6_s24", "w384_d6_s3"])
def test_rows_match_jax_adapters(trunk):
    """JAX's `fused_rays_eval` and `fused_field_eval` (interpret mode, as
    the JAX package's tests run them: bf16 weights and rows) at the plain
    init, against the port's rows at those tests' own bars."""
    kw = TRUNKS[trunk]
    jf, tf = JaxField(**kw), TorchField(**kw)
    p = _trunk_params(kw, seed=3, he=False)
    pt = params_from_numpy(p)
    o, d, z = _rays(4, 16, seed=4)
    got = fused_mlp.fused_rays_eval(tf, pt, *_t(o, d, d, z)).numpy()
    kern = np.asarray(jax_fused_mlp.fused_rays_eval(
        jf, p, o, d, d, z, interpret=True), np.float32)
    for k, sl in (("sigma", slice(0, 1)), ("rgb", slice(1, 4)),
                  ("normal", slice(4, 7)), ("mirror", slice(7, 8))):
        np.testing.assert_allclose(got[:, sl], kern[:, sl],
                                   atol=RAY_BARS[k], err_msg=k)
    pts = np.random.default_rng(5).normal(size=(100, 3)).astype(np.float32)
    got = fused_mlp.fused_field_eval(tf, pt, *_t(pts, pts))
    kern = jax_fused_mlp.fused_field_eval(jf, p, pts, pts, interpret=True)
    for k, g, kv in zip(("sigma", "rgb", "normal", "mirror"), got, kern):
        np.testing.assert_allclose(g.numpy(), np.asarray(kv, np.float32),
                                   atol=POINT_BARS[k], err_msg=k)


def test_non_default_trunk_render_matches_jax():
    """`render_rays` with `fused_field` (and `fused_t` on, which a
    non-default trunk ignores: the rows route, the composite outside)
    against the JAX renderer's fp32 field modules, coarse and fine."""
    kw = TRUNKS["w128_d6_s24"]
    jf, tf = JaxField(**kw), TorchField(**kw)
    p = {"coarse": _trunk_params(kw, 0), "fine": _trunk_params(kw, 1)}
    rng = np.random.default_rng(7)
    o = (rng.normal(size=(16, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((16, 1), 0.05, np.float32),
                           np.full((16, 1), 4.0, np.float32)], axis=1)
    rs = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
              test_time=True, compute_normal=False, fine_pass="fine")
    want = jax.jit(jax_render_rays, static_argnums=(0, 4))(
        jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
        JaxRS(**rs, fused_field=False))
    got = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                      RenderSettings(**rs, fused_field=True, fused_t=True))
    assert float(got["opacity_fine"].mean()) > 0.1  # not vacuous
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse"):
        _close(got[k].numpy(), want[k], ROWS_ATOL, k)


@pytest.mark.parametrize("kw", [dict(n_levels=20), dict(hidden_dim=32)],
                         ids=["20_levels", "hidden_32"])
def test_hash_field_outside_the_fused_composite_renders_plain(kw,
                                                              monkeypatch):
    """A hash-grid field the fused NGP composite does not take (40 features
    a point, or a 32-wide σ-net) renders with `fused_field` through ENCODE
    and the nets, the route the JAX renderer takes for every hash-grid
    pass: what it renders with `fused_field` off, bit for bit, and the
    composite is never entered."""
    from mirror_nerf_tpu_torch.models.ngp import NGPField
    from mirror_nerf_tpu_torch.ops import fused_hash

    field = NGPField(bound=6.0, log2_hashmap_size=12, **kw)
    assert not field.supports_fused_hash

    def entered(*args, **kwargs):
        raise AssertionError("the fused NGP composite was entered")

    monkeypatch.setattr(fused_hash, "fused_hash_rays_composite", entered)
    params = {}
    for i, k in enumerate(("coarse", "fine")):
        p = field.init(torch.Generator().manual_seed(i))
        p["grid"] = p["grid"] * 1e4
        w = p["sigma_net"][-1]["w"].clone()
        w[:, 0] = w[:, 0].abs() * 5
        p["sigma_net"][-1] = {**p["sigma_net"][-1], "w": w}
        params[k] = p
    rng = np.random.default_rng(8)
    o = (rng.normal(size=(16, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = torch.from_numpy(np.concatenate(
        [o, d, np.full((16, 1), 0.1, np.float32),
         np.full((16, 1), 1.5, np.float32)], axis=1))
    rs = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
              test_time=True, compute_normal=False, fine_pass="fine")
    on, off = (render_rays(field, params, rays,
                           RenderSettings(**rs, fused_field=f))
               for f in (True, False))
    assert float(off["opacity_fine"].mean()) > 0.1  # not vacuous
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse"):
        assert torch.equal(on[k], off[k]), k


def test_jax_fused_t_with_non_default_trunks(monkeypatch):
    """JAX's `_inference_fused_t` builds the default `TSpec` whatever the
    field (fused_mlp_t.py:435): a width-128 field fails to run, and a
    width-256 depth-10 field runs its first 8 layers only (the result is
    the default trunk's on params trunk[:8], not the field's: the port's
    plain composite of that trunk). The port renders both through the rows
    kernel (ROADMAP §3, Known differences)."""
    monkeypatch.setenv("MNERF_T_LANES", "128")  # 8 rays a block
    o, d, z = _rays(4, 16, seed=8)
    jf = JaxField(width=128)
    with pytest.raises(TypeError, match="incompatible shapes"):
        fused_t_rays_eval(jf, jf.init(jax.random.PRNGKey(0)), o, d, d, z,
                          interpret=True)
    kw = dict(depth=10, skips=(4,))
    jf = JaxField(**kw)
    p = _trunk_params(kw, seed=9)
    got = fused_t_rays_eval(jf, p, o, d, d, z, interpret=True)
    cut = params_from_numpy(dict(p, trunk=p["trunk"][:8]))
    as8 = mlp_rays_composite_reference(TorchField(), cut, *_t(o, d, d, z))
    _close(np.asarray(got["weights"]), as8["weights"].numpy(), 1e-5,
           "the first 8 layers")
    tf = TorchField(**kw)
    assert tf.supports_fused and not tf.supports_fused_t
    full = mlp_rays_composite_reference(tf, params_from_numpy(p),
                                        *_t(o, d, d, z))
    assert float((full["weights"] - as8["weights"]).abs().max()) > 1e-2


# ------------------------------------------------------ the hash grid

SPECS = {
    "d1_c4_smooth": dict(input_dim=1, level_dim=4, num_levels=3,
                         base_resolution=5, log2_hashmap_size=6,
                         interpolation="smoothstep"),
    "d2_c2": dict(input_dim=2, level_dim=2, num_levels=4, base_resolution=4,
                  log2_hashmap_size=8),
    "d3_align": dict(input_dim=3, level_dim=2, num_levels=4,
                     base_resolution=4, log2_hashmap_size=10,
                     align_corners=True),
    "d3_smooth": dict(input_dim=3, level_dim=2, num_levels=4,
                      base_resolution=4, log2_hashmap_size=10,
                      interpolation="smoothstep"),
    "d4_c4_tiled": dict(input_dim=4, level_dim=4, num_levels=3,
                        base_resolution=3, log2_hashmap_size=10,
                        gridtype="tiled"),
    "d7_c1": dict(input_dim=7, level_dim=1, num_levels=2, base_resolution=2,
                  log2_hashmap_size=12),
    "d2_smooth_align_c1": dict(input_dim=2, level_dim=1, num_levels=3,
                               base_resolution=4, log2_hashmap_size=8,
                               align_corners=True,
                               interpolation="smoothstep"),
    # C 8 (the general kernels' 16-B chunks) and a tiled spec whose levels
    # overflow their 2⁶ rows
    "d3_c8": dict(input_dim=3, level_dim=8, num_levels=3, base_resolution=4,
                  log2_hashmap_size=9),
    "d2_c1_tiled": dict(input_dim=2, level_dim=1, num_levels=4,
                        base_resolution=8, log2_hashmap_size=6,
                        gridtype="tiled"),
}


def _hash_case(kw: dict, n: int, seed: int):
    """Specs (JAX, port), a table U(−1, 1), points in [0, 1]^D with about
    5 % outside (x_0 = 1.25), cotangents dy (N, L·C) and g (N, D)."""
    js, ts = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (ts.table_rows, ts.level_dim)).astype(
        np.float32)
    # multiples of 2⁻¹⁶: x·2 − 1 and back (`GridEncoder`'s bound) are exact
    x = (rng.integers(0, 2 ** 16 + 1, (n, ts.input_dim))
         / 2.0 ** 16).astype(np.float32)
    out = rng.random(n) < 0.05
    x[out, 0] = np.float32(1.25)
    dy = rng.standard_normal((n, ts.output_dim)).astype(np.float32)
    g = rng.standard_normal((n, ts.input_dim)).astype(np.float32)
    return js, ts, table, x, dy, g


def _rel(got, want, bar: float, what: str) -> None:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= bar, (what, err, scale)


@functools.partial(jax.jit, static_argnames=("js",))
def _jax_grads_jit(table, x, dy, g, js):
    def enc(t, xx):
        return jhg.hashgrid_encode(t, xx, js)

    def dx_of(t, xx, c):
        return jax.vjp(lambda q: enc(t, q), xx)[1](c)[0]

    _, vjp = jax.vjp(enc, table, x)
    d_table, dx = vjp(dy)
    second = jax.grad(lambda t, xx, c: jnp.sum(dx_of(t, xx, c) * g),
                      argnums=(0, 1, 2))(table, x, dy)
    return enc(table, x), d_table, dx, second


@functools.lru_cache(maxsize=None)
def _jax_case(spec: str):
    """A spec's case (`_hash_case`, 150 points) and JAX's encoder on it,
    its vjp (d_table, dx) and the grad of ⟨dx, g⟩ with respect to (table,
    x, dy), as numpy."""
    js, ts, table, x, dy, g = _hash_case(SPECS[spec], 150, seed=10)
    out = _jax_grads_jit(*map(jnp.asarray, (table, x, dy, g)), js=js)
    return (ts, table, x, dy, g), jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_hash_modes_match_jax(spec):
    """The plain ENCODE, BWD and BWD2 (the mode functions on the CPU)
    against JAX: features at 1e-6 of scale, the table and position grads
    and every grad of ⟨dx, g⟩ at 1e-4 of scale; zero outside the box."""
    (ts, table, x, dy, g), (y, d_table, dx, (gt, gx, gdy)) = _jax_case(spec)
    thg.check_spec(ts)  # a kernel takes it on the card
    assert not thg.tuned_spec(ts)
    tt, xt, dyt, gt_ = _t(table, x, dy, g)
    got = thg.encode_forward(tt, xt, ts)
    _rel(got, y, VALUE_REL, "encode")
    assert float(np.abs(np.asarray(y)).max()) > 0.1  # not vacuous
    p_table, p_dx = thg.encode_backward(tt, xt, dyt, ts)
    _rel(p_table, d_table, GRAD_REL, "d_table")
    _rel(p_dx, dx, GRAD_REL, "dx")
    q_table, q_dy, q_x = thg.encode_backward2(tt, xt, dyt, gt_, ts)
    _rel(q_table, gt, GRAD_REL, "bwd2 d_table")
    _rel(q_dy, gdy, GRAD_REL, "bwd2 d_dy")
    _rel(q_x, gx, GRAD_REL, "bwd2 d_x")
    out = ~thg._in_cube(xt)
    assert out.any() and bool((got[out] == 0).all())
    assert bool((p_dx[out] == 0).all()) and bool((q_x[out] == 0).all())


@pytest.mark.parametrize("spec", ["d2_c2", "d3_smooth", "d7_c1"])
def test_hash_autograd_graph_matches_jax(spec):
    """The `GridEncoder` (the `hashgrid_encode` Function graph: BWD as its
    backward, BWD2 as that one's) against JAX: y, the grads of ⟨y, dy⟩
    and the grads of ⟨∇x, g⟩ with respect to the table and x. `get_encoder`
    builds the same spec (it takes no interpolation, as JAX's does not)."""
    (ts, table, x, dy, g), (y, d_table, dx, (gt, gx, _)) = _jax_case(spec)
    enc = GridEncoder(ts)
    if ts.interpolation == "linear":
        kw = {k: v for k, v in SPECS[spec].items()
              if k not in ("num_levels", "base_resolution", "gridtype")}
        built, dim = get_encoder(
            "tiledgrid" if ts.gridtype == "tiled" else "hashgrid",
            num_levels=ts.num_levels, base_resolution=ts.base_resolution,
            desired_resolution=0, **kw)
        assert built == enc and dim == ts.output_dim
    tt, xt = (a.requires_grad_(True) for a in _t(table, x * 2.0 - 1.0))
    got = enc(tt, xt, bound=1.0)
    _rel(got.detach(), y, VALUE_REL, "y")
    a_table, a_x = torch.autograd.grad(got, (tt, xt), torch.from_numpy(dy),
                                       create_graph=True)
    _rel(a_table.detach(), d_table, GRAD_REL, "d_table")
    _rel(a_x.detach() * 2.0, dx, GRAD_REL, "dx")  # x01 = (x + 1)/2
    s_table, s_x = torch.autograd.grad((a_x * torch.from_numpy(g)).sum(),
                                       (tt, xt))
    _rel(s_table * 2.0, gt, GRAD_REL, "grad-of-grad table")
    _rel(s_x * 4.0, gx, GRAD_REL, "grad-of-grad x")


def test_smoothstep_diagonal_term_alone():
    """1-d levels have no mixed second derivative: the grad of ⟨dx, g⟩
    with respect to x is smoothstep's diagonal term alone, and it matches
    JAX's; with linear weights it is zero."""
    (ts, table, x, dy, g), (_, _, _, (_, gx, _)) = _jax_case("d1_c4_smooth")
    args = _t(table, x, dy, g)
    _, _, q_x = thg.encode_backward2(*args, ts, need_table=False,
                                     need_ddy=False)
    assert float(np.abs(gx).max()) > 1.0
    _rel(q_x, gx, GRAD_REL, "diagonal")
    linear = dataclasses.replace(ts, interpolation="linear")
    _, _, q_x = thg.encode_backward2(*args, linear, need_table=False,
                                     need_ddy=False)
    assert float(q_x.abs().max()) == 0.0


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_bwd2_walk_matches_jax(spec):
    """The general kernel's BWD2 walk (the trees carrying the tangent along
    g and their reverse, emulated in float64: `walk_bwd2`) against JAX's
    grad of ⟨dx, g⟩ with respect to the table, dy and x, at 1e-4 of each
    one's scale; zero outside the box."""
    (ts, table, x, dy, g), (_, _, _, (gt, gx, gdy)) = _jax_case(spec)
    q_table, q_dy, q_x = walk_bwd2(ts, *_t(table, x, dy, g))
    _rel(q_table, gt, GRAD_REL, "walk d_table")
    _rel(q_dy, gdy, GRAD_REL, "walk d_dy")
    _rel(q_x, gx, GRAD_REL, "walk d_x")
    out = ~thg._in_cube(torch.from_numpy(x))
    assert out.any() and bool((q_x[out] == 0).all())
    assert bool((q_dy[out] == 0).all())


def test_spec_outside_the_range_refuses():
    """input_dim 8 has no prime for the hash: the wrappers refuse it,
    naming the limit."""
    ts = thg.HashGridSpec(input_dim=8, num_levels=1, log2_hashmap_size=6)
    with pytest.raises(ValueError, match=r"input_dim 1\.\.7"):
        thg.check_spec(ts)


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ray_ordered(x: np.ndarray, per: int, seed: int) -> np.ndarray:
    """x's points replaced by segments of `per` consecutive points between
    two uniform points of [0, 1]^D (rows in a ray's order), the points
    outside kept where they were."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    a, b = rng.random((2, -(-n // per), 1, d))
    t = np.linspace(0.0, 1.0, per)[None, :, None]
    seg = (a + (b - a) * t).reshape(-1, d)[:n].astype(np.float32)
    out = (x < 0).any(-1) | (x > 1).any(-1)
    return np.where(out[:, None], x, seg)


@pytest.mark.gpu
@pytest.mark.parametrize("points", ["uniform", "ray-ordered"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cuda_general_hash_modes_match_plain(spec, points):
    _needs_card()
    _, ts, *arrays = _hash_case(SPECS[spec], 3001, seed=15)
    if points == "ray-ordered":
        arrays[1] = _ray_ordered(arrays[1], 128, seed=16)
    tt, xt, dyt, gt_ = (a.cuda() for a in _t(*arrays))
    n0 = (thg.launches_general_encode, thg.launches_general_bwd,
          thg.launches_general_bwd2)
    _rel(thg.encode_forward(tt, xt, ts).cpu(),
         thg.hashgrid_encode_reference(tt, xt, ts).cpu(), 1e-5, "encode")
    for got, want in zip(thg.encode_backward(tt, xt, dyt, ts),
                         thg.encode_backward_reference(tt, xt, dyt, ts)):
        _rel(got.cpu(), want.cpu(), 1e-3, "bwd")
    for got, want in zip(thg.encode_backward2(tt, xt, dyt, gt_, ts),
                         thg.encode_backward2_reference(tt, xt, dyt, gt_,
                                                        ts)):
        _rel(got.cpu(), want.cpu(), 1e-3, "bwd2")
    assert (thg.launches_general_encode, thg.launches_general_bwd,
            thg.launches_general_bwd2) == tuple(k + 1 for k in n0)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["d2_c2", "d4_c4_tiled", "d7_c1", "d3_c8"])
def test_cuda_general_hash_unaligned_table(spec):
    """A table that starts 4 B past a 16-B boundary takes the same kernels
    (narrower loads) and matches the plain version, as the aligned one."""
    _needs_card()
    _, ts, table, x, dy, _ = _hash_case(SPECS[spec], 2001, seed=17)
    tt, xt, dyt = (a.cuda() for a in _t(table, x, dy))
    buf = torch.empty(tt.numel() + 4, device="cuda")
    odd = buf[1:1 + tt.numel()].view(tt.shape)
    odd.copy_(tt)
    assert odd.data_ptr() % 16 == 4
    n0 = (thg.launches_general_encode, thg.launches_general_bwd)
    _rel(thg.encode_forward(odd, xt, ts).cpu(),
         thg.hashgrid_encode_reference(tt, xt, ts).cpu(), 1e-5, "encode")
    for got, want in zip(thg.encode_backward(odd, xt, dyt, ts),
                         thg.encode_backward_reference(tt, xt, dyt, ts)):
        _rel(got.cpu(), want.cpu(), 1e-3, "bwd")
    assert (thg.launches_general_encode,
            thg.launches_general_bwd) == tuple(k + 1 for k in n0)


@pytest.mark.gpu
@pytest.mark.parametrize("points", ["uniform", "ray-ordered"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cuda_general_hash_bwd2_outputs(spec, points):
    """The general BWD2 asked for each set of outputs its callers ask for
    ((d_table, d_dy) as the training path, d_x alone, d_dy alone, d_table
    alone), on a 16-B aligned table and on one 4 B off: each output within
    1e-3 of the plain version's scale, d_dy and d_x zero outside the box,
    one launch a call."""
    _needs_card()
    _, ts, *arrays = _hash_case(SPECS[spec], 3001, seed=21)
    if points == "ray-ordered":
        arrays[1] = _ray_ordered(arrays[1], 128, seed=22)
    tt, xt, dyt, gt_ = (a.cuda() for a in _t(*arrays))
    buf = torch.empty(tt.numel() + 4, device="cuda")
    odd = buf[1:1 + tt.numel()].view(tt.shape)
    odd.copy_(tt)
    out = ~thg._in_cube(xt)
    assert out.any() or points == "ray-ordered"
    for table in (tt, odd):
        for need in ((True, True, False), (False, False, True),
                     (False, True, False), (True, False, False)):
            n0 = thg.launches_general_bwd2
            got = thg.encode_backward2(table, xt, dyt, gt_, ts, *need)
            assert thg.launches_general_bwd2 == n0 + 1
            want = thg.encode_backward2_reference(tt, xt, dyt, gt_, ts,
                                                  *need)
            for a, b, asked in zip(got, want, need):
                assert (a is None) == (not asked)
                if a is not None:
                    _rel(a.cpu(), b.cpu(), 1e-3, f"bwd2 {need}")
            for a in got[1:]:
                if a is not None:
                    assert bool((a[out] == 0).all()), need
