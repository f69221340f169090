"""Port parity, `--compute_dtype bfloat16` and `--fp32_sigma_grad`: the
three fields' bf16 `density`, `color` and heads against the JAX fields
(jit), `render_rays` with the σ-gradient normal with `fp32_sigma_grad` on
and off, one reflection-stage loss and its parameter gradients through
`trace_rays` for each model, the fused kernels' plain versions staying
fp32, and the hash grid's `--fused_field` against JAX's unfused bf16 render.

Every bf16 output is held two ways (XLA:CPU may keep fp32 between fused bf16
ops, so bit-for-bit is not the bar):
  * within BF16_BAR = 4·2⁻⁷ of the output's scale (its largest |value|) of
    JAX's. Where bf16 itself misses that bar, JAX's own largest distance
    from float64 being larger, the bar is twice that distance: the ∇σ
    normals of a bf16 σ-gradient pass (measured here: JAX 0.15–0.52 of
    scale from float64 at most), the hash grid's depth (6e-2) and each
    step's parameter gradients (`_hold`);
  * its distance from a float64 evaluation (the port's fp32 field, which
    casts nothing, on float64 parameters and inputs; RMS over the output)
    no more than F64_RATIO = 1.5× JAX's own distance from it; and, where
    JAX rounds the output to bf16 (its distance over BF16_SEEN = 10× the
    port's fp32 field's), over 10× the port's fp32 field's too and, on at
    least N_STAT = 32 values, no less than F64_FLOOR = 0.5× JAX's: a port
    that skipped the casts and computed in fp32 fails there.
Each step's parameter gradients are held so leaf by leaf (the leaves under
N_STAT values pooled), and over all leaves together at F64_RATIO. Without
fp32_sigma_grad a leaf's ratio is held within F64_LEAF_RATIO = 2.5 (and
1/2.5): the normal losses' gradients pass through bf16's ∇σ normals, some
0.3 of their scale from float64 in both packages, and the two RMS distances
are two draws of that noise (measured here: 0.51–2.05, both ends on the CP
grid's fine axis tables). With fp32_sigma_grad it is F64_RATIO. Each ratio
is printed (`pytest -s`).
Every output that JAX casts back to fp32 straight after its last linear
(the heads, rgb, the NGP σ net) is computed as XLA computes it
(`models/nn.linear_out`; the flagship's σ, sliced before its cast, is
rounded as a plain bf16 linear): with `linear(...).float()` there,
`test_reflection_stage_loss_and_grads` fails for nerf_tcnn off (its loss
2.8× JAX's distance from float64, the fine mirror head's first bias
gradient 0.02× of it) and on, nerf on and nerf_tpu off.
Small sizes: the flagship at full width on 512 points and 32–48 rays, the
hash grid with 4 levels (the dense level 0 ×1e4, the hashed ones at their
init, as tests/test_torch_port_ngp_slice.py renders: the two packages round
positions differently, and ∇σ jumps at each cell face), the CP grid with
16:8,32:8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxMLP
from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxCP
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.renderer import render_rays as jax_render_rays
from mirror_nerf_tpu.render.tracer import TraceSettings as JaxTS
from mirror_nerf_tpu.render.tracer import trace_rays as jax_trace_rays
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchMLP
from mirror_nerf_tpu_torch.models.ngp import NGPField as TorchNGP
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchCP
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.render.tracer import TraceSettings, trace_rays
from mirror_nerf_tpu_torch.train.checkpoints import (_leaves, _map,
                                                     params_from_numpy,
                                                     tree_leaves)

BF16_BAR = 4 * 2.0 ** -7
F64_RATIO = 1.5
F64_FLOOR = 0.5
BF16_SEEN = 10.0
N_STAT = 32
F64_LEAF_RATIO = 2.5
BF = "bfloat16"


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _f64(tree):
    return _map(tree, lambda _, v: torch.as_tensor(np.asarray(v)).double())


def _models():
    """(name, JAX field, port field kwargs, JAX params as numpy)."""
    out = []
    kw = dict(N_emb_xyz=10, N_emb_dir=4)
    jf = JaxMLP(**kw, compute_dtype=BF)
    out.append(("nerf", jf, TorchMLP, kw,
                _np(jf.init(jax.random.PRNGKey(0)))))
    kw = dict(bound=2.0, n_levels=4, log2_hashmap_size=14)
    jf = JaxNGP(**kw, compute_dtype=BF)
    p = _np(jf.init(jax.random.PRNGKey(1)))
    for lv in jf.grid_spec.levels():
        if not lv.use_hash:
            p["grid"][lv.offset:lv.offset + lv.size] *= np.float32(1e4)
    out.append(("nerf_tcnn", jf, TorchNGP, kw, p))
    kw = dict(bound=2.0, grid_levels=((16, 8), (32, 8)))
    jf = JaxCP(**kw, compute_dtype=BF)
    out.append(("nerf_tpu", jf, TorchCP, kw,
                _np(jf.init(jax.random.PRNGKey(2)))))
    for _, _, _, _, p in out:  # σ mostly positive
        w = p["sigma_net"][1]["w"] if "sigma_net" in p else p["sigma"]["w"]
        w[:, 0] = np.abs(w[:, 0]) * 5
    return out


MODELS = {m[0]: m for m in _models()}


def _near_jax(tag, got, want, ref64):
    """The first bar: max|port − JAX| within BF16_BAR of JAX's scale, or
    within twice JAX's own largest distance from float64 where that is
    larger."""
    scale = max(float(np.abs(want).max()), 1e-6)
    d = float(np.abs(got - want).max())
    bar = max(BF16_BAR * scale, 2.0 * float(np.abs(want - ref64).max()))
    assert d <= bar, f"{tag}: {d / scale:.3e} of scale from JAX"


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _bf16_floor(tag, e_port, e_jax, e_32, n, ratio=F64_RATIO):
    """The lower side of the second bar: where JAX's RMS distance from
    float64 is bf16's (over BF16_SEEN × the port's fp32 field's `e_32`),
    the port's is over BF16_SEEN × its fp32 field's too and, on at least
    N_STAT values, at least F64_FLOOR of JAX's, or 1/`ratio` of it where
    the upper side is wider (on fewer values the ratio is one or a few
    draws of rounding noise)."""
    if e_jax > BF16_SEEN * e_32:
        floor = max(BF16_SEEN * e_32, min(F64_FLOOR, 1.0 / ratio) * e_jax
                    if n >= N_STAT else 0.0)
        assert e_port >= floor, (
            f"{tag}: port {e_port:.3e} from float64, JAX {e_jax:.3e}, "
            f"fp32 {e_32:.3e}: not rounded to bf16")


def _near_f64(tag, got, want, ref64, ref32):
    """The second bar: the port's RMS distance from float64 within
    F64_RATIO of JAX's, and `_bf16_floor`; `ref32` the port's fp32
    field's output."""
    e_port, e_jax = _rms(got, ref64), _rms(want, ref64)
    scale = max(float(np.abs(want).max()), 1e-6)
    print(f"{tag}: port / JAX RMS from float64 "
          f"{e_port / max(e_jax, 1e-300):.3f}")
    assert e_port <= F64_RATIO * e_jax + 1e-7 * scale, (
        f"{tag}: port {e_port:.3e} from float64, JAX {e_jax:.3e}")
    _bf16_floor(tag, e_port, e_jax, _rms(ref32, ref64), np.size(got))


def _leaf_near_f64(tag, got, want, ref64, ref32, ratio):
    """The second bar on one gradient leaf: the port's RMS distance from
    float64 within `ratio` of JAX's or of its own fp32 field's, whichever
    is larger (a leaf whose gradient is fp32-exact in both packages differs
    from float64 by each one's fp32 summation order), and `_bf16_floor`."""
    e_port, e_jax = _rms(got, ref64), _rms(want, ref64)
    e_32 = _rms(ref32, ref64)
    print(f"{tag}: port / max(JAX, fp32) RMS from float64 "
          f"{e_port / max(e_jax, e_32, 1e-300):.3f}")
    assert e_port <= ratio * max(e_jax, e_32), (
        f"{tag}: port {e_port:.3e} from float64, JAX {e_jax:.3e}, fp32 "
        f"{e_32:.3e}")
    _bf16_floor(tag, e_port, e_jax, e_32, np.size(got), ratio)


def _hold(tag, got, want, ref64, ref32):
    """Both bf16 bars on one output; `ref32` the port's fp32 field's."""
    got, want, ref64, ref32 = (np.asarray(x, np.float64)
                               for x in (got, want, ref64, ref32))
    _near_jax(tag, got, want, ref64)
    _near_f64(tag, got, want, ref64, ref32)


@pytest.mark.parametrize("model", list(MODELS))
def test_field_modules_in_bf16(model):
    """density (σ fp32, geo), color from a shared fp32 feature, and the
    normal and mirror heads, on 512 points (the grids' inside the bound)."""
    _, jf, cls, kw, p = MODELS[model]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, 1.5, size=(512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    geo_dim = 256 if model == "nerf" else 15
    g = rng.normal(size=(512, geo_dim)).astype(np.float32)
    tf, t64 = cls(**kw, compute_dtype=BF), cls(**kw)
    pt, p64 = params_from_numpy(p), _f64(p)
    X, D, G = (torch.from_numpy(a) for a in (x, d, g))

    js, jg = jax.jit(lambda a: jf.density(p, a))(x)
    ts, tg = tf.density(pt, X)
    rs, rg = t64.density(p64, X.double())
    ss, sg = t64.density(pt, X)
    assert ts.dtype == torch.float32 and js.dtype == jnp.float32
    assert tg.dtype == (torch.bfloat16 if model == "nerf" else torch.float32)
    _hold(f"{model} sigma", ts.numpy(), js, rs.numpy(), ss.numpy())
    _hold(f"{model} geo", tg.float().numpy(), np.asarray(jg, np.float32),
          rg.numpy(), sg.numpy())
    outs = {
        "color": (jax.jit(lambda a, b: jf.color(p, a, b))(g, d),
                  tf.color(pt, G, D), t64.color(p64, G.double(), D.double()),
                  t64.color(pt, G, D)),
        "normal": (jax.jit(lambda a: jf.normal_head(p, a))(g),
                   tf.normal_head(pt, G), t64.normal_head(p64, G.double()),
                   t64.normal_head(pt, G)),
        "mirror": (jax.jit(lambda a: jf.mirror_head(p, a))(g),
                   tf.mirror_head(pt, G), t64.mirror_head(p64, G.double()),
                   t64.mirror_head(pt, G)),
    }
    for name, (want, got, ref, ref32) in outs.items():
        assert got.dtype == torch.float32, name
        _hold(f"{model} {name}", got.numpy(), want, ref.numpy(),
              ref32.numpy())
    if model != "nerf":
        # the NGP heads stay fp32, as in JAX: identical to the fp32 field's
        torch.testing.assert_close(tf.normal_head(pt, G),
                                   t64.normal_head(pt, G), atol=0, rtol=0)


def _rays(n=32, seed=4):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), 1.5, np.float32)], axis=1)


RS = dict(N_samples=6, N_importance=6, perturb=0.0, noise_std=0.0,
          compute_normal=True, fine_pass="fine")
RENDER_KEYS = ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
               "surface_normal_fine", "surface_normal_grad_fine",
               "rgb_coarse")


@pytest.mark.parametrize("fp32_grad", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("model", list(MODELS))
def test_render_rays_fp32_sigma_grad(model, fp32_grad):
    """render_rays with the σ-gradient normal on a bf16 field; with
    fp32_sigma_grad the normals are the fp32 field's, bit for bit."""
    _, jf, cls, kw, p = MODELS[model]
    params = {"coarse": p, "fine": p}
    rays = _rays()
    want = jax.jit(lambda pp, r: jax_render_rays(
        jf, pp, r, jax.random.PRNGKey(0),
        JaxRS(**RS, fp32_sigma_grad=fp32_grad)))(params, rays)
    rs = RenderSettings(**RS, fp32_sigma_grad=fp32_grad)
    got = render_rays(cls(**kw, compute_dtype=BF), params_from_numpy(params),
                      torch.from_numpy(rays), rs)
    ref = render_rays(cls(**kw), _f64(params),
                      torch.from_numpy(rays).double(), rs)
    f32 = render_rays(cls(**kw), params_from_numpy(params),
                      torch.from_numpy(rays), RenderSettings(**RS))
    for k in RENDER_KEYS:
        _hold(f"{model} {k}", got[k].detach().numpy(), want[k],
              ref[k].detach().numpy(), f32[k].detach().numpy())
    same = torch.equal(got["normal_fine"], f32["normal_fine"])
    assert same == fp32_grad, model


def _trace_loss(res, xp):
    s = xp.sum
    return (s(res["rgb_fine"] * 0.7) + s(res["rgb_coarse"] * 0.3)
            + s(res["normal_dif_fine"]) + s(res["mirror_mask_fine"] * 0.5)
            + s(res["depth_fine"] * 0.1))


@pytest.mark.parametrize("fp32_grad", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("model", list(MODELS))
def test_reflection_stage_loss_and_grads(model, fp32_grad):
    """One level-1 trace (the reflection stage: secondary rays in the GT
    mirrors, the normal losses' grad-of-grad) on a bf16 field: the loss at
    both bars; each parameter gradient leaf at the second bar (within
    F64_RATIO of JAX's RMS distance from float64, or F64_LEAF_RATIO without
    fp32_sigma_grad, and its floor), and over all leaves within F64_RATIO.
    With fp32_sigma_grad each leaf's gradient also meets the first bar.
    Without it the grid tables' gradients come through bf16's ∇σ normals,
    whose noise is JAX's own too (its fine CP-table gradients up to 0.37 of
    their scale from float64), so their largest difference is not held."""
    _, jf, cls, kw, p = MODELS[model]
    params = {"coarse": p, "fine": p}
    rays = _rays(48, seed=5)
    mask = (np.random.default_rng(6).uniform(size=48) < 0.5).astype(
        np.float32)
    rs = dict(RS, detach_density_outside_mirror_for_mask_loss=True,
              fp32_sigma_grad=fp32_grad)
    kw_ts = dict(trace_secondary_rays=True, max_recursive_level=1,
                 only_trace_rays_in_mirrors=True)
    jts = JaxTS(render=JaxRS(**rs), **kw_ts)

    @jax.jit
    def jax_fn(pp):
        def f(q):
            res = jax_trace_rays(jf, q, jnp.asarray(rays), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), jts)
            return _trace_loss(res, jnp)
        return jax.value_and_grad(f)(pp)

    jl, jgrad = jax_fn(params)
    ts = TraceSettings(render=RenderSettings(**rs), **kw_ts)

    def port(field, tree, dtype):
        leaves = tree_leaves(tree)
        for x in leaves:
            x.requires_grad_(True)
        res = trace_rays(field, tree, torch.from_numpy(rays).to(dtype),
                         torch.from_numpy(mask).to(dtype), ts)
        loss = _trace_loss(res, torch)
        loss.backward()
        return loss.detach(), [np.zeros(tuple(x.shape)) if x.grad is None
                               else x.grad.double().numpy() for x in leaves]

    tl, tg = port(cls(**kw, compute_dtype=BF), params_from_numpy(params),
                  torch.float32)
    rl, rg = port(cls(**kw), _f64(params),
                  torch.float64)
    sl, sg = port(cls(**kw), params_from_numpy(params), torch.float32)
    _hold(f"{model} loss", [float(tl)], [float(jl)], [float(rl)],
          [float(sl)])
    jg = [np.asarray(x, np.float64) for x in tree_leaves(_np(jgrad))]
    small = [i for i, a in enumerate(jg) if a.size < N_STAT]
    names = [k for k, _ in _leaves(params)]
    for i, (a, b, r, f) in enumerate(zip(jg, tg, rg, sg)):
        if fp32_grad:
            _near_jax(f"{model} grad {names[i]}", b, a, r)
        if i not in small:
            _leaf_near_f64(f"{model} grad {names[i]}", b, a, r, f,
                           F64_RATIO if fp32_grad else F64_LEAF_RATIO)
    _leaf_near_f64(f"{model} grad leaves under {N_STAT} values",
                   *(np.concatenate([x[i].ravel() for i in small])
                     for x in (tg, jg, rg, sg)),
                   F64_RATIO if fp32_grad else F64_LEAF_RATIO)
    e_port = np.sqrt(sum(float(np.sum((b - r) ** 2)) for b, r in zip(tg, rg)))
    e_jax = np.sqrt(sum(float(np.sum((a - r) ** 2)) for a, r in zip(jg, rg)))
    assert e_port <= F64_RATIO * e_jax, (model, e_port, e_jax)


def test_fused_plain_versions_stay_fp32():
    """The fused kernels' plain versions on the CPU compute a bf16 field in
    fp32 (the kernels ignore compute_dtype, as the JAX package's do): the
    train kernels' density and ∇σ, and the fused composites of the CP grid
    and the flagship, equal the fp32 field's."""
    from mirror_nerf_tpu_torch.ops.fused_cp_train import (
        density_fused, density_with_grad_fused)

    _, _, cls, kw, p = MODELS["nerf_tpu"]
    pt = params_from_numpy(p)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.5, 1.5, size=(64, 3)).astype(np.float32))
    bf, f32 = cls(**kw, compute_dtype=BF), cls(**kw)
    for fn in (density_fused, density_with_grad_fused):
        for a, b in zip(fn(bf, pt, x), fn(f32, pt, x)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    rays = torch.from_numpy(_rays())
    for model in ("nerf_tpu", "nerf"):
        _, _, cls, kw, p = MODELS[model]
        params = params_from_numpy({"coarse": p, "fine": p})
        rs = RenderSettings(**dict(RS, compute_normal=False),
                            fused_field=True, test_time=True)
        a = render_rays(cls(**kw, compute_dtype=BF), params, rays, rs)
        b = render_rays(cls(**kw), params, rays, rs)
        for k in ("rgb_fine", "depth_fine", "mirror_mask_fine"):
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)


# the bf16 hash grid's --fused_field render against JAX's (ROADMAP.md §3):
# the largest difference over the outputs below, as a share of each
# output's scale, is held to the bf16 bar; measured on this test's field
# and rays: 8.7e-4 (depth; rgb 8.4e-5)
HASH_FUSED_BF16_DIFF = BF16_BAR


def test_hash_fused_field_against_jax_unfused_bf16():
    """JAX renders a bf16 NGPField unfused with --fused_field (it has no
    fused hash kernel); the port's fused NGP composite (its plain version
    here) renders it in fp32, so it equals the fp32 field's plain render
    (within 1e-5, fp32 order), while JAX's bf16 render is held to the
    port's own unfused bf16 render at the bf16 bars. The fused render's
    difference from JAX's is bf16's own: it stays within
    HASH_FUSED_BF16_DIFF of each output's scale."""
    _, jf, cls, kw, p = MODELS["nerf_tcnn"]
    params = {"coarse": p, "fine": p}
    rays = _rays()
    rs = dict(RS, compute_normal=False, test_time=True)
    want = jax.jit(lambda pp, r: jax_render_rays(
        jf, pp, r, jax.random.PRNGKey(0),
        JaxRS(**rs, fused_field=True)))(params, rays)
    pt = params_from_numpy(params)
    r = torch.from_numpy(rays)
    fused = render_rays(cls(**kw, compute_dtype=BF), pt, r,
                        RenderSettings(**rs, fused_field=True))
    plain32 = render_rays(cls(**kw), pt, r, RenderSettings(**rs))
    plain16 = render_rays(cls(**kw, compute_dtype=BF), pt, r,
                          RenderSettings(**rs))
    ref = render_rays(cls(**kw), _f64(params),
                      r.double(), RenderSettings(**rs))
    worst = 0.0
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine"):
        torch.testing.assert_close(fused[k], plain32[k], atol=1e-5, rtol=0)
        _hold(f"unfused bf16 {k}", plain16[k].numpy(), want[k],
              ref[k].numpy(), plain32[k].numpy())
        b = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(b).max()), 1e-6)
        worst = max(worst, float(np.abs(fused[k].numpy() - b).max()) / scale)
    assert worst <= HASH_FUSED_BF16_DIFF, worst
