"""Port parity, the σ-noise fused render of both models: `render_rays` and
`trace_rays` with `fused_field=True, noise_std=1` through the port's rows
path (the plain versions, on the CPU) against the JAX package with the same
key, JAX's noise injected (`sigma_noise`, drawn here as JAX
`render_rays` splits its key, renderer.py:493, and `trace_rays` folds in the
level, tracer.py:180); the JAX CP grid through its fused rows kernel
(interpret mode, fp32), the JAX flagship through its fp32 field modules
(its rows kernel casts to bf16). Also: the rows path draws its noise where
the plain pass does, and `fused_t=False` matches the composite route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxMLP
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxCP
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.renderer import render_rays as jax_render_rays
from mirror_nerf_tpu.render.tracer import TraceSettings as JaxTS
from mirror_nerf_tpu.render.tracer import trace_rays as jax_trace_rays
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchMLP
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchCP
from mirror_nerf_tpu_torch.ops import fused_cp, fused_mlp
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.render.tracer import TraceSettings, trace_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=1.0,
          compute_normal=False, fine_pass="fine")
# fp32 against fp32, summation order only
CP_ATOL = 1e-5
# the flagship: the top posenc band (2⁹) multiplies rounding differences of
# the sample positions, and at the traced levels of the secondary origins
# and reflected directions too (ROADMAP §3: measured 1.4e-5)
MLP_ATOL = 5e-5
TRACE_KEYS = ("rgb_fine", "rgb_fine_direct", "depth_fine", "opacity_fine",
              "mirror_mask_fine", "mirror_mask_resolved")
# render_rays outputs held to JAX: the per-ray ones and the coarse pass's
# samples. Not the fine pass's per-sample z and weights: in the flat tail of
# the coarse CDF a pdf sample moves by ~1e-3 between torch's CPU cumsum
# (float64 accumulation) and XLA's (float32) — ROADMAP §3 — and moves only
# its own near-zero weight
RENDER_PREFIXES = ("rgb_", "depth_", "opacity_", "mirror_mask_",
                   "surface_normal_", "x_surface_", "weights_coarse",
                   "z_vals_coarse")


def _rays(n: int, far: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.05, np.float32),
                           np.full((n, 1), far, np.float32)], axis=1)


def _all_mirror(p: dict) -> dict:
    """The mirror head biased on (+5): every ray is a mirror at every
    level, so the traced levels blend in."""
    p["is_mirror"][1]["b"] = p["is_mirror"][1]["b"] + np.float32(5.0)
    return p


@pytest.fixture(scope="module")
def cp_scene():
    jf = JaxCP(bound=2.0, grid_levels=((16, 8), (32, 8)))
    tf = TorchCP(bound=2.0, grid_levels=((16, 8), (32, 8)))
    params = {}
    for seed, side in enumerate(("coarse", "fine")):
        p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
        p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
        params[side] = _all_mirror(p)
    return jf, tf, params, _rays(12, 2.5, seed=0), CP_ATOL


@pytest.fixture(scope="module")
def mlp_scene():
    """Full width; σ column positive ×5, trunk and mirror head ×√6 (He's
    variance: at the plain init every ray would see the same field)."""
    jf, tf = JaxMLP(), TorchMLP()
    params = {}
    for seed, side in enumerate(("coarse", "fine")):
        p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
        p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * 5
        for layer in p["trunk"] + p["is_mirror"]:
            layer["w"] *= np.float32(np.sqrt(6.0))
        params[side] = _all_mirror(p)
    return jf, tf, params, _rays(8, 4.0, seed=1), MLP_ATOL


def _scene(request, name):
    return request.getfixturevalue(name)


def _jax_noise(key, n: int) -> dict:
    """The σ noise one JAX `render_rays(key)` draws, as `sigma_noise`."""
    _, k_noise_c, _, k_noise_f = jax.random.split(key, 4)
    fine = RS["N_samples"] + RS["N_importance"]
    return {"coarse": torch.from_numpy(np.array(
                jax.random.normal(k_noise_c, (n, RS["N_samples"])))),
            "fine": torch.from_numpy(np.array(
                jax.random.normal(k_noise_f, (n, fine))))}


def _count_rows(monkeypatch) -> list:
    """Count the calls of both rows plain versions (what the rows path runs
    on the CPU)."""
    calls = []
    for mod, name in ((fused_cp, "cp_rays_rows_reference"),
                      (fused_mlp, "mlp_rows_reference")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, **k):
            calls.append(1)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _compare(got: dict, want: dict, keys, atol: float):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("test_time", [True, False],
                         ids=["test_time", "coarse_rgb"])
@pytest.mark.parametrize("scene", ["cp_scene", "mlp_scene"])
def test_noise_render_matches_jax(request, monkeypatch, scene, test_time):
    """render_rays, fused_field=True, noise_std=1, perturb=0: the port's
    rows path with JAX's noise injected against JAX render_rays with the
    same key (the CP grid through the JAX fused rows kernel, the flagship
    through the JAX field modules)."""
    jf, tf, p, rays, atol = _scene(request, scene)
    key = jax.random.PRNGKey(3)
    jax_fused = scene == "cp_scene"
    want = jax_render_rays(jf, p, jnp.asarray(rays), key, JaxRS(
        **RS, test_time=test_time, fused_field=jax_fused))
    calls = _count_rows(monkeypatch)
    got = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                      RenderSettings(**RS, test_time=test_time,
                                     fused_field=True),
                      sigma_noise=_jax_noise(key, len(rays)))
    assert len(calls) == 2  # both passes through the rows path
    keys = [k for k in got if k.startswith(RENDER_PREFIXES)]
    assert len(keys) == (9 if test_time else 14)
    assert float(got["opacity_fine"].min()) > 0.1  # not vacuous
    _compare(got, want, keys, atol)
    # the noise matters: without it the render differs
    quiet = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                        RenderSettings(**{**RS, "noise_std": 0.0},
                                       test_time=test_time, fused_field=True))
    assert float((quiet["weights_coarse"]
                  - got["weights_coarse"]).abs().max()) > 1e-4


@pytest.mark.parametrize("scene", ["cp_scene", "mlp_scene"])
def test_rows_path_draws_noise_where_the_plain_pass_does(request, scene):
    """Same generator seed, perturb 1 (stratified and pdf draws around the
    noise draws): the fused rows path renders what the plain field modules
    render, so it draws the same numbers in the same order."""
    _, tf, p, rays, atol = _scene(request, scene)
    pt = params_from_numpy(p)
    got, want = (render_rays(tf, pt, torch.from_numpy(rays), RenderSettings(
        **{**RS, "perturb": 1.0}, test_time=False, fused_field=fused),
        torch.Generator().manual_seed(11)) for fused in (True, False))
    assert set(got) <= set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


def test_fused_t_off_matches_the_composite_route(mlp_scene, monkeypatch):
    """The flagship at noise 0: `fused_t=False` takes the rows path and
    composites outside (cumprod), `fused_t=True` the in-kernel composite
    (exclusive prefix); JAX tests/test_fused_t.py:56-75 compares the
    same two routes."""
    _, tf, p, rays, _ = mlp_scene
    pt = params_from_numpy(p)
    common = {**RS, "noise_std": 0.0, "test_time": True, "fused_field": True}
    calls = _count_rows(monkeypatch)
    rows = render_rays(tf, pt, torch.from_numpy(rays),
                       RenderSettings(**common, fused_t=False))
    assert len(calls) == 2
    comp = render_rays(tf, pt, torch.from_numpy(rays),
                       RenderSettings(**common, fused_t=True))
    assert len(calls) == 2
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse", "weights_fine"):
        np.testing.assert_allclose(rows[k].numpy(), comp[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("scene", ["cp_scene", "mlp_scene"])
def test_trace_rays_level2_noise_matches_jax(request, scene):
    """trace_rays to level 2 with the σ-noise fused settings: the port,
    JAX's noise injected per level, against JAX trace_rays with the same
    key; every ray a mirror at every level, so levels 1 and 2 blend in."""
    jf, tf, p, rays, atol = _scene(request, scene)
    rs = {**RS, "test_time": True}
    trace = dict(trace_secondary_rays=True, max_recursive_level=2)
    key = jax.random.PRNGKey(5)
    gt = np.full(len(rays), -1.0, np.float32)
    want = jax_trace_rays(jf, p, jnp.asarray(rays), jnp.asarray(gt), key,
                          JaxTS(render=JaxRS(**rs, fused_field=scene
                                             == "cp_scene"), **trace))
    noise, k = [], key
    for level in range(3):  # tracer.py:180, one render key per level
        k_render, k = jax.random.split(jax.random.fold_in(k, level))
        noise.append(_jax_noise(k_render, len(rays)))
    got = trace_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                     torch.from_numpy(gt), TraceSettings(
                         render=RenderSettings(**rs, fused_field=True),
                         **trace), sigma_noise=noise)
    assert float(got["mirror_mask_resolved"].mean()) == 1.0
    _compare(got, want, TRACE_KEYS, atol)
