"""Port parity, the eval applications: the F6 repair (the deep trace taken
where the JAX package takes it), the preset tables, `_inject_plane_mirror`
for every preset, `eval_trace_deep`, the roughness bundles, reflection
substitution, guest-object compositing, the D-NeRF guest and both guests
from their reference checkpoint files, each against the JAX package on the
same numpy inputs; and the eval CLI for run.sh modes 3, 4 (both guests),
5, 52 and 6 on a generated scene."""

import contextlib
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.eval import apps as japps
from mirror_nerf_tpu.models import guests as jguests
from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu_torch.eval import apps
from mirror_nerf_tpu_torch.models import guests
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
          test_time=True, compute_normal=False, fine_pass="fine")
SMALL = dict(N_emb_xyz=4, N_emb_dir=2, depth=3, width=32, skips=(1,))
DNERF = dict(depth=3, width=32, multires=4, multires_views=2, skips=(1,))
# the traced levels: secondary rays start at x_surface = o + d·depth and
# reflect about the composited normal, so ~1e-7 rounding differences move
# their samples (tests/test_torch_port_mlp_slice.py TRACE_ATOL)
TRACE_ATOL = 5e-5
# fp32 against fp32, summation order only
ATOL = 1e-5
ROOTS = ("scenes/livingroom", "scenes/washroom", "scenes/office",
         "scenes/other")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rays(n, seed, o_scale=0.1, near=0.5, far=3.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * o_scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), near, np.float32),
                           np.full((n, 1), far, np.float32)], 1)


def _small_params(seed, mirror_shift=0.0):
    """The 3×32 flagship of tests/test_deep_trace.py: σ biased up by 3 (a
    non-empty scene), the mirror head's output bias shifted."""
    p = {"coarse": _np(JaxField(**SMALL).init(jax.random.PRNGKey(seed))),
         "fine": _np(JaxField(**SMALL).init(jax.random.PRNGKey(seed + 1)))}
    for side in p.values():
        side["sigma"]["b"] = side["sigma"]["b"] + 3.0
        side["is_mirror"][1]["b"] = (side["is_mirror"][1]["b"]
                                     + mirror_shift).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def scene():
    """The small flagship and 64 rays, the mirror head's output bias
    shifted (bisection on the port's render) until about half of the rays
    resolve as mirrors at level 0."""
    tf = TorchField(**SMALL)
    rays = _rays(64, 2)
    lo, hi = -20.0, 20.0
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        p = _small_params(0, mid)
        r = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                        RenderSettings(**RS))
        frac = float((r["mirror_mask_fine"] > 0.5).float().mean())
        if abs(frac - 0.5) <= 0.15:
            break
        lo, hi = (lo, mid) if frac > 0.5 else (mid, hi)
    return JaxField(**SMALL), tf, p, rays


def _jax(fn, *a, **kw):
    return {k: np.asarray(v) for k, v in fn(*a, **kw).items()}


def _close(got: dict, want: dict, keys, atol):
    for k in keys:
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(g, want[k], atol=atol, rtol=0, err_msg=k)


def _ctx(tf, p, flags):
    """The port's AppContext from eval-CLI flags, on the CPU, for `tf`."""
    from mirror_nerf_tpu_torch.eval.cli import get_opt

    cfg, args = get_opt(["--predict_normal", "--predict_mirror_mask",
                         "--N_samples", "8", "--N_importance", "8",
                         "--near", "0.5", "--far", "3"] + flags)
    return apps.AppContext.build(cfg, args, tf, params_from_numpy(p), "cpu")


# ---- F6: the deep trace where JAX takes it ----


def test_f6_eval_takes_the_deep_trace(scene):
    """The port's eval (run_view) at --max_recursive_level 5, no
    application: JAX's AppContext takes eval_trace_deep, whose reflect
    outputs are masked by the level-0 mirror mask; so must the port."""
    jf, tf, p, rays = scene
    ctx = _ctx(tf, p, ["--trace_secondary_rays", "--max_recursive_level",
                       "5", "--chunk", "64"])
    got = apps.run_view(ctx, {"rays": rays})
    want = _jax(japps.eval_trace_deep, jf, p, jnp.asarray(rays),
                jax.random.PRNGKey(3), JaxRS(**RS), japps.EvalAppFlags(), 5,
                True)
    m0 = want["mirror_mask_resolved"]
    assert 0.2 <= m0.mean() <= 0.8  # a mirror/non-mirror mix
    # not vacuous: the unrolled trace's level-0 reflect outputs differ
    unrolled = _jax(japps.eval_trace, jf, p, jnp.asarray(rays),
                    jax.random.PRNGKey(3), JaxRS(**RS), japps.EvalAppFlags(),
                    5, True)
    assert np.abs(unrolled["depth_fine_reflect"]
                  - want["depth_fine_reflect"]).max() > 0.1
    _close(got, want, ("rgb_fine", "rgb_fine_reflect", "depth_fine_reflect",
                       "mirror_mask_resolved", "rgb_fine_direct"),
           TRACE_ATOL)
    assert not [k for k in got if k.startswith("_")]
    assert ctx.deep_levels >= 2


@pytest.mark.parametrize("flags,deep", [
    ([], True), (["--app_place_new_mirror"], True),
    (["--app_control_mirror_roughness"], False),
    (["--app_reflect_newly_placed_objects", "--obj_ckpt_path", "x"], False),
    (["--app_reflection_substitution", "--substitution_ckpt_path",
      "x"], False)], ids=["plain", "new_mirror", "roughness", "objects",
                          "substitution"])
def test_deep_trace_selection(flags, deep, monkeypatch):
    """AppContext.deep is JAX's `AppContext.traced` rule: above 3 levels,
    without substitution, guest objects or roughness noise."""
    monkeypatch.setattr(guests, "make_object_render_fn",
                        lambda *a, **kw: None)
    monkeypatch.setattr("mirror_nerf_tpu_torch.train.checkpoints."
                        "load_params_any", lambda path, like, field: like)
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    for level in (3, 4, 50):
        cfg, args = get_opt(["--model_type", "nerf_tpu", "--grid_levels",
                             "16:8", "--predict_normal",
                             "--trace_secondary_rays",
                             "--max_recursive_level", str(level)] + flags)
        ctx = apps.AppContext.build(cfg, args, make_field(cfg), {}, "cpu")
        assert ctx.deep == (deep and level > 3), (flags, level)


# ---- preset tables and the new mirror ----


@pytest.mark.parametrize("root", ROOTS)
def test_preset_tables_match_jax(root):
    for pos in ("plane_x", "plane_y"):
        assert (dataclasses.astuple(apps.plane_preset(pos, root))
                == dataclasses.astuple(japps.plane_preset(pos, root)))
    rot, tr, sc = apps.substitution_transform(root + "/market")
    jrot, jtr, jsc = japps.substitution_transform(root + "/market")
    np.testing.assert_array_equal(rot, jrot)
    assert (tr, sc) == (jtr, jsc)
    for r in (root, root + "/office"):
        assert apps.substitution_transform(r)[1:] == \
            japps.substitution_transform(r)[1:]
    assert apps.object_transform(root) == japps.object_transform(root)


def _results_dict(n, seed):
    """A level-0 results dict with depth in [0, 4] (some below near) and a
    random mirror mask, and the normal and secondary origins."""
    rng = np.random.default_rng(seed)
    res = {"depth_fine": rng.uniform(0.0, 4.0, n).astype(np.float32),
           "mirror_mask_fine": rng.uniform(0, 1, n).astype(np.float32)}
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    sec_o = rng.normal(size=(n, 3)).astype(np.float32)
    return res, normal, sec_o


@pytest.mark.parametrize("pos", ["plane_x", "plane_y"])
@pytest.mark.parametrize("root", ROOTS)
def test_inject_plane_mirror_matches_jax(root, pos):
    """All 8 presets, bit for bit against JAX on the same results dict."""
    spec = japps.plane_preset(pos, root)
    rays = _rays(512, 7, o_scale=0.6, near=0.05, far=8.0)
    res, normal, sec_o = _results_dict(512, 8)
    mask = (res["mirror_mask_fine"] > 0.5).astype(np.float32)
    jr, jm, jn, jo = japps._inject_plane_mirror(
        japps.EvalAppFlags(place_new_mirror=spec), jnp.asarray(rays),
        {k: jnp.asarray(v) for k, v in res.items()}, "fine",
        jnp.asarray(mask), jnp.asarray(normal), jnp.asarray(sec_o))
    tr, tm, tn, to = apps._inject_plane_mirror(
        apps.EvalAppFlags(place_new_mirror=apps.plane_preset(pos, root)),
        torch.from_numpy(rays),
        {k: torch.from_numpy(v) for k, v in res.items()}, "fine",
        torch.from_numpy(mask), torch.from_numpy(normal),
        torch.from_numpy(sec_o))
    new = (np.asarray(jm) > mask)
    assert new.sum() >= 5  # rays land in the rectangle
    for got, want in ((tm, jm), (tn, jn), (to, jo),
                      (tr["depth_fine"], jr["depth_fine"]),
                      (tr["mirror_mask_fine"], jr["mirror_mask_fine"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the deep trace ----


@pytest.mark.parametrize("case", ["plain", "plane", "rs_secondary",
                                  "untraced"])
def test_eval_trace_deep_matches_jax(scene, case):
    jf, tf, p, rays = scene
    spec = (japps.PlaneMirrorSpec(0, 0.5, (1, 0, 0), (-1, 1, -1, 1))
            if case == "plane" else None)
    sec = dict(N_samples=4, N_importance=4) if case == "rs_secondary" \
        else None
    traced = case != "untraced"
    want = _jax(japps.eval_trace_deep, jf, p, jnp.asarray(rays),
                jax.random.PRNGKey(5), JaxRS(**RS),
                japps.EvalAppFlags(place_new_mirror=spec), 5, traced,
                rs_secondary=JaxRS(**{**RS, **sec}) if sec else None)
    got = apps.eval_trace_deep(
        tf, params_from_numpy(p), torch.from_numpy(rays),
        RenderSettings(**RS), apps.EvalAppFlags(place_new_mirror=(
            apps.PlaneMirrorSpec(0, 0.5, (1, 0, 0), (-1, 1, -1, 1))
            if spec else None)), 5, traced,
        rs_secondary=RenderSettings(**{**RS, **sec}) if sec else None)
    assert got["_deep_levels"] >= 2 if traced else \
        got["_deep_levels"] == 0 and "rgb_fine_direct" not in want
    if not traced:
        _close(got, want, ("rgb_fine", "rgb_fine_reflect",
                           "depth_fine_reflect", "mirror_mask_resolved"),
               TRACE_ATOL)
        return
    if spec is not None:
        assert want["mirror_mask_resolved"].max() == 1.0
    _close(got, want, ("rgb_fine", "rgb_fine_direct", "rgb_fine_reflect",
                       "depth_fine_reflect", "depth_fine",
                       "mirror_mask_resolved", "secondary_rays_o",
                       "reflect_direction"), TRACE_ATOL)


def test_eval_trace_deep_records_each_level(scene):
    """`eval_trace_deep(levels=...)` (chip_smoke phase 19's float64 check)
    receives each level's (T after it, rendered rgb): the recursive blend
    rebuilt from them is rgb_fine, and the record leaves the trace as it
    was."""
    _, tf, p, rays = scene
    args = (tf, params_from_numpy(p), torch.from_numpy(rays),
            RenderSettings(**RS), apps.EvalAppFlags(), 5, True)
    levels = []
    got = apps.eval_trace_deep(*args, levels=levels)
    assert len(levels) == got["_deep_levels"] + 1 >= 3
    rebuilt, t_prev = torch.zeros_like(got["rgb_fine"]), torch.ones(len(rays))
    for t, rgb in levels:
        # T after a level is T before it × its mirror mask m: the level
        # adds T_before · (1 − m) · rgb
        rebuilt += (t_prev - t)[:, None] * rgb
        t_prev = t
    assert torch.equal(levels[0][0], got["mirror_mask_resolved"])
    np.testing.assert_allclose(rebuilt.numpy(), got["rgb_fine"].numpy(),
                               atol=1e-6, rtol=0)
    plain = apps.eval_trace_deep(*args)
    for k in ("rgb_fine", "depth_fine_reflect"):
        assert torch.equal(plain[k], got[k]), k


# ---- roughness ----


def _jax_ctx(jf, p, app, level, rs_sec=None):
    cfg = SimpleNamespace(max_recursive_level=level,
                          trace_secondary_rays=True)
    return japps.AppContext(cfg=cfg, args=None, field=jf, params=p,
                            rs=JaxRS(**RS), app=app, rs_sec=rs_sec)


@pytest.mark.parametrize("level", [1, 2])
def test_roughness_bundles_match_jax(scene, level):
    """The base chunk and the mean of 3 perturbed-normal bundles, the same
    noise injected into both packages (JAX: `roughness_bundle()`)."""
    jf, tf, p, rays = scene
    n = rays.shape[0]
    noises = (np.random.default_rng(11).normal(size=(3, n, 3)) * 0.05
              ).astype(np.float32)
    jctx = _jax_ctx(jf, p, japps.EvalAppFlags(roughness=True), level)
    base = _jax(japps.eval_trace, jf, p, jnp.asarray(rays),
                jax.random.PRNGKey(0), jctx.rs, jctx.app, level, True,
                normal_noise=jnp.zeros((n, 3), jnp.float32))
    bundle = jctx.roughness_bundle()
    acc = sum(np.asarray(bundle(p, jnp.asarray(base["secondary_rays_o"]),
                                jnp.asarray(base["_normal_presmooth"]),
                                jnp.asarray(rays), jnp.asarray(z),
                                jax.random.PRNGKey(1))) for z in noises)
    mean = acc / len(noises)
    m = base["mirror_mask_resolved"][:, None]
    want = {"rgb_fine": m * mean + (1 - m) * base["rgb_fine_direct"],
            "rgb_fine_reflect": mean}

    ctx = _ctx(tf, p, ["--trace_secondary_rays", "--max_recursive_level",
                       str(level), "--app_control_mirror_roughness"])
    r = torch.from_numpy(rays)
    got = apps.render_chunk(ctx, r, noises=[torch.from_numpy(z)
                                            for z in noises])
    assert 0.2 <= m.mean() <= 0.8
    assert np.abs(mean - base["_sec_rgb"]).max() > 1e-3  # noise matters
    _close(got, {**base, **want}, ("rgb_fine", "rgb_fine_reflect",
                                   "rgb_fine_direct", "_normal_presmooth",
                                   "_sec_rgb", "mirror_mask_resolved"),
           TRACE_ATOL)


@pytest.mark.parametrize("flags,progress", [
    (["--normal_noise_std", "0"], 0.3),
    (["--normal_noise_std", "0.5", "--normal_noise_std_changes"], 0.0)],
    ids=["std0", "changes_at_progress0"])
def test_roughness_without_noise_is_the_plain_trace(scene, flags, progress):
    """With zero noise (no std, or the time-varying std at progress 0)
    every bundle is the unperturbed reflection: run_view's roughness view
    equals the plain level-1 trace."""
    _, tf, p, rays = scene
    common = ["--trace_secondary_rays", "--chunk", "64"]
    plain = apps.run_view(_ctx(tf, p, common), {"rays": rays})
    rough = apps.run_view(_ctx(tf, p, common + [
        "--app_control_mirror_roughness", "--trace_ray_times", "2"] + flags),
        {"rays": rays}, progress, 3)
    for k in ("rgb_fine", "rgb_fine_reflect", "mirror_mask_resolved"):
        np.testing.assert_allclose(rough[k], plain[k], atol=1e-6, err_msg=k)


def test_roughness_noise_follows_view_and_chunk(scene):
    """The bundles' noise is seeded from the view index and the chunk's
    start: the same view renders the same, another view differently."""
    _, tf, p, rays = scene
    ctx = _ctx(tf, p, ["--trace_secondary_rays", "--chunk", "32",
                       "--app_control_mirror_roughness",
                       "--trace_ray_times", "1", "--normal_noise_std",
                       "0.2"])
    a = apps.run_view(ctx, {"rays": rays}, 0.0, 1)["rgb_fine"]
    b = apps.run_view(ctx, {"rays": rays}, 0.0, 1)["rgb_fine"]
    c = apps.run_view(ctx, {"rays": rays}, 0.0, 2)["rgb_fine"]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4


# ---- substitution ----


class _JaxSub:
    pass


@pytest.mark.parametrize("root", ["scenes/market", "scenes/office",
                                  "scenes/other"])
def test_substitution_matches_jax(scene, root):
    """Level-0 secondary rays rendered in a second field, moved by the
    scene's transform (market: a rotation)."""
    jf, tf, p, rays = scene
    ps = _small_params(4)
    js = _JaxSub()
    js.field, js.transform = jf, japps.substitution_transform(root)
    app = dict(substitution=True)
    want = _jax(japps.eval_trace, jf, p, jnp.asarray(rays),
                jax.random.PRNGKey(0), JaxRS(**RS),
                japps.EvalAppFlags(**app), 1, True, subst_params=ps,
                subst_field=js)
    got = apps.eval_trace(
        tf, params_from_numpy(p), torch.from_numpy(rays),
        RenderSettings(**RS), apps.EvalAppFlags(**app), 1, True,
        subst_params=params_from_numpy(ps),
        subst_field=apps.SubstitutedField(
            tf, apps.substitution_transform(root)))
    plain = apps.eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                            RenderSettings(**RS), apps.EvalAppFlags(), 1,
                            True)
    assert (got["rgb_fine_reflect"] - plain["rgb_fine_reflect"]
            ).abs().max() > 1e-3  # the substituted field renders
    _close(got, want, ("rgb_fine", "rgb_fine_reflect", "depth_fine_reflect",
                       "mirror_mask_resolved"), TRACE_ATOL)


# ---- guest objects and D-NeRF ----


@pytest.fixture(scope="module")
def dnerf():
    jfield = jguests.DNeRFField(**DNERF)
    p = _np(jfield.init(jax.random.PRNGKey(6)))
    p["alpha"]["b"] = p["alpha"]["b"] + 2.0  # an opaque object
    pf = _np(jfield.init(jax.random.PRNGKey(7)))
    pf["alpha"]["b"] = pf["alpha"]["b"] + 2.0
    return jfield, guests.DNeRFField(**DNERF), p, pf


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_dnerf_raw_matches_jax(dnerf, t):
    jfield, tfield, p, _ = dnerf
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jfield.raw(p, jnp.asarray(xyz), jnp.asarray(dirs),
                                 jnp.asarray(t, jnp.float32)))
    got = tfield.raw(guests.dnerf_params_from_numpy(p),
                     torch.from_numpy(xyz), torch.from_numpy(dirs), t)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if t == 0.0:  # zero_canonical: the time net has no effect at t = 0
        q = dict(p, time_out={k: v * 0 + 1 for k, v in p["time_out"].items()})
        np.testing.assert_array_equal(
            tfield.raw(guests.dnerf_params_from_numpy(q),
                       torch.from_numpy(xyz), torch.from_numpy(dirs),
                       t).numpy(), got.numpy())


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_dnerf_render_matches_jax(dnerf, t):
    """64 samples, then a deterministic fine pass through the fine net."""
    jfield, tfield, p, pf = dnerf
    rays = _rays(32, 9, near=2.0, far=6.0)
    want = _jax(jguests.dnerf_render, jfield, p, jnp.asarray(rays),
                jnp.asarray(t, jnp.float32), jax.random.PRNGKey(0), 16, 8,
                white_bkgd=True, params_fine=pf)
    got = guests.dnerf_render(tfield, guests.dnerf_params_from_numpy(p),
                              torch.from_numpy(rays), t, 16, 8,
                              white_bkgd=True,
                              params_fine=guests.dnerf_params_from_numpy(pf))
    assert want["opacity"].mean() > 0.5
    _close(got, want, ("rgb", "depth", "opacity"), ATOL)


def _dnerf_fns(dnerf, transform):
    jfield, tfield, p, _ = dnerf
    tp = guests.dnerf_params_from_numpy(p)

    def jfn(rays, t):
        rays = rays.at[:, 6].set(2.0).at[:, 7].set(6.0)
        return jguests.dnerf_render(jfield, p, rays, jnp.asarray(t),
                                    jax.random.PRNGKey(0), 8, 0,
                                    white_bkgd=True)

    def tfn(rays, t):
        rays = rays.clone()
        rays[:, 6], rays[:, 7] = 2.0, 6.0
        return guests.dnerf_render(tfield, tp, rays, t, 8, 0,
                                   white_bkgd=True)

    jfn.transform = transform
    return jfn, guests.ObjectRenderer(tfn, transform)


@pytest.mark.parametrize("t", [0.0, 0.5])
def test_composite_object_matches_jax(dnerf, t):
    """On a results dict whose depth straddles the object's: drawn where
    opaque and in front, the mirror mask cleared there."""
    jfn, tfn = _dnerf_fns(dnerf, ((0.1, -0.2, 0.0), 2.0))
    rays = _rays(256, 12, near=0.05, far=8.0)
    res, _, _ = _results_dict(256, 13)
    res["rgb_fine"] = np.random.default_rng(14).uniform(
        size=(256, 3)).astype(np.float32)
    app = dict(reflect_objects=True, near=0.05)
    want = japps._composite_object(
        japps.EvalAppFlags(**app), jfn, jnp.asarray(rays),
        {k: jnp.asarray(v) for k, v in res.items()}, "fine", t)
    got = apps._composite_object(
        apps.EvalAppFlags(**app), tfn, torch.from_numpy(rays),
        {k: torch.from_numpy(v) for k, v in res.items()}, "fine", t)
    drawn = np.asarray(want["mirror_mask_fine"]) != res["mirror_mask_fine"]
    assert 0 < drawn.sum() < 256 * 0.9
    _close(got, {k: np.asarray(v) for k, v in want.items()},
           ("rgb_fine", "depth_fine", "mirror_mask_fine"), ATOL)


def test_eval_trace_with_object_matches_jax(scene, dnerf):
    """A guest object composited into both levels of a level-1 trace."""
    jf, tf, p, _ = scene
    rays = _rays(64, 15, o_scale=0.1, near=0.05, far=3.0)
    jfn, tfn = _dnerf_fns(dnerf, ((0.0, 0.0, 0.0), 2.0))
    app = dict(reflect_objects=True, near=0.05)
    want = _jax(japps.eval_trace, jf, p, jnp.asarray(rays),
                jax.random.PRNGKey(0), JaxRS(**RS),
                japps.EvalAppFlags(**app), 1, True, obj_render_fn=jfn,
                frame_time=jnp.float32(0.5))
    got = apps.eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                          RenderSettings(**RS), apps.EvalAppFlags(**app), 1,
                          True, obj_render_fn=tfn, frame_time=0.5)
    _close(got, want, ("rgb_fine", "rgb_fine_reflect", "depth_fine",
                       "mirror_mask_resolved"), TRACE_ATOL)


@pytest.fixture(scope="module")
def guest_files(tmp_path_factory):
    """A D-NeRF .tar (seeded reference-layout state dicts, 3×32, the
    reference's skip at 4) with its config.txt, and a nerf_pl Lightning
    .ckpt (the port's save_torch_ckpt of a head-less flagship)."""
    from mirror_nerf_tpu_torch.train.checkpoints import save_torch_ckpt

    root = tmp_path_factory.mktemp("guests")
    df = guests.DNeRFField(depth=3, width=32, multires=4, multires_views=2)
    g = torch.Generator().manual_seed(21)
    fn, fine = df.init(g), df.init(g)
    for q in (fn, fine):
        q["alpha"]["b"] = q["alpha"]["b"] + 2.0
    torch.save({"global_step": 7,
                "network_fn_state_dict": guests.dnerf_state_dict(fn),
                "network_fine_state_dict": guests.dnerf_state_dict(fine)},
               root / "dnerf.tar")
    (root / "config.txt").write_text(
        "expname = lego  # a comment\nnetdepth = 3\nnetwidth = 32\n"
        "multires = 4\nmultires_views = 2\nN_samples = 8\n"
        "N_importance = 4\nuse_viewdirs = True\nlrate = 5e-4\n")
    field = TorchField(predict_normal=False, predict_mirror_mask=False)
    g = torch.Generator().manual_seed(22)
    params = {"coarse": field.init(g), "fine": field.init(g)}
    for side in params.values():
        side["sigma"]["w"][:, 0] = side["sigma"]["w"][:, 0].abs() * 5
    save_torch_ckpt(str(root / "nerf_pl.ckpt"), params)
    return root


@pytest.mark.parametrize("kind", ["d_nerf", "nerf_pl"])
def test_guest_from_files_matches_jax(guest_files, kind):
    """make_object_render_fn on the reference's checkpoint files against
    the JAX package's on the same files."""
    path = str(guest_files / ("dnerf.tar" if kind == "d_nerf"
                              else "nerf_pl.ckpt"))
    transform = ((0.0, 0.5, 0.0), 2.0)
    jfn = jguests.make_object_render_fn(None, kind, path, transform)
    tfn = guests.make_object_render_fn(kind, path, transform)
    assert tfn.transform == transform
    if kind == "d_nerf":
        assert guests.parse_dnerf_config(str(guest_files / "config.txt")) \
            == jguests.parse_dnerf_config(str(guest_files / "config.txt"))
    rays = _rays(32, 16, o_scale=0.3, near=0.05, far=8.0)
    for t in (0.0, 0.5):
        want = _jax(jfn, jnp.asarray(rays), jnp.float32(t))
        got = tfn(torch.from_numpy(rays), t)
        assert np.isfinite(want["rgb"]).all()
        _close(got, want, ("rgb", "depth", "opacity"),
               ATOL if kind == "d_nerf" else TRACE_ATOL)


# ---- the eval CLI, run.sh modes 3, 4, 5, 52, 6 ----


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory, guest_files):
    """A generated 12×12 scene and seeded narrow CP-grid weights (the
    all-mirror variant: σ column |w|·5, mirror bias +5), as an npz."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
    from mirror_nerf_tpu_torch.train.checkpoints import save_pytree

    root = tmp_path_factory.mktemp("apps_cli")
    generate_scene(str(root / "scene"), n_train=1, n_val=1, n_test=2,
                   img_wh=(12, 12))
    f = TPUGridField(bound=6.0, grid_levels=((16, 8), (32, 8)))
    g = torch.Generator().manual_seed(5)
    params = {"coarse": f.init(g), "fine": f.init(g)}
    for side in params.values():
        side["sigma_net"][1]["w"][:, 0] = side["sigma_net"][1]["w"][:, 0] \
            .abs() * 5
        side["is_mirror"][1]["b"] = side["is_mirror"][1]["b"] + 1.0
    save_pytree(str(root / "w.npz"), params)
    return root


# run.sh EVAL_FLAGS for nerf_tpu (--fused_field), at a tiny size
CLI = ["--dataset_name", "blender", "--root_dir", "scene", "--near", "0.05",
       "--far", "8", "--img_wh", "12", "12", "--model_type", "nerf_tpu",
       "--predict_normal", "--predict_mirror_mask", "--trace_secondary_rays",
       "--bound", "6", "--grid_levels", "16:8,32:8", "--N_samples", "8",
       "--N_importance", "8", "--ckpt_path", "w.npz", "--chunk", "64",
       "--fused_field", "--split", "test", "--device", "cpu"]
MODES = {
    "3": ["--max_recursive_level", "50", "--app_place_new_mirror",
          "--plane_pos", "plane_x"],
    "4_d_nerf": ["--app_reflect_newly_placed_objects", "--obj_ckpt_path",
                 "GUESTS/dnerf.tar"],
    "4_nerf_pl": ["--app_reflect_newly_placed_objects", "--obj_ckpt_path",
                  "GUESTS/nerf_pl.ckpt", "--obj_model_type", "nerf_pl"],
    "5": ["--app_control_mirror_roughness", "--trace_ray_times", "64",
          "--normal_noise_std", "0.0025"],
    "52": ["--app_control_mirror_roughness", "--trace_ray_times", "64",
           "--normal_noise_std", "0.01", "--normal_noise_std_changes"],
    "6": ["--app_reflection_substitution", "--substitution_ckpt_path",
          "w.npz"],
}


# modes 3 (50 levels) and 5 (64 bundles) are the slowest cases: each runs
# from a module of its own (test_torch_port_apps_mode3.py, _mode5.py), so
# that `--dist loadfile` gives it a worker of its own
SLOW_MODES = ("3", "5")


@pytest.mark.parametrize("mode", [m for m in MODES if m not in SLOW_MODES])
def test_eval_cli_applications(cli_scene, guest_files, mode, monkeypatch):
    eval_cli_application(cli_scene, guest_files, mode, monkeypatch)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread. A 12×12 view through the applications
    is thousands of tiny ops; under `pytest -n 6` every core is busy, and
    each op's OpenMP team waits for threads the other workers hold: the
    mode-3 CLI case took 179–257 s in tier-1 runs, 6 s alone, and 79 s
    against 16.6 s with one thread beside five busy processes (8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def eval_cli_application(cli_scene, guest_files, mode, monkeypatch):
    """The eval CLI for one run.sh mode: the result tree of two views."""
    from mirror_nerf_tpu_torch.eval import main

    monkeypatch.chdir(cli_scene)
    extra = [a.replace("GUESTS", str(guest_files)) for a in MODES[mode]]
    with one_thread():
        out = main(CLI + extra + ["--exp_name", f"mode{mode}"])
    files = set(os.listdir(out))
    for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                 f"mode{mode}_rgb_fine.gif"):
        assert name in files, name
    for sub in ("depth", "mirror_mask", "depth_reflect"):
        assert len(os.listdir(os.path.join(out, sub))) == 2, sub
    table = json.load(open(os.path.join(out, "psnr.json")))
    assert len(table["psnrs"]) == 2 and np.isfinite(table["psnrs"]).all()
