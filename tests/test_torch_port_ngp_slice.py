"""Port parity, the hash-grid model's (`--model_type nerf_tcnn`) novel-view
slice: `NGPField` at full width (16 levels × 2 features, 2¹⁹ rows a level,
bound 6) against the JAX `NGPField`; the npz bridge both ways and the
reference's MirrorNeRFTcnn Lightning `.ckpt` (this package's blob layout,
tcnn's, and the wrong-size error) against the JAX loader; `render_rays` and
the level-2 Whitted `eval_trace`; and the eval CLI with
`--model_type nerf_tcnn --device cpu` in a process where jax is blocked.

Tables are the ±1e-4 init ×1e4 (O(1)) for the field. The renders use the
four dense levels only (×1e4, the hashed levels zero): the finest level
has 12288 cells a side, so one ulp of a position is 7e-4 of a cell there,
and the two packages round positions differently — eager JAX divides
x + bound by 2·bound, jit folds the reciprocal into each level's scale, the
port multiplies by the fp32 reciprocal (as PyTorch does on the card);
o + d·z is one fused multiply-add in XLA and two roundings in PyTorch. The
encoder's hashed levels are held to JAX at ×1e4 on identical positions
(here and in tests/test_torch_port_hashgrid.py)."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.eval.apps import EvalAppFlags as JaxApp
from mirror_nerf_tpu.eval.apps import eval_trace as jax_eval_trace
from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.renderer import render_rays as jax_render_rays
from mirror_nerf_tpu.train import checkpoints as jck
from mirror_nerf_tpu_torch.eval.apps import EvalAppFlags, eval_trace
from mirror_nerf_tpu_torch.models.ngp import NGPField as TorchNGP
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train import checkpoints as tck
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
          test_time=True, compute_normal=False, fine_pass="fine")
KEYS = ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
        "surface_normal_fine", "weights_coarse")
# fp32 against fp32, the same positions: summation order only
ATOL = 1e-5
# the traced levels: a secondary ray starts at o + d·depth and reflects
# about the composited normal, so rounding differences of depth and normal
# move its samples (the flagship's bar, tests/test_torch_port_mlp_slice.py)
TRACE_ATOL = 5e-5
SMALL = dict(n_levels=4, log2_hashmap_size=12)


def _params(jf, seed, scale_hashed=True):
    """JAX-initialized params: the table ×1e4 (every level, or the dense
    ones only), the σ column made positive ×5 so most samples have σ ≥ 0."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    for lv in jf.grid_spec.levels():
        if scale_hashed or not lv.use_hash:
            p["grid"][lv.offset:lv.offset + lv.size] *= np.float32(1e4)
    p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
    return p


@pytest.fixture(scope="module")
def fields():
    return JaxNGP(bound=6.0), TorchNGP(bound=6.0)


# ----------------------------------------------------------------- field


def test_field_matches_jax(fields):
    """density (σ, geo), color, normal and mirror heads at full width, the
    whole table ×1e4, on points ~3 % of which lie outside the bound.

    x01 = (x + 6)/12: eager JAX divides, the port multiplies by fp32(1/12)
    (as PyTorch does on the card), and the two differ by one ulp for a
    third of the coordinates — 7e-4 of a cell at the finest level, 1e-3 in
    σ on O(1) tables. (Under jit XLA folds 1/12 into each level's scale, a
    third rounding.) So the density is compared where the two roundings of
    x01 agree, where both sides then interpolate at the same positions."""
    jf, tf = fields
    p = _params(jf, 0)
    pt = params_from_numpy(p)
    rng = np.random.default_rng(1)
    x = rng.uniform(-6.06, 6.06, (6000, 3)).astype(np.float32)
    b = np.float32(6.0)
    same = (((x + b) / np.float32(12.0))
            == ((x + b) * (np.float32(1.0) / np.float32(12.0)))).all(-1)
    x = np.concatenate([[[-6, 0, 0], [0, 0, 0], [-6, -6, -6]],
                        x[same]]).astype(np.float32)
    sig_j, geo_j = jf.density(p, jnp.asarray(x))
    sig_t, geo_t = tf.density(pt, torch.from_numpy(x))
    oob = (np.abs(x) > 6).any(-1)
    assert len(x) > 1000 and 0.01 < oob.mean() < 0.06
    assert np.abs(np.asarray(sig_j)).max() > 1  # O(1) features
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(geo_t.numpy(), np.asarray(geo_j), atol=ATOL,
                               rtol=0)
    # the ±6 faces: (6 + 6)·fp32(1/12) rounds to exactly 1 (n·fl(1/n) is
    # within 2⁻²⁴ of 1), so the faces lie in bound on both sides
    face = np.float32([[6, 0, 0], [0, 6, 0], [6, 6, -6], [-6, 6, 0]])
    assert np.array_equal((face + b) * (np.float32(1) / np.float32(12)),
                          (face + b) / np.float32(12))
    sig_f = tf.density(pt, torch.from_numpy(face))[0].numpy()
    assert np.abs(sig_f).min() > 0
    np.testing.assert_allclose(sig_f, np.asarray(jf.density(
        p, jnp.asarray(face))[0]), atol=ATOL, rtol=0)
    geo = rng.standard_normal((3000, 15)).astype(np.float32)
    d = rng.standard_normal((3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for name, jfn, tfn in (
            ("color", lambda: jf.color(p, jnp.asarray(geo), jnp.asarray(d)),
             lambda: tf.color(pt, torch.from_numpy(geo), torch.from_numpy(d))),
            ("normal", lambda: jf.normal_head(p, jnp.asarray(geo)),
             lambda: tf.normal_head(pt, torch.from_numpy(geo))),
            ("mirror", lambda: jf.mirror_head(p, jnp.asarray(geo)),
             lambda: tf.mirror_head(pt, torch.from_numpy(geo)))):
        np.testing.assert_allclose(tfn().numpy(), np.asarray(jfn()),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_init_structure_matches_jax(fields):
    jf, tf = fields
    pj = jf.init(jax.random.PRNGKey(0))
    pt = tf.init(torch.Generator().manual_seed(0))
    lj, lt = list(tck._leaves(pj)), list(tck._leaves(pt))
    assert [k for k, _ in lj] == [k for k, _ in lt]
    for (k, a), (_, b) in zip(lj, lt):
        assert tuple(np.shape(a)) == tuple(b.shape), k
    assert tuple(pt["grid"].shape) == (6_616_280, 2)
    assert float(pt["grid"].abs().max()) <= 1e-4


def test_npz_roundtrip_both_ways(tmp_path, fields):
    jf, tf = fields
    pj = {"coarse": _params(jf, 0), "fine": _params(jf, 1)}
    jck.save_pytree(str(tmp_path / "jax.npz"), pj)
    like = {"coarse": tf.init(), "fine": tf.init()}
    got = tck.load_params_any(str(tmp_path / "jax.npz"), like)
    tck.save_pytree(str(tmp_path / "torch.npz"), got)
    back = jck.load_pytree(str(tmp_path / "torch.npz"), pj)
    for (k, a), (_, b), (_, c) in zip(tck._leaves(pj), tck._leaves(got),
                                      tck._leaves(back)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=k)


# ----------------------------------------------- the Lightning checkpoint


def _tcnn_state_dict(prefix, field, rng):
    """One reference MirrorNeRFTcnn module as published: tcnn's fp16 grid
    blob (its per-level entry counts) and the nets in torch's (out, in)
    layout (the construction of tests/test_torch_parity.py:277-307)."""
    sizes = jck._tcnn_level_sizes(field.grid_spec)
    sd = {f"{prefix}.encoder.params": torch.from_numpy(
        rng.normal(0, 1e-4, (sum(sizes) * 2,)).astype(np.float16))}

    def w(name, o, i):
        sd[f"{prefix}.{name}.weight"] = torch.from_numpy(
            rng.normal(size=(o, i)).astype(np.float32))

    dims = [field.in_dim] + [field.hidden_dim] * (field.num_layers - 1) + [
        1 + field.geo_feat_dim]
    for i in range(field.num_layers):
        w(f"sigma_net.{i}", dims[i + 1], dims[i])
    cdims = [field.in_dim_dir + field.geo_feat_dim] + [
        field.hidden_dim_color] * (field.num_layers_color - 1) + [3]
    for i in range(field.num_layers_color):
        w(f"color_net.{i}", cdims[i + 1], cdims[i])
    ndims = [field.geo_feat_dim] + [field.hidden_dim] * (
        field.num_layers - 1) + [3]
    for i in range(field.num_layers):
        w(f"normal_net.{i}", ndims[i + 1], ndims[i])
    h = field.hidden_dim // 2
    w("is_mirror_net.0", h, field.geo_feat_dim)
    w("is_mirror_net.2", 1, h)
    for name, n in (("is_mirror_net.0", h), ("is_mirror_net.2", 1)):
        sd[f"{prefix}.{name}.bias"] = torch.from_numpy(
            rng.normal(size=(n,)).astype(np.float32))
    return sd


@pytest.mark.parametrize("layout", ["ours", "tcnn"])
def test_lightning_ckpt_loads_like_jax(tmp_path, layout):
    """Both blob sizes load to the arrays JAX's `load_params_any` gives:
    this package's row layout (written by `save_torch_ckpt`) wholesale,
    tcnn's per level with the padding rows kept from the init."""
    jf, tf = JaxNGP(bound=1.0, **SMALL), TorchNGP(bound=1.0, **SMALL)
    path = str(tmp_path / "ngp.ckpt")
    pj = {"coarse": _params(jf, 0), "fine": _params(jf, 1)}
    if layout == "ours":
        tck.save_torch_ckpt(path, pj)
        sd = torch.load(path, weights_only=False)["state_dict"]
        assert tuple(sd["nerf_fine.encoder.params"].shape) == (
            jf.grid_spec.table_rows * 2,)
        assert tuple(sd["nerf_coarse.sigma_net.0.weight"].shape) == (
            64, jf.in_dim)
    else:
        rng = np.random.default_rng(7)
        sd = {**_tcnn_state_dict("nerf_coarse", jf, rng),
              **_tcnn_state_dict("nerf_fine", jf, rng)}
        torch.save({"state_dict": sd, "epoch": 29}, path)
    like_j = {"coarse": jf.init(jax.random.PRNGKey(0)),
              "fine": jf.init(jax.random.PRNGKey(1))}
    like_t = params_from_numpy(jax.tree_util.tree_map(np.asarray, like_j))
    want = jck.load_params_any(path, like_j, field=jf)
    got = tck.load_params_any(path, like_t, tf)
    leaves = list(tck._leaves(got))
    assert [k for k, _ in leaves] == [k for k, _ in tck._leaves(like_j)]
    for (k, a), (_, b) in zip(leaves, tck._leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    if layout == "ours":
        for (k, a), (_, b) in zip(leaves, tck._leaves(pj)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def test_lightning_ckpt_without_field(tmp_path, fields):
    """The published default (bound 6) loads without the field: the grid
    spec comes from the table's row count, as in the JAX loader."""
    jf, _ = fields
    p = {"coarse": _params(jf, 0)}
    path = str(tmp_path / "default.ckpt")
    tck.save_torch_ckpt(path, p)
    got = tck.load_params_any(path, params_from_numpy(p))
    np.testing.assert_array_equal(got["coarse"]["grid"].numpy(),
                                  p["coarse"]["grid"])
    assert tck._bound_from_rows(6_616_280) == 6.0


def test_lightning_ckpt_wrong_size_raises(tmp_path):
    jf, tf = JaxNGP(bound=1.0, **SMALL), TorchNGP(bound=1.0, **SMALL)
    sd = _tcnn_state_dict("nerf_coarse", jf, np.random.default_rng(8))
    sd["nerf_coarse.encoder.params"] = torch.zeros(38)  # garbage size
    path = str(tmp_path / "bad.ckpt")
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="rows"):
        jck.load_params_any(path, {"coarse": jf.init(jax.random.PRNGKey(0))},
                            field=jf)
    with pytest.raises(ValueError, match="rows"):
        tck.load_params_any(path, {"coarse": tf.init()}, tf)
    # and the hash-grid layout refuses the other models' parameters
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField

    cp = TPUGridField(grid_levels=((16, 8),))
    with pytest.raises(ValueError, match="nerf_tcnn only"):
        tck.load_params_any(path, {"coarse": cp.init()})


# ----------------------------------------------------------------- slice


def _half_space_params(jf, seed):
    """`_params` with the four dense levels ×1e4 and zeroed at x > 0 (grid
    x index ≥ side/2), the twelve hashed levels zero, and the mirror head
    biased on (+1): rays living at x < 0 are mirrors, rays at x > 0 see
    nothing (σ exactly 0 there, or the last sample's δ = 1e10 would make
    any σ > 0 opaque)."""
    p = _params(jf, seed, scale_hashed=False)
    for lv in jf.grid_spec.levels():
        rows = p["grid"][lv.offset:lv.offset + lv.size]
        if lv.use_hash:
            rows[:] = 0.0
            continue
        side = lv.resolution + 1
        rows[:side ** 3].reshape(side, side, side, 2)[:, :, side // 2:] = 0.0
    p["is_mirror"][1]["b"][:] = 1.0
    return p


@pytest.fixture(scope="module")
def scene(fields):
    """64 rays through the seeded full-width field, half of them starting
    at x = −1 (mirrors), half at x = +1 (empty), their directions mostly
    along y and z (the CP slice's scene, tests/test_torch_port_slice.py)."""
    jf, tf = fields
    p = {"coarse": _half_space_params(jf, 0),
         "fine": _half_space_params(jf, 1)}
    rng = np.random.default_rng(0)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    o[:, 1:] = rng.normal(size=(n, 2)) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] *= 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), 1.5, np.float32)], axis=1)
    return jf, tf, p, rays


def test_render_rays_matches_jax(scene):
    jf, tf, p, rays = scene
    want = jax_render_rays(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                           JaxRS(**RS))
    got = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                      RenderSettings(**RS))
    assert float(got["opacity_fine"].mean()) > 0.3  # not vacuous
    for k in KEYS + ("x_surface_fine",):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_eval_trace_level2_matches_jax(scene):
    jf, tf, p, rays = scene
    want = jax_eval_trace(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                          JaxRS(**RS), JaxApp(), 2, True)
    got = eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                     RenderSettings(**RS), EvalAppFlags(), 2, True)
    m0 = got["mirror_mask_resolved"].numpy()
    assert 0.25 <= m0.mean() <= 0.75  # a mirror/non-mirror mix
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved",
              "rgb_fine_reflect", "depth_fine_reflect", "rgb_fine_direct"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TRACE_ATOL, rtol=0, err_msg=k)


def test_fused_field_flag_renders_plain(scene):
    """run.sh adds no --fused_field for this model; with it, CPU tensors
    take the fused NGP composite's plain version (ops/fused_hash.py: the
    field modules and the exclusive-prefix transmittance, where the
    unfused route takes the cumprod of 1 − α), which renders what the
    unfused route renders (the JAX renderer ignores the flag for NGPField):
    two formulations of one transmittance, fp32 order only."""
    from mirror_nerf_tpu_torch.ops import fused_hash

    _, tf, p, rays = scene
    pt = params_from_numpy(p)
    r = torch.from_numpy(rays[:16])
    before = fused_hash.launches
    on, off = (render_rays(tf, pt, r, RenderSettings(**RS, fused_field=f))
               for f in (True, False))
    assert fused_hash.launches == before
    for k in KEYS:
        torch.testing.assert_close(on[k], off[k], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """A generated 16×16 scene and seeded full-width weights
    (`_half_space_params`) as an npz and as a hash-grid Lightning .ckpt."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("ngp_cli")
    generate_scene(str(root / "scene"), n_train=2, n_val=1, n_test=2,
                   img_wh=(16, 16))
    jf = JaxNGP(bound=6.0)
    params = {"coarse": _half_space_params(jf, 3),
              "fine": _half_space_params(jf, 4)}
    tck.save_pytree(str(root / "w.npz"), params)
    tck.save_torch_ckpt(str(root / "w.ckpt"), params)
    return root


def test_eval_cli_with_jax_blocked(cli_scene):
    """The eval CLI (run.sh mode-1 flags for nerf_tcnn, --device cpu)
    renders the generated scene from an npz and from a Lightning .ckpt of
    the same weights, in a process where importing jax or mirror_nerf_tpu
    fails: the result trees appear and the PSNRs are equal."""
    code = textwrap.dedent("""
        import json, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mirror_nerf_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        from mirror_nerf_tpu_torch.eval import main
        flags = ["--dataset_name", "blender", "--root_dir", "scene",
                 "--near", "0.05", "--far", "8", "--img_wh", "16", "16",
                 "--model_type", "nerf_tcnn", "--predict_normal",
                 "--predict_mirror_mask", "--trace_secondary_rays",
                 "--bound", "6", "--N_samples", "8", "--N_importance", "8",
                 "--chunk", "128", "--max_recursive_level", "2",
                 "--split", "test", "--device", "cpu"]
        out = {}
        for tag in ("npz", "ckpt"):
            d = main(flags + ["--ckpt_path", "w." + tag, "--exp_name", tag])
            out[tag] = json.load(open(d + "/psnr.json"))["psnrs"]
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "mirror_nerf_tpu")]
        assert not bad, bad
        print("PSNRS", json.dumps(out))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(cli_scene), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("PSNRS")][-1]
    psnrs = json.loads(line[len("PSNRS "):])
    assert len(psnrs["npz"]) == 2 and np.isfinite(psnrs["npz"]).all()
    assert psnrs["npz"] == psnrs["ckpt"]
    for tag in ("npz", "ckpt"):
        files = set(os.listdir(cli_scene / "results" / "blender" / tag))
        for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                     f"{tag}_rgb_fine.gif", f"{tag}_mirror_mask_fine.gif"):
            assert name in files, (tag, name)


def train_cli_round_trip(model_flags, exp: str, eval_flags=()) -> None:
    """Two epochs (geometry, then reflection) through the train CLI on the
    CPU in the current directory's scene; the run's last.ckpt.npz
    round-trips bit for bit (port load → save, parameters, Adam moments,
    counters) and renders through the eval CLI. Shared with
    tests/test_torch_port_mlp_slice.py."""
    import json as _json

    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.train.checkpoints import (
        load_optimizer_state, load_train_ckpt, save_train_ckpt, tree_leaves)
    from mirror_nerf_tpu_torch.train.cli import main
    from mirror_nerf_tpu_torch.train.optim import Optimizer

    common = ["--dataset_name", "blender", "--root_dir", "scene", "--img_wh",
              "16", "16", "--near", "0.05", "--far", "8", "--bound", "6",
              "--predict_normal", "--predict_mirror_mask",
              "--trace_secondary_rays", "--N_samples", "4",
              "--N_importance", "4", "--chunk", "256", "--device", "cpu"]
    tr = main(common + model_flags + [
        "--batch_size", "256", "--num_epochs", "2", "--train_geometry_stage",
        "--train_geometry_stage_end_epoch", "1", "--decay_step", "2", "4",
        "8", "--exp_name", exp])
    recs = [_json.loads(x) for x in open(os.path.join(tr.workdir,
                                                      "metrics.jsonl"))]
    assert {r["stage"] for r in recs} == {"geometry", "full"}
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float))
    last = os.path.join(tr.workdir, "last.ckpt.npz")
    params, step, epoch = load_train_ckpt(last, tr.params)
    assert (step, epoch) == (tr.global_step, 2)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = Optimizer(tr.cfg, params, tr.steps_per_epoch)
    load_optimizer_state(last, opt)
    again = os.path.join(tr.workdir, "again.npz")
    save_train_ckpt(again, params, opt, step, epoch)
    a, b = np.load(last), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    out = eval_main(common + model_flags + list(eval_flags) + [
        "--split", "test", "--ckpt_path", last, "--exp_name", exp + "_eval"])
    with open(os.path.join(out, "psnr.json")) as f:
        assert np.isfinite(_json.load(f)["mean_psnr"])


def test_train_cli_refuses_the_hash_grid_model(cli_scene, monkeypatch):
    """(Named for the refusal it pinned until the hash grid trained.) The
    hash-grid model trains through the train CLI on the CPU (BWD and BWD2's
    plain versions), its checkpoint round-trips and renders."""
    monkeypatch.chdir(cli_scene)
    train_cli_round_trip(["--model_type", "nerf_tcnn"], "ngp_train")
