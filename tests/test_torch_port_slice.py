"""Port parity, the novel-view slice as a whole: the level-2 Whitted eval
trace with fixed-capacity compaction against the JAX package (fused path,
Pallas interpret mode), once at a capacity that fits and once at one that
overflows; the eval CLI's result tree; and the port running with jax and
`mirror_nerf_tpu` blocked from import."""

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
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu_torch.eval.apps import EvalAppFlags, eval_trace
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = ((16, 8), (32, 8))
RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
          test_time=True, compute_normal=False, fine_pass="fine",
          fused_field=True)


def _params(jf, seed):
    """JAX-initialized params for a scene with a mirror/non-mirror split:
    σ ≥ 0 everywhere except an empty half-space x > 0 (axis-0 tables zeroed
    there), and the mirror head biased on, so rays living at x < 0 are
    mirrors and rays at x > 0 see nothing."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
    for t in p["grid"]["axes"][0]:
        t[t.shape[0] // 2:] = 0.0
    p["is_mirror"][1]["b"][:] = 1.0
    return p


@pytest.fixture(scope="module")
def scene():
    jf = JaxField(bound=2.0, grid_levels=LEVELS)
    tf = TorchField(bound=2.0, grid_levels=LEVELS)
    p = {"coarse": _params(jf, 0), "fine": _params(jf, 1)}
    rng = np.random.default_rng(0)
    n = 512
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    o[:, 1:] = rng.normal(size=(n, 2)) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] *= 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), 1.5, np.float32)], axis=1)
    return jf, tf, p, rays


# 512 rays: capacity 384 holds the ~260 level-1 mirror rays, capacity 128
# (the floor of the 128-rounding) overflows
@pytest.mark.parametrize("compact_frac,overflows", [(0.75, False),
                                                    (0.25, True)],
                         ids=["fits", "overflows"])
def test_eval_trace_level2_matches_jax(scene, compact_frac, overflows):
    jf, tf, p, rays = scene
    want = jax_eval_trace(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                          JaxRS(**RS), JaxApp(), 2, True,
                          compact_frac=compact_frac)
    got = eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                     RenderSettings(**RS), EvalAppFlags(), 2, True,
                     compact_frac=compact_frac)
    m0 = got["mirror_mask_resolved"].numpy()
    assert 0.2 < m0.mean() < 0.8  # a real mirror/non-mirror mix
    dropped = got["compact_dropped"].numpy()
    assert (dropped.sum() > 0) == overflows
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved",
              "compact_dropped", "rgb_fine_reflect", "depth_fine_reflect"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_fused_and_unfused_render_agree(scene):
    """render_rays through the fused path (the kernel's plain version on the
    CPU) vs the unfused field modules + cumprod compositing."""
    _, tf, p, rays = scene
    pt = params_from_numpy(p)
    r = torch.from_numpy(rays[:64])
    fused = render_rays(tf, pt, r, RenderSettings(**RS))
    plain = render_rays(tf, pt, r, RenderSettings(**{**RS,
                                                     "fused_field": False}))
    for k in ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
              "surface_normal_fine", "weights_coarse"):
        np.testing.assert_allclose(fused[k].numpy(), plain[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_proposal_skip_matches_jax(scene):
    jf, tf, p, rays = scene
    rs = {**RS, "proposal_skip": True}
    want = jax_eval_trace(jf, p, jnp.asarray(rays[:128]),
                          jax.random.PRNGKey(0), JaxRS(**rs), JaxApp(), 1,
                          True)
    got = eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays[:128]),
                     RenderSettings(**rs), EvalAppFlags(), 1, True)
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_eval_cli_writes_result_tree(tmp_path, monkeypatch):
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import main

    monkeypatch.chdir(tmp_path)
    generate_scene("scene", n_train=1, n_val=1, n_test=2, img_wh=(12, 12))
    out = main(["--dataset_name", "blender", "--root_dir", "scene",
                "--img_wh", "12", "12", "--model_type", "nerf_tpu",
                "--predict_normal", "--predict_mirror_mask",
                "--trace_secondary_rays", "--bound", "6",
                "--grid_levels", "16:8,32:8", "--N_samples", "8",
                "--N_importance", "8", "--chunk", "64", "--fused_field",
                "--max_recursive_level", "2", "--split", "test",
                "--exp_name", "port", "--device", "cpu"])
    assert out == "results/blender/port"
    files = set(os.listdir(out))
    for name in ("rgb_fine_000.png", "rgb_fine_001.png", "psnr.json",
                 "port_rgb_fine.gif", "port_mirror_mask_fine.gif"):
        assert name in files, name
    for sub in ("depth", "mirror_mask", "normal", "depth_reflect"):
        assert len(os.listdir(os.path.join(out, sub))) == 2, sub
    table = json.load(open(os.path.join(out, "psnr.json")))
    assert len(table["psnrs"]) == 2 and np.isfinite(table["mean_psnr"])


def test_unported_paths_raise(tmp_path):
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.parallel.mesh import DataGroup

    # (named for the refusals it pinned until the applications were
    # ported) an application without its checkpoint exits as JAX's does
    cfg, args = get_opt(["--model_type", "nerf_tpu", "--predict_normal",
                         "--app_reflection_substitution"])
    with pytest.raises(SystemExit, match="substitution_ckpt_path required"):
        AppContext.build(cfg, args, make_field(cfg), {}, "cpu")
    # multi-GPU eval (ROADMAP queue 1, item 9) is ported: the context
    # builds, and renders with the ranks' group it is given
    cfg, args = get_opt(["--model_type", "nerf_tpu", "--predict_normal",
                         "--num_gpus", "2"])
    group = DataGroup(rank=0, world=2, device=torch.device("cpu"),
                      backend="gloo")
    assert AppContext.build(cfg, args, make_field(cfg), {}, "cpu",
                            group).group is group
    # --use_remat (item 8) is ported: the Trainer builds
    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.train.loop import Trainer

    class _Rays:
        all_rays = [0] * 8

    tr = Trainer(Config(use_remat=True, grid_levels="16:8,32:8"), _Rays(),
                 str(tmp_path), "cpu")
    assert tr.cfg.use_remat and tr.group is None
    # every dataset of the JAX package loads (queue 1, item 5's loaders
    # are ported); another name raises and names only the loaders
    from mirror_nerf_tpu_torch.data import get_dataset

    with pytest.raises(NotImplementedError) as err:
        get_dataset("colmap_dense")
    assert str(err.value) == (
        "unknown dataset 'colmap_dense': the port loads ['blender', 'llff', "
        "'real_arkit', 'real_colmap'], the loaders of the JAX package")


def test_port_runs_with_jax_blocked():
    """Every module of the port imports, and a level-2 trace renders, in a
    process where importing jax or mirror_nerf_tpu fails."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mirror_nerf_tpu"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import torch
        import mirror_nerf_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        from mirror_nerf_tpu_torch.eval.apps import EvalAppFlags, eval_trace
        from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
        from mirror_nerf_tpu_torch.render.renderer import RenderSettings
        f = TPUGridField(bound=2.0, grid_levels=((16, 8), (32, 8)))
        g = torch.Generator().manual_seed(0)
        p = {"coarse": f.init(g), "fine": f.init(g)}
        rays = torch.cat([torch.zeros(8, 3), torch.nn.functional.normalize(
            torch.randn(8, 3, generator=g), dim=-1), torch.full((8, 1), 0.1),
            torch.full((8, 1), 2.0)], 1)
        rs = RenderSettings(N_samples=8, N_importance=8, perturb=0.0,
                            noise_std=0.0, test_time=True,
                            compute_normal=False, fused_field=True)
        r = eval_trace(f, p, rays, rs, EvalAppFlags(), 2, True)
        assert torch.isfinite(r["rgb_fine"]).all()
        # the σ-noise fused render of both models through level 2, the
        # per-sample composite and the flagship's point queries
        from dataclasses import replace
        from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
        from mirror_nerf_tpu_torch.ops.fused_cp import \\
            fused_cp_forward_composite
        from mirror_nerf_tpu_torch.ops.fused_mlp import fused_field_eval
        from mirror_nerf_tpu_torch.render.tracer import (TraceSettings,
                                                         trace_rays)
        noisy = replace(rs, noise_std=1.0)
        mf = MirrorNeRFField()
        mp = {"coarse": mf.init(g), "fine": mf.init(g)}
        for field, params in ((f, p), (mf, mp)):
            t = trace_rays(field, params, rays[:4], torch.full((4,), -1.0),
                           TraceSettings(render=noisy,
                                         max_recursive_level=2), g)
            assert torch.isfinite(t["rgb_fine"]).all()
        x = rays[:4, None, :3] + rays[:4, None, 3:6] * torch.linspace(
            0.1, 1.0, 8)[:, None]
        c = fused_cp_forward_composite(
            f, p["fine"], x, rays[:4, None, 3:6].expand_as(x),
            torch.linspace(0.1, 1.0, 8).expand(4, 8), torch.full((4, 8), 0.1))
        assert torch.isfinite(c["rgb"]).all()
        sigma, rgb, normal, mirror = fused_field_eval(
            mf, mp["fine"], rays[:, :3], rays[:, 3:6])
        assert torch.isfinite(rgb).all() and normal.shape == (8, 3)
        # the hash-grid model through level 2 (plain encoder on the CPU)
        from mirror_nerf_tpu_torch.models.ngp import NGPField
        nf = NGPField(bound=2.0, n_levels=4, log2_hashmap_size=12)
        np_ = {"coarse": nf.init(g), "fine": nf.init(g)}
        r = eval_trace(nf, np_, rays, replace(rs, fused_field=False),
                       EvalAppFlags(), 2, True)
        assert torch.isfinite(r["rgb_fine"]).all()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "mirror_nerf_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
