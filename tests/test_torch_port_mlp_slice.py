"""Port parity, the flagship PE-MLP novel-view slice as a whole:
`render_rays` with the fused field on and off and the level-2 Whitted
`eval_trace` against the JAX package (its fused T path in Pallas interpret
mode), at full width; the eval CLI with `--model_type nerf --fused_field`
from an npz and from a reference-layout Lightning checkpoint in a process
where jax is blocked; and the train CLI's refusal of the flagship."""

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
from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
from mirror_nerf_tpu.render.renderer import render_rays as jax_render_rays
from mirror_nerf_tpu_torch.eval.apps import EvalAppFlags, eval_trace
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
          test_time=True, compute_normal=False, fine_pass="fine")
KEYS = ("rgb_fine", "depth_fine", "opacity_fine", "mirror_mask_fine",
        "surface_normal_fine", "weights_coarse")
# fp32 against fp32, summation order only (the trunk is 8 layers deep)
ATOL = 1e-5
# the traced levels: a secondary ray starts at x_surface = o + d·depth and
# reflects about the composited normal, so the ~1e-7 rounding differences
# of depth and normal move its samples, and the top posenc band (2⁹)
# multiplies a position change by 512 before the trunk (measured 1.4e-5)
TRACE_ATOL = 5e-5


def _params(jf, seed):
    """JAX-initialized full-width params with σ ≥ 0 mostly (σ column made
    positive, ×5) and the trunk and mirror-head weights scaled by √6 (He's
    variance): at the plain init the 8 ReLU layers shrink the features to
    their biases, and every ray would see the same field."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * 5
    for layer in p["trunk"] + p["is_mirror"]:
        layer["w"] *= np.float32(np.sqrt(6.0))
    return p


@pytest.fixture(scope="module")
def scene():
    """16 rays through the seeded flagship, the mirror head's output bias
    shifted (bisection on the port's plain render) until about half of them
    resolve as mirrors at level 0."""
    jf, tf = JaxField(), TorchField()
    p = {"coarse": _params(jf, 0), "fine": _params(jf, 1)}
    rng = np.random.default_rng(0)
    n = 16
    o = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.05, np.float32),
                           np.full((n, 1), 4.0, np.float32)], axis=1)
    b0 = p["fine"]["is_mirror"][1]["b"].copy()
    lo, hi = -20.0, 20.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        p["fine"]["is_mirror"][1]["b"] = (b0 + mid).astype(np.float32)
        r = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                        RenderSettings(**RS, fused_field=True))
        frac = float((r["mirror_mask_fine"] > 0.5).float().mean())
        if abs(frac - 0.5) <= 0.2:
            break
        lo, hi = (lo, mid) if frac > 0.5 else (mid, hi)
    return jf, tf, p, rays


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_render_rays_matches_jax(scene, fused):
    jf, tf, p, rays = scene
    rs = {**RS, "fused_field": fused}
    want = jax_render_rays(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                           JaxRS(**rs))
    got = render_rays(tf, params_from_numpy(p), torch.from_numpy(rays),
                      RenderSettings(**rs))
    assert float(got["opacity_fine"].mean()) > 0.3  # not vacuous
    for k in KEYS + ("x_surface_fine",):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_eval_trace_level2_matches_jax(scene):
    jf, tf, p, rays = scene
    rs = {**RS, "fused_field": True}
    want = jax_eval_trace(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                          JaxRS(**rs), JaxApp(), 2, True)
    got = eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                     RenderSettings(**rs), EvalAppFlags(), 2, True)
    m0 = got["mirror_mask_resolved"].numpy()
    assert 0.25 <= m0.mean() <= 0.75  # a mirror/non-mirror mix
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved",
              "rgb_fine_reflect", "depth_fine_reflect", "rgb_fine_direct"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TRACE_ATOL, rtol=0, err_msg=k)


def test_noisy_fused_pass_raises(scene):
    """σ-noise on the fused branch takes the per-sample rows path (no
    longer a NotImplementedError): on the CPU it renders what the plain
    field modules render from the same generator seed, and on a device with
    neither a plain version nor a kernel it raises instead of rendering
    another way."""
    _, tf, p, rays = scene
    pt = params_from_numpy(p)
    got, want = (render_rays(tf, pt, torch.from_numpy(rays), RenderSettings(
        **{**RS, "fused_field": fused, "noise_std": 1.0}),
        torch.Generator().manual_seed(7)) for fused in (True, False))
    assert float(got["opacity_fine"].max()) > 0.1  # not vacuous
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)
    rs = RenderSettings(**{**RS, "fused_field": True, "noise_std": 1.0})
    with pytest.raises(ValueError, match="no fused PE-MLP rows path"):
        render_rays(tf, pt, torch.from_numpy(rays).to("meta"), rs)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """A generated 16×16 scene, and seeded flagship weights as an npz and
    as a reference-layout Lightning checkpoint."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.train.checkpoints import (save_pytree,
                                                         save_torch_ckpt)

    root = tmp_path_factory.mktemp("mlp_cli")
    generate_scene(str(root / "scene"), n_train=2, n_val=1, n_test=2,
                   img_wh=(16, 16))
    tf = TorchField()
    g = torch.Generator().manual_seed(3)
    params = {"coarse": tf.init(g), "fine": tf.init(g)}
    for side in params.values():
        side["sigma"]["w"][:, 0] = side["sigma"]["w"][:, 0].abs() * 5
    save_pytree(str(root / "w.npz"), params)
    save_torch_ckpt(str(root / "w.ckpt"), params)
    return root


def test_eval_cli_with_jax_blocked(cli_scene):
    """The flagship eval CLI (run.sh mode-1 flags for nerf, --fused_field,
    --device cpu) renders the generated scene from an npz and from a
    Lightning .ckpt of the same weights, in a process where importing jax
    or mirror_nerf_tpu fails: the result trees appear and the PSNRs are
    equal."""
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
                 "--model_type", "nerf", "--predict_normal",
                 "--predict_mirror_mask", "--trace_secondary_rays",
                 "--bound", "6", "--N_samples", "8", "--N_importance", "8",
                 "--chunk", "128", "--max_recursive_level", "2",
                 "--fused_field", "--split", "test", "--device", "cpu"]
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


def test_train_cli_refuses_the_flagship(cli_scene, monkeypatch):
    """(Named for the refusal it pinned until the flagship trained.) The
    flagship trains through the train CLI on the CPU, its checkpoint
    round-trips and renders (`--fused_field` in the eval CLI)."""
    from test_torch_port_ngp_slice import train_cli_round_trip

    monkeypatch.chdir(cli_scene)
    train_cli_round_trip(["--model_type", "nerf"], "mlp_train",
                         ["--fused_field"])
