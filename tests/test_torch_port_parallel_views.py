"""Port parity, data-parallel views and CLIs (parallel/mesh.py): a view
whose mirror lies in the first rank's rows, rendered by two gloo ranks on
the CPU through `eval_trace` (compaction from level 0 at a capacity that
holds the mirror rays only globally), `run_view` and
`render_image_chunked`, against one rank and against the JAX package's
`run_view` on a 2-device mesh; and the train and eval CLIs with `--device
cpu --num_gpus 2` end to end.

As in test_torch_port_parallel.py, the ranks run in spawned processes that
import this module (JAX only inside the tests), on one thread each."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_parallel import RANK_TIMEOUT_S, one_thread

LEVELS = "16:8,32:8"
# 512 rays: rows 0–39 and 300–449 start at x = −1 (inside the scene's
# mirror half-space), the rest at x = +1 (empty); two ranks of 256 rows, so
# most mirror rays are rank 1's. Compaction at 0.5: 256 slots for the
# chunk's level 0, 128 for a rank compacting its rows alone; at level 1
# rank 0's empty slots precede rank 1's rays in the chunk's order
N_RAYS, FRAC = 512, 0.5
MIRROR_ROWS = np.r_[0:40, 300:450]
FLAGS = ["--model_type", "nerf_tpu", "--grid_levels", LEVELS, "--bound", "2",
         "--predict_normal", "--predict_mirror_mask", "--trace_secondary_rays",
         "--max_recursive_level", "2", "--N_samples", "8", "--N_importance",
         "8", "--chunk", str(N_RAYS), "--near", "0.1", "--far", "1.5"]
RS = dict(N_samples=8, N_importance=8, perturb=0.0, noise_std=0.0,
          test_time=True, compute_normal=False, fine_pass="fine")
KEYS = ("rgb_fine", "depth_fine", "mirror_mask_resolved", "rgb_fine_reflect",
        "depth_fine_reflect", "compact_dropped")
# the same rays, one process or two: per-ray arithmetic in another batch
ATOL = 1e-6


def view_rank(group, params, rays):
    """The view on one rank (`group` None: one device): `eval_trace` on the
    rank's rows with the chunk's compaction, `run_view` and
    `render_image_chunked`; whole-view numpy out."""
    from mirror_nerf_tpu_torch.eval.apps import (AppContext, EvalAppFlags,
                                                 eval_trace, run_view)
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field
    from mirror_nerf_tpu_torch.render.renderer import RenderSettings
    from mirror_nerf_tpu_torch.render.tracer import TraceSettings
    from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy
    from mirror_nerf_tpu_torch.train.loop import render_image_chunked

    cfg, args = get_opt(FLAGS)
    field = make_field(cfg)
    p = params_from_numpy(params)
    r = torch.from_numpy(rays)
    rows = r if group is None else group.shard_rows(r)
    res = eval_trace(field, p, rows, RenderSettings(**RS), EvalAppFlags(), 2,
                     True, compact_frac=FRAC, compact_from_level=0,
                     group=group)
    out = {"trace": {k: (res[k] if group is None
                         else group.all_gather(res[k])).numpy()
                     for k in KEYS}}
    ctx = AppContext.build(cfg, args, field, p, "cpu", group)
    out["view"] = run_view(ctx, {"rays": rays})
    ts = TraceSettings(render=RenderSettings(**RS), max_recursive_level=2,
                       only_trace_rays_in_mirrors=True, is_eval=True,
                       compact_frac=FRAC)
    out["chunked"] = render_image_chunked(
        field, p, rays, None, ts, N_RAYS, "cpu",
        keys=("rgb_fine", "depth_fine", "mirror_mask_resolved",
              "compact_dropped"), group=group)
    return out


def _half_space(jf, seed):
    """test_torch_port_slice's scene: σ ≥ 0 but for an empty x > 0.5 (the
    axis-0 tables zeroed there), the mirror head biased on. The origin is
    inside, so a compaction buffer's empty rows (zero rays) render as
    mirrors: they must not take a slot from another rank's rays deeper."""
    import jax

    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
    for t in p["grid"]["axes"][0]:
        t[t.shape[0] * 5 // 8:] = 0.0
    p["is_mirror"][1]["b"][:] = 1.0
    return p


@pytest.fixture(scope="module")
def view():
    """The half-space scene at the CLI flags' field and the 512 rays."""
    from mirror_nerf_tpu.config import add_common_args, config_from_namespace
    from mirror_nerf_tpu.models.fields import make_field as jax_field

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    jcfg = config_from_namespace(parser.parse_args(FLAGS))
    jf = jax_field(jcfg)
    params = {"coarse": _half_space(jf, 0), "fine": _half_space(jf, 1)}
    rng = np.random.default_rng(0)
    o = np.zeros((N_RAYS, 3), np.float32)
    o[:, 0] = 1.0
    o[MIRROR_ROWS, 0] = -1.0
    o[:, 1:] = rng.normal(size=(N_RAYS, 2)) * 0.2
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[:, 0] *= 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((N_RAYS, 1), 0.1, np.float32),
                           np.full((N_RAYS, 1), 1.5, np.float32)], 1)
    with one_thread():
        one = view_rank(None, params, rays)
    return jcfg, jf, params, rays, one


def _close(got, want, keys, atol, what):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


def test_two_rank_views_match_one_rank_and_jax(view, tmp_path):
    import jax

    from mirror_nerf_tpu.eval import apps as japps
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.parallel.mesh import run_ranks

    jcfg, jf, params, rays, one = view
    m0 = one["trace"]["mirror_mask_resolved"]
    # rank 1 holds more mirror rays than a rank's own 128 slots, and the
    # chunk's 256 hold all of them
    assert 128 < m0[N_RAYS // 2:].sum() and m0.sum() <= 256
    assert m0[:N_RAYS // 2].sum() > 0
    with one_thread():
        two = run_ranks(view_rank, 2, "cpu", (params, rays),
                        init_method="file://" + str(tmp_path / "rdv"),
                        timeout_s=RANK_TIMEOUT_S)
    _close(two["trace"], one["trace"], KEYS, ATOL, "eval_trace")
    _close(two["view"], one["view"], one["view"].keys(), ATOL, "run_view")
    assert set(two["view"]) == set(one["view"])
    _close(two["chunked"], one["chunked"], one["chunked"].keys(), ATOL,
           "render_image_chunked")
    # level 1's 128 slots overflow: the two ranks drop the same rays
    assert one["chunked"]["compact_dropped"].sum() > 0

    # the JAX package's run_view on a 2-device data mesh
    _, args = get_opt(FLAGS)
    ctx = japps.AppContext.build(jcfg.replace(num_gpus=2), args, jf, params)
    assert ctx.mesh.devices.size == 2
    want = japps.run_view(ctx, {"rays": rays}, 0.0, jax.random.PRNGKey(0))
    _close(two["view"], want, ("rgb_fine", "depth_fine",
                               "mirror_mask_resolved", "rgb_fine_reflect",
                               "depth_fine_reflect"), 1e-5, "jax run_view")


# ---- the CLIs on two CPU ranks ----


def test_clis_on_two_cpu_ranks(tmp_path, monkeypatch):
    """Two epochs of the train CLI with --num_gpus 2 --device cpu, then the
    eval CLI on its checkpoint the same way: rank 0's result trees."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.train import cli

    monkeypatch.chdir(tmp_path)
    generate_scene("scene", n_train=2, n_val=1, n_test=2, img_wh=(12, 12))
    common = ["--dataset_name", "blender", "--root_dir", "scene", "--img_wh",
              "12", "12", "--near", "0.05", "--far", "12", "--model_type",
              "nerf_tpu", "--predict_normal", "--predict_mirror_mask",
              "--trace_secondary_rays", "--bound", "6", "--grid_levels",
              LEVELS, "--N_samples", "6", "--N_importance", "6", "--chunk",
              "64", "--device", "cpu", "--num_gpus", "2"]
    with one_thread():
        tr = cli.main(common + [
            "--batch_size", "96", "--num_epochs", "2",
            "--train_geometry_stage", "--train_geometry_stage_end_epoch",
            "1", "--only_trace_rays_in_mirrors", "--novel_ray_batch", "16",
            "--novel_ray_start_epoch", "1", "--exp_name", "dp"])
        assert tr.group is not None and tr.group.world == 2
        files = set(os.listdir(tr.workdir))
        for name in ("config.json", "metrics.jsonl", "val_metrics.jsonl",
                     "val_epoch0.png", "val_epoch1.png", "last.ckpt.npz",
                     "epoch=1.ckpt.npz"):
            assert name in files, name
        assert os.listdir("logs") == [os.path.basename(tr.workdir)]
        rows = [json.loads(x) for x in open(os.path.join(
            tr.workdir, "val_metrics.jsonl"))]
        assert [r["epoch"] for r in rows] == [0, 1]
        assert np.isfinite([r["val_psnr"] for r in rows]).all()
        out = eval_main(common + [
            "--max_recursive_level", "2", "--split", "test", "--ckpt_path",
            os.path.join(tr.workdir, "last.ckpt.npz"), "--exp_name", "dp"])
    table = json.load(open(os.path.join(out, "psnr.json")))
    assert len(table["psnrs"]) == 2 and np.isfinite(table["psnrs"]).all()
    for name in ("rgb_fine_000.png", "rgb_fine_001.png", "dp_rgb_fine.gif"):
        assert name in os.listdir(out), name
