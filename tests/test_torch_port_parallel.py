"""Port parity, data-parallel training (parallel/mesh.py, the Trainer's
`group`): two gloo ranks on the CPU against the JAX Trainer on its 8-device
mesh, and against the port's own one-rank step to fp32 order with every
term that couples the batch's rays on (the plane loss, the novel-ray prior,
`cp_tv`, a batch with invalid GT masks, a batch whose mirror pixels all
lie in one shard with a compaction that fits only globally), with and
without `--use_remat`; what a run refuses; rank 0 alone writing.

The ranks run in spawned processes (`run_ranks`) that import this module:
JAX is imported inside the tests only, and each rank runs torch on one
thread. Each test's rendezvous is a file under its own `tmp_path`."""

import contextlib
import os

import numpy as np
import pytest
import torch

LEVELS = "16:8,32:8"
# the one-rank self-comparison: 4 views of 16×16 (1024 rays, 578 mirror
# pixels), batch 512, compaction at 0.5 (global capacity 256; a rank
# compacting alone would get 128 slots for 256 rows)
SELF = dict(img_wh=(16, 16), near=0.05, far=12.0, bound=6.0,
            model_type="nerf_tpu", grid_levels=LEVELS, N_samples=6,
            N_importance=6, batch_size=512, num_epochs=2,
            predict_normal=True, predict_mirror_mask=True,
            trace_secondary_rays=True, only_trace_rays_in_mirrors=True,
            compact_frac=0.5, smooth_mirror_start_epoch=0,
            train_mirror_mask_start_epoch=0, train_normal_start_epoch=0,
            use_plane_consistent_loss=True, novel_ray_batch=32,
            novel_ray_start_epoch=0, cp_tv_loss_weight=0.1, chunk=256,
            perturb=0.0, noise_std=0.0, fused_train="off",
            train_geometry_stage=True, train_geometry_stage_end_epoch=1)
N_MIRROR_SHARD0 = 200
# a rank that fails leaves the other waiting on a collective this long
RANK_TIMEOUT_S = 120


@contextlib.contextmanager
def one_thread():
    """test_torch_port_apps.one_thread, kept here: the spawned ranks import
    this module, which must not import JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def train_rank(group, root, work, kw, plan, params=None):
    """Train steps on one rank (`group` None: one device). `plan`: (epoch,
    geometry stage, rays, rgbs, masks) a step, each batch the global one.
    Returns the losses, the parameters, the largest parameter difference
    between the ranks, the compaction's dropped rays, and (rank 0) the
    files each rank's workdir holds after `save` and `_log`."""
    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.train.checkpoints import tree_leaves
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    rank, world = (0, 1) if group is None else (group.rank, group.world)
    cfg = Config(root_dir=root, **kw)
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    tr = Trainer(cfg, ds, os.path.join(work, f"rank{rank}"), device="cpu",
                 params=params, group=group)
    losses, dropped = [], []
    for epoch, geometry, rays, rgbs, masks in plan:
        aux = tr.train_step(EpochStatics.of(tr.cfg, epoch, geometry), {
            "rays": torch.from_numpy(rays), "rgbs": torch.from_numpy(rgbs),
            "mirror_mask": torch.from_numpy(masks)})
        losses.append(float(aux["loss"]))
        dropped.append(float(aux.get("compact_dropped", 0.0)))
    tr.save(0)
    tr._log({"step": tr.global_step})
    leaves = [x.detach().numpy().copy() for x in tree_leaves(tr.params)]
    spread, files = 0.0, None
    if group is not None:
        flat = torch.cat([x.detach().reshape(-1)
                          for x in tree_leaves(tr.params)])
        every = group.all_gather(flat[None])
        spread = float((every - every[:1]).abs().max())
        group.all_ints(0)  # every rank has written what it writes
    if rank == 0:
        files = [sorted(os.listdir(os.path.join(work, f"rank{r}")))
                 for r in range(world)]
    return losses, leaves, spread, dropped, files


def _run_ranks(fn, tmp_path, *args):
    from mirror_nerf_tpu_torch.parallel.mesh import run_ranks

    with one_thread():
        return run_ranks(fn, 2, "cpu", args, init_method="file://" + str(
            tmp_path / "rendezvous"), timeout_s=RANK_TIMEOUT_S)


def _scene(tmp_path, n_train):
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path / "scene")
    generate_scene(root, n_train=n_train, n_val=1, n_test=1,
                   img_wh=(16, 16))
    return root


# ---- against the JAX Trainer on its 8-device mesh ----


def test_two_ranks_match_jax_mesh_trajectory(tmp_path):
    """test_torch_port_train's trajectory (three reflection-stage steps,
    one geometry-stage step, batch 96) on two ranks, at that test's bars."""
    import jax
    import jax.numpy as jnp

    from mirror_nerf_tpu.config import Config as JaxConfig
    from mirror_nerf_tpu.data.blender import BlenderDataset as JaxDS
    from mirror_nerf_tpu.parallel.mesh import get_mesh
    from mirror_nerf_tpu.train.loop import EpochStatics as JaxStatics
    from mirror_nerf_tpu.train.loop import Trainer as JaxTrainer
    from test_torch_port_train import TRAJ

    root = _scene(tmp_path, 2)
    jcfg = JaxConfig(root_dir=root, **TRAJ)
    jds = JaxDS(root, "train", jcfg.img_wh, jcfg)
    jt = JaxTrainer(jcfg, jds, str(tmp_path / "jax"), mesh=get_mesh())
    assert jt.n_dev == 8
    p0 = jax.tree_util.tree_map(np.array, jt.params)
    jds.train_geometry_stage = False
    rays, rgbs, masks = jds.train_buffers()
    b = TRAJ["batch_size"]
    steps = [(1, False)] * 3 + [(0, True)]
    plan, params, opt = [], jt.params, jt.opt_state
    for i, (epoch, geometry) in enumerate(steps):
        sl = slice(i * b, (i + 1) * b)
        plan.append((epoch, geometry, rays[sl], rgbs[sl], masks[sl]))
        params, opt, aux = jt.get_step_fn(JaxStatics.of(
            jcfg, epoch, geometry))(params, opt, {
                "rays": jnp.asarray(rays[sl]), "rgbs": jnp.asarray(rgbs[sl]),
                "mirror_mask": jnp.asarray(masks[sl])},
            jax.random.PRNGKey(i))
        plan[-1] += (float(aux["loss"]),)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.array, params))]
    # the port's tree order (dict keys sorted) is jax's
    losses, got, spread, _, _ = _run_ranks(
        train_rank, tmp_path, root, str(tmp_path / "port"), TRAJ,
        [s[:5] for s in plan], p0)
    for i, s in enumerate(plan):
        np.testing.assert_allclose(losses[i], s[5], rtol=2e-4,
                                   err_msg=f"step {i}")
    for a, g in zip(want, got):
        np.testing.assert_allclose(g, a, atol=5e-5, rtol=5e-4)
    assert spread == 0.0  # every rank holds the same parameters


# ---- against the port's own one-rank step ----


def _self_plan(root):
    """Three 512-ray steps: the mirror pixels of the first all in shard 0
    (200 of its 256 rows: the global capacity holds them, a rank's own
    would not), the second with 64 invalid GT masks in shard 1 only, the
    third a geometry-stage step on a shuffled batch."""
    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset

    cfg = Config(root_dir=root, **SELF)
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    ds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    rng = np.random.default_rng(3)
    mirror = rng.permutation(np.flatnonzero(masks > 0.5))
    other = rng.permutation(np.flatnonzero(masks <= 0.5))
    first = np.concatenate([mirror[:N_MIRROR_SHARD0], other[:312]])
    second = rng.permutation(len(rays))[:512]
    third = rng.permutation(len(rays))[:512]
    m2 = masks[second].copy()
    m2[-64:] = -1.0
    return [(1, False, rays[first], rgbs[first], masks[first]),
            (1, False, rays[second], rgbs[second], m2),
            (0, True, rays[third], rgbs[third], masks[third])]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_rank")
    root = _scene(tmp, 4)
    plan = _self_plan(root)
    with one_thread():
        return root, plan, train_rank(None, root, str(tmp / "work"), SELF,
                                      plan)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_two_ranks_match_one_rank(one_rank, tmp_path, remat):
    root, plan, (want_loss, want, _, want_drop, _) = one_rank
    assert want_drop[0] == 0.0  # the global capacity holds shard 0's 200
    losses, got, spread, dropped, files = _run_ranks(
        train_rank, tmp_path, root, str(tmp_path / "work"),
        dict(SELF, use_remat=remat), plan)
    np.testing.assert_allclose(losses, want_loss, rtol=1e-5)
    assert dropped == want_drop
    for a, g in zip(want, got):
        scale = float(np.abs(a).max()) + 1e-8
        assert float(np.abs(g - a).max()) / scale < 1e-5
    assert spread == 0.0
    # rank 0 alone writes its checkpoints and metrics
    assert {"last.ckpt.npz", "epoch=0.ckpt.npz", "metrics.jsonl"} <= set(
        files[0])
    assert files[1] == []


def test_launch_joins_a_launcher_group(monkeypatch):
    """Under torchrun's environment a CLI's entry joins the group it
    describes (WORLD_SIZE 1 here, gloo on the CPU) instead of spawning."""
    import socket

    from mirror_nerf_tpu_torch.parallel.mesh import launch

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    for k, v in {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    got = launch(lambda g, x: (g.rank, g.world, g.backend, x), 1, "cpu",
                 ("ran",))
    assert got == (0, 1, "gloo", "ran")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="under a launcher of 1"):
        launch(lambda g: None, 2, "cpu")


# ---- refusals ----


@pytest.mark.parametrize("case", ["trainer_batch", "cli_batch", "cards"])
def test_data_parallel_refusals(case, tmp_path, monkeypatch):
    """A batch that does not split over the ranks raises, in the Trainer
    and in the CLI before any rank starts; so do more NCCL ranks than
    cards."""
    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.parallel.mesh import DataGroup
    from mirror_nerf_tpu_torch.train import cli
    from mirror_nerf_tpu_torch.train.loop import Trainer

    class _Rays:
        all_rays = [0] * 8

    monkeypatch.chdir(tmp_path)
    if case == "trainer_batch":
        group = DataGroup(rank=0, world=3, device=torch.device("cpu"),
                          backend="gloo")
        with pytest.raises(ValueError, match="not divisible by 3"):
            Trainer(Config(batch_size=8), _Rays(), "unused", "cpu",
                    group=group)
    elif case == "cli_batch":
        with pytest.raises(ValueError, match="batch_size 96 not divisible"):
            cli.main(["--num_gpus", "5", "--batch_size", "96", "--device",
                      "cpu"])
    else:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 cards"):
            cli.main(["--num_gpus", "2", "--device", "cuda"])
    assert not os.listdir(tmp_path)
