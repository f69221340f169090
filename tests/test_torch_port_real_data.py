"""Port parity, the real-capture loaders (`real_arkit`, `real_colmap` and
its alias `llff`), `core/pose.py` and the COLMAP binary I/O, each against
the JAX package on the same PIL-written fixtures: rays, rgbs, mirror masks,
poses, focal, near and far bit for bit (both sides are the same numpy);
the Trainer's buffers on a capture, and the train and eval CLIs on a
generated ARKit and COLMAP capture."""

import json
import os

import numpy as np
import pytest

from mirror_nerf_tpu.config import Config as JaxConfig
from mirror_nerf_tpu.core import pose as jpose
from mirror_nerf_tpu.data import colmap_utils as jcolmap
from mirror_nerf_tpu.data.real_arkit import RealDatasetARKit as JaxARKit
from mirror_nerf_tpu.data.real_colmap import RealDatasetColmap as JaxColmap
from mirror_nerf_tpu_torch.config import Config
from mirror_nerf_tpu_torch.core import pose
from mirror_nerf_tpu_torch.data import colmap_utils, get_dataset
from mirror_nerf_tpu_torch.data.real_arkit import RealDatasetARKit
from mirror_nerf_tpu_torch.data.real_colmap import RealDatasetColmap
from mirror_nerf_tpu_torch.data.synthetic import camera_ring
from test_torch_port_apps import one_thread

WH = (16, 12)
ATTRS = ("focal", "near", "far", "poses", "poses_all", "pose_avg", "bounds",
         "poses_test", "all_rays", "all_rgbs", "all_mirror_masks",
         "rays_wmask", "rgbs_wmask", "mirror_masks_wmask", "directions",
         "wo_full_gt_mirror_masks", "image_paths", "spheric_poses")


def _write_imgs(root, names, subdir="", alpha=False, masks=True):
    """Random RGB(A) PNGs and binary masks, written with PIL."""
    from PIL import Image

    w, h = WH
    os.makedirs(os.path.join(root, subdir), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    rng = np.random.default_rng(0)
    for i, n in enumerate(names):
        img = (rng.uniform(size=(h, w, 4 if alpha else 3)) * 255).astype(
            np.uint8)
        Image.fromarray(img).save(os.path.join(root, subdir, n))
        if masks and i > 0:  # the first frame has no mask
            mask = (rng.uniform(size=(h, w)) > 0.8).astype(np.uint8) * 255
            Image.fromarray(mask).save(os.path.join(root, "masks", n))


def _arkit(root, intrinsics: bool):
    """Five frames (the last one's image missing), camera_angle_x or
    per-frame intrinsics, RGBA images, split files without a
    transforms_test_*.json (the loader falls back to transforms_test)."""
    names = [f"f_{i}.png" for i in range(5)]
    _write_imgs(root, names[:4], "images", alpha=True)
    frames = []
    for i, p in enumerate(camera_ring(5)):
        m = np.eye(4)
        m[:3] = p
        fr = {"file_path": f"images/{names[i]}",
              "transform_matrix": m.tolist()}
        if intrinsics:
            fr["intrinsics"] = [[30.0, 0, 9.0], [0, 30.0, 6.5], [0, 0, 1]]
        frames.append(fr)
    meta = {"frames": frames}
    if not intrinsics:
        meta["camera_angle_x"] = 0.9
    splits = {"": frames, "_train": frames, "_val": frames[1:3],
              "_test": frames[2:4]}
    for split, fr in splits.items():
        with open(os.path.join(root, f"transforms{split}.json"), "w") as f:
            json.dump(dict(meta, frames=fr), f)
    return root


def _colmap(root):
    """Five images of a SIMPLE_RADIAL camera at 4× the size, w2c random
    small rotations; mask-less first image."""
    os.makedirs(os.path.join(root, "sparse"), exist_ok=True)
    names = [f"im_{i}.png" for i in (3, 0, 4, 1, 2)]  # unsorted ids
    _write_imgs(root, names, "images")
    cameras = {1: colmap_utils.Camera(1, "SIMPLE_RADIAL", 64, 48,
                                      np.array([50.0, 32.0, 24.0, 0.0]))}
    colmap_utils.write_cameras_binary(cameras,
                                      os.path.join(root, "sparse/cameras.bin"))
    rng = np.random.default_rng(1)
    images = {}
    for i, n in enumerate(names):
        a = 0.1 * i
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1.0]])
        t = rng.normal(size=3) * 0.1 + [0, 0, 2.0]
        xys = rng.normal(size=(2, 2))
        images[i + 1] = colmap_utils.Image(
            i + 1, colmap_utils.rotmat2qvec(R), t, 1, n, xys,
            np.array([7, -1], np.int64))
    colmap_utils.write_images_binary(images,
                                     os.path.join(root, "sparse/images.bin"))
    return root


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    base = tmp_path_factory.mktemp("captures")
    return {"arkit": _arkit(str(base / "arkit"), False),
            "arkit_fx": _arkit(str(base / "arkit_fx"), True),
            "colmap": _colmap(str(base / "colmap"))}


def _cfgs(**kw):
    base = dict(img_wh=WH, near=0.5, far=8.0, scale_factor=2.0,
                train_skip_step=1, val_idx=0, train_geometry_stage=True)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _same(a, b, what):
    """Every attribute and every sample key bit for bit."""
    for k in ATTRS:
        assert hasattr(a, k) == hasattr(b, k), (what, k)
        if hasattr(a, k):
            x, y = getattr(a, k), getattr(b, k)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)
            else:
                assert x == y, (what, k)
    assert len(a) == len(b), what
    for i in sorted({0, len(a) // 2, len(a) - 1}):
        if a.split == "train":
            break
        sa, sb = a.get_image(i), b.get_image(i)
        assert (sa is None) == (sb is None), (what, i)
        for k in (sa or {}):
            x, y = np.asarray(sa[k]), np.asarray(sb[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, i, k)


@pytest.mark.parametrize("split", ["train", "val", "test", "test_rotate",
                                   "test_interpolation", "test_train"])
@pytest.mark.parametrize("layout", ["arkit", "arkit_fx"])
def test_arkit_matches_jax(captures, layout, split):
    jcfg, cfg = _cfgs(root_dir=captures[layout])
    want = JaxARKit(captures[layout], split, WH, jcfg)
    got = RealDatasetARKit(captures[layout], split, WH, cfg)
    _same(want, got, (layout, split))
    if split == "train":
        # the missing image is skipped, the mask-less frame leaves the
        # geometry-stage buffers
        assert len(got.poses) == 4 and got.wo_full_gt_mirror_masks
        assert len(got.rays_wmask) == 3 * WH[0] * WH[1]
        assert (got.all_rays[:, 6:8] == [0.25, 4.0]).all()


@pytest.mark.parametrize("split,spheric", [
    ("train", True), ("val", True), ("test", True), ("test_train", True),
    ("train", False), ("test", False)])
@pytest.mark.parametrize("skip", [1, 2])
def test_colmap_matches_jax(captures, split, spheric, skip):
    """Spheric captures, and the NDC branch with the spiral test path."""
    jcfg, cfg = _cfgs(root_dir=captures["colmap"], train_skip_step=skip)
    want = JaxColmap(captures["colmap"], split, WH, jcfg,
                     spheric_poses=spheric)
    got = RealDatasetColmap(captures["colmap"], split, WH, cfg,
                            spheric_poses=spheric)
    _same(want, got, (split, spheric))
    if split == "test":
        assert len(got) == 120
    if not spheric:
        s = got.get_image(0) if split == "test" else None
        rays = got.all_rays if split == "train" else s["rays"]
        assert (rays[:, 6:8] == [0.0, 1.0]).all()


def test_registry_and_unknown_names():
    assert get_dataset("llff") is get_dataset("real_colmap") \
        is RealDatasetColmap
    assert get_dataset("real_arkit") is RealDatasetARKit
    with pytest.raises(NotImplementedError, match="unknown dataset 'x'"):
        get_dataset("x")


def test_colmap_binary_round_trip(captures, tmp_path):
    """The port's writers and readers against the JAX package's: the same
    bytes, the same records, qvec ↔ rotation."""
    root = captures["colmap"]
    for name in ("cameras", "images"):
        path = os.path.join(root, f"sparse/{name}.bin")
        got = getattr(colmap_utils, f"read_{name}_binary")(path)
        want = getattr(jcolmap, f"read_{name}_binary")(path)
        assert got.keys() == want.keys()
        for k in got:
            for a, b in zip(got[k], want[k]):
                assert np.array_equal(a, b), (name, k)
        out = str(tmp_path / f"{name}.bin")
        getattr(jcolmap, f"write_{name}_binary")(got, out)
        assert open(out, "rb").read() == open(path, "rb").read(), name
    rng = np.random.default_rng(3)
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        assert np.array_equal(colmap_utils.rotmat2qvec(q),
                              jcolmap.rotmat2qvec(q))
        qv = colmap_utils.rotmat2qvec(q)
        assert np.array_equal(colmap_utils.qvec2rotmat(qv),
                              jcolmap.qvec2rotmat(qv))


def test_pose_helpers_match_jax():
    poses = camera_ring(6).astype(np.float64)
    for a, b in zip(pose.center_poses(poses), jpose.center_poses(poses)):
        assert np.array_equal(a, b)
    assert np.array_equal(pose.create_spiral_poses([0.3, 0.2, 0.1], 3.5, 7),
                          jpose.create_spiral_poses([0.3, 0.2, 0.1], 3.5, 7))
    assert np.array_equal(pose.create_spheric_poses(1.5, 9),
                          jpose.create_spheric_poses(1.5, 9))
    p0, p1 = poses[0], poses[3]
    assert np.array_equal(pose.interpolate_poses(p0, p1, 5),
                          jpose.interpolate_poses(p0, p1, 5))
    assert np.array_equal(pose.move_camera_pose_slightly(p0, 0.3),
                          jpose.move_camera_pose_slightly(p0, 0.3))
    q = pose.rotmat_to_quat(p1[:, :3])
    assert np.array_equal(q, jpose.rotmat_to_quat(p1[:, :3]))
    assert np.array_equal(pose.slerp(q, pose.rotmat_to_quat(p0[:, :3]), 0.4),
                          jpose.slerp(q, jpose.rotmat_to_quat(p0[:, :3]),
                                      0.4))


@pytest.mark.parametrize("layout", ["arkit", "colmap"])
def test_trainer_reads_capture_buffers(captures, layout, tmp_path):
    """The Trainer takes a capture's buffers as it takes the blender ones:
    the masked frames in the geometry stage, every frame after it, and the
    step count from all rays."""
    from mirror_nerf_tpu_torch.train.loop import Trainer

    _, cfg = _cfgs(root_dir=captures[layout], model_type="nerf_tpu",
                   grid_levels="16:8,32:8", batch_size=64,
                   train_geometry_stage_end_epoch=1)
    ds = get_dataset(f"real_{layout}")(captures[layout], "train", WH, cfg)
    assert ds.white_back is False and ds.wo_full_gt_mirror_masks
    tr = Trainer(cfg, ds, str(tmp_path), device="cpu")
    assert tr.steps_per_epoch == len(ds.all_rays) // 64
    for stage, want in ((True, (ds.rays_wmask, ds.rgbs_wmask,
                                ds.mirror_masks_wmask)),
                        (False, (ds.all_rays, ds.all_rgbs,
                                 ds.all_mirror_masks))):
        ds.train_geometry_stage = stage
        got = tr._train_buffers()
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), b)
    assert (ds.mirror_masks_wmask >= 0).all()
    assert (ds.all_mirror_masks == -1).any()


# run.sh's nerf_tpu model and data flags on a capture, at a tiny size
MODEL = ["--img_wh", "16", "12", "--near", "0.05", "--far", "8",
         "--model_type", "nerf_tpu", "--predict_normal",
         "--predict_mirror_mask", "--trace_secondary_rays", "--bound", "6",
         "--grid_levels", "16:8,32:8", "--N_samples", "6", "--N_importance",
         "6", "--chunk", "256", "--device", "cpu"]
# run.sh mode 0, two tiny epochs
TRAIN = MODEL + ["--batch_size", "96", "--num_epochs", "2",
                 "--train_geometry_stage",
                 "--train_geometry_stage_end_epoch", "1",
                 "--only_trace_rays_in_mirrors", "--novel_ray_batch", "32",
                 "--novel_ray_start_epoch", "1"]


@pytest.mark.parametrize("name", ["real_arkit", "real_colmap", "llff"])
def test_train_and_eval_cli_on_a_capture(tmp_path, monkeypatch, name):
    """Generated captures in the ARKit and COLMAP layouts: two tiny epochs
    through the train CLI, then its checkpoint through the eval CLI (a
    test view; the COLMAP test split is the 120-pose spheric path)."""
    from mirror_nerf_tpu_torch.data.synthetic import (generate_scene_arkit,
                                                      generate_scene_colmap)
    from mirror_nerf_tpu_torch.eval import main as eval_main
    from mirror_nerf_tpu_torch.train import cli

    monkeypatch.chdir(tmp_path)
    if name == "real_arkit":
        generate_scene_arkit("cap", n_train=2, n_val=1, n_test=2,
                             img_wh=WH)
    else:
        generate_scene_colmap("cap", n_images=3, img_wh=WH)
    flags = ["--dataset_name", name, "--root_dir", "cap"]
    with one_thread():
        tr = cli.main(flags + TRAIN + ["--exp_name", "t"])
    lines = open(os.path.join(tr.workdir, "val_metrics.jsonl")).readlines()
    assert len(lines) == 2
    assert all(np.isfinite(json.loads(x)["val_psnr"]) for x in lines)
    with one_thread():
        out = eval_main(flags + MODEL + [
            "--fused_field", "--max_recursive_level", "2",
            "--ckpt_path", os.path.join(tr.workdir, "last.ckpt.npz"),
            "--only_eval_idx", "1", "--exp_name", "e"])
    assert "rgb_fine_001.png" in os.listdir(out)
