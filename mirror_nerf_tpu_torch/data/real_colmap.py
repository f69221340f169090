"""COLMAP-reconstructed real-capture dataset (LLFF-style).

Capability parity with reference `datasets/real_colmap.py`: reads
`sparse/cameras.bin` + `sparse/images.bin`, inverts w2c, flips the axis
convention "right down front" → "right up back", centers poses, applies the
user near/far (divided by scale_factor) and an NDC branch for non-spheric
captures; test split renders a parametric path (spiral for forward-facing,
spheric otherwise). Registered as both "real_colmap" and "llff".

A copy of the JAX package's `data/real_colmap.py`; the images come through
`data/blender.py`'s PIL reader, the masks through its cv2 one.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.pose import (center_poses, create_spheric_poses,
                         create_spiral_poses)
from ..core.rays import (get_ndc_rays, get_ray_directions, get_rays,
                         make_ray_buffer)
from . import register
from .blender import _load_image, _load_mask
from .colmap_utils import read_cameras_binary, read_images_binary


@register("real_colmap")
@register("llff")
class RealDatasetColmap:
    white_back = False

    def __init__(self, root_dir: str, split: str = "train", img_wh=(800, 800),
                 cfg=None, spheric_poses: bool = True):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.cfg = cfg
        self.spheric_poses = spheric_poses if cfg is None else (
            cfg.spheric_poses or spheric_poses)
        self.wo_full_gt_mirror_masks = False
        self.train_geometry_stage = bool(cfg.train_geometry_stage) if cfg else False
        self._read_meta()

    def _read_meta(self):
        cfg = self.cfg
        camdata = read_cameras_binary(
            os.path.join(self.root_dir, "sparse/cameras.bin"))
        cam = camdata[min(camdata.keys())]
        self.focal = cam.params[0] * self.img_wh[0] / cam.width

        imdata = read_images_binary(
            os.path.join(self.root_dir, "sparse/images.bin"))
        names = [imdata[k].name for k in imdata]
        perm = np.argsort(names)
        self.image_paths = [
            os.path.join(self.root_dir, "images", n) for n in sorted(names)]

        bottom = np.array([[0, 0, 0, 1.0]])
        w2c = []
        for k in imdata:
            im = imdata[k]
            R = im.qvec2rotmat()
            t = im.tvec.reshape(3, 1)
            w2c.append(np.concatenate(
                [np.concatenate([R, t], 1), bottom], 0))
        poses = np.linalg.inv(np.stack(w2c))[:, :3]  # c2w (N, 3, 4)
        poses = poses[perm]
        # "right down front" -> "right up back"
        poses = np.concatenate(
            [poses[..., 0:1], -poses[..., 1:3], poses[..., 3:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)

        self.bounds = np.zeros((len(poses), 2))
        self.bounds[:, 0] = cfg.near
        self.bounds[:, 1] = cfg.far
        self.bounds /= cfg.scale_factor
        self.poses[..., 3] /= cfg.scale_factor

        w, h = self.img_wh
        self.directions = get_ray_directions(h, w, self.focal)

        val_idx = cfg.val_idx
        if self.split == "train":
            skip = cfg.train_skip_step
            if skip != 1:
                self.image_paths = self.image_paths[::skip]
                self.poses = self.poses[::skip]
                self.bounds = self.bounds[::skip]
            all_rays, all_rgbs, all_masks = [], [], []
            w_rays, w_rgbs, w_masks = [], [], []
            for i, image_path in enumerate(self.image_paths):
                if i == val_idx:
                    continue
                s = self.read_frame_data(self.poses[i], image_path)
                if s is None:
                    continue
                all_rays.append(s["rays"])
                all_rgbs.append(s["rgbs"])
                all_masks.append(s["mirror_mask"])
                if (s["mirror_mask"] >= 0).all():
                    w_rays.append(s["rays"])
                    w_rgbs.append(s["rgbs"])
                    w_masks.append(s["mirror_mask"])
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
            self.all_mirror_masks = np.concatenate(all_masks, 0)
            self.rays_wmask = (np.concatenate(w_rays, 0) if w_rays
                               else self.all_rays[:0])
            self.rgbs_wmask = (np.concatenate(w_rgbs, 0) if w_rgbs
                               else self.all_rgbs[:0])
            self.mirror_masks_wmask = (np.concatenate(w_masks, 0) if w_masks
                                       else self.all_mirror_masks[:0])
        elif self.split == "val":
            self.val_idx = val_idx
        elif self.split in ("test", "test_train"):
            if self.split.endswith("train"):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def read_frame_data(self, c2w, image_path, no_data_when_test=False):
        cfg = self.cfg
        rays_o, rays_d = get_rays(self.directions, np.asarray(c2w, np.float32))
        if not self.spheric_poses:
            near, far = 0.0, 1.0
            rays_o, rays_d = get_ndc_rays(
                self.img_wh[1], self.img_wh[0], self.focal, 1.0, rays_o, rays_d)
        else:
            near = cfg.near / cfg.scale_factor
            far = cfg.far / cfg.scale_factor
        rays = make_ray_buffer(np.asarray(rays_o, np.float32),
                               np.asarray(rays_d, np.float32), near, far)
        if no_data_when_test:
            return {"rays": rays, "c2w": c2w}

        img = _load_image(image_path, self.img_wh)
        rgbs = img.reshape(-1, img.shape[-1])[:, :3]

        img_file_name = os.path.split(image_path)[-1]
        mask_path = os.path.join(self.root_dir, "masks", img_file_name)
        mirror_mask = _load_mask(mask_path, self.img_wh)
        if mirror_mask is None:
            self.wo_full_gt_mirror_masks = True
            mirror_mask = np.full((self.img_wh[1], self.img_wh[0]), -1.0,
                                  np.float32)
        return {
            "rays": rays,
            "c2w": c2w,
            "rgbs": rgbs.astype(np.float32),
            "mirror_mask": mirror_mask.reshape(-1).astype(np.float32),
        }

    def __len__(self):
        if self.split == "train":
            return len(self.rays_wmask) if self.train_geometry_stage else len(
                self.all_rays)
        if self.split == "val":
            return 1
        if self.split == "test_train":
            return len(self.poses)
        if self.split == "test":
            return len(self.poses_test)
        return len(self.image_paths)

    def train_buffers(self):
        if self.train_geometry_stage:
            return self.rays_wmask, self.rgbs_wmask, self.mirror_masks_wmask
        return self.all_rays, self.all_rgbs, self.all_mirror_masks

    def get_image(self, idx: int) -> dict:
        if self.split == "val":
            return self.read_frame_data(self.poses[self.val_idx],
                                        self.image_paths[self.val_idx])
        if self.split == "test":
            return self.read_frame_data(self.poses_test[idx], None,
                                        no_data_when_test=True)
        return self.read_frame_data(self.poses[idx], self.image_paths[idx])
