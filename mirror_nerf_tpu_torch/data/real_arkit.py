"""ARKit real-capture dataset.

Capability parity with reference `datasets/real_arkit.py`: focal from
`camera_angle_x` (1920-px base) or per-frame intrinsics; poses centered by
the average pose over ALL frames (`transforms.json`) so train/val share a
world frame; translations and near/far divided by `scale_factor`; mask files
named after the image file; extra eval splits `test_rotate` (camera wobble
around one pose) and `test_interpolation` (slerp+lerp through the split's
poses).

A copy of the JAX package's `data/real_arkit.py`; the images come through
`data/blender.py`'s PIL reader, the masks through its cv2 one.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.pose import (center_pose_from_avg, center_poses,
                         interpolate_poses, move_camera_pose_slightly)
from ..core.rays import get_ray_directions, get_rays, make_ray_buffer
from . import register
from .blender import _load_image, _load_mask


@register("real_arkit")
class RealDatasetARKit:
    white_back = False

    def __init__(self, root_dir: str, split: str = "train", img_wh=(800, 800),
                 cfg=None):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.cfg = cfg
        self.wo_full_gt_mirror_masks = False
        self.train_geometry_stage = bool(cfg.train_geometry_stage) if cfg else False
        self._read_meta()

    def _read_meta(self):
        cfg = self.cfg
        split_json = os.path.join(self.root_dir,
                                  f"transforms_{self.split}.json")
        if not os.path.exists(split_json) and self.split.startswith("test"):
            split_json = os.path.join(self.root_dir, "transforms_test.json")
        with open(split_json) as f:
            self.meta = json.load(f)
        with open(os.path.join(self.root_dir, "transforms.json")) as f:
            self.meta_all = json.load(f)

        w, h = self.img_wh
        if "camera_angle_x" in self.meta:
            self.focal = 0.5 * 1920 / np.tan(0.5 * self.meta["camera_angle_x"])
            self.focal *= w / 1920
        else:
            fx = self.meta.get("fx",
                               self.meta["frames"][0]["intrinsics"][0][0])
            cx = self.meta.get("cx",
                               self.meta["frames"][0]["intrinsics"][0][2])
            self.focal = fx * w / (cx * 2)

        self.near = cfg.near / cfg.scale_factor
        self.far = cfg.far / cfg.scale_factor
        self.directions = get_ray_directions(h, w, self.focal)

        poses_all = np.stack([np.asarray(fr["transform_matrix"])
                              for fr in self.meta_all["frames"]])
        self.poses_all, self.pose_avg = center_poses(poses_all[:, :3, :4])
        self.poses_all[..., 3] /= cfg.scale_factor

        val_idx = cfg.val_idx
        if self.split == "train":
            skip = cfg.train_skip_step
            self.meta["frames"] = self.meta["frames"][::skip]
            all_rays, all_rgbs, all_masks, poses = [], [], [], []
            w_rays, w_rgbs, w_masks = [], [], []
            for frame in self.meta["frames"]:
                s = self.read_frame_data(frame)
                if s is None:
                    continue
                poses.append(s["pose"])
                all_rays.append(s["rays"])
                all_rgbs.append(s["rgbs"])
                all_masks.append(s["mirror_mask"])
                if (s["mirror_mask"] >= 0).all():
                    w_rays.append(s["rays"])
                    w_rgbs.append(s["rgbs"])
                    w_masks.append(s["mirror_mask"])
            self.poses = np.stack(poses)
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
        elif self.split == "test_rotate":
            test_idx = val_idx
            if "market" in cfg.root_dir:
                test_idx = 77
                self.poses_all[test_idx][2, 3] -= 0.3
            n = 32
            self.meta["frames"] = [
                {"transform_matrix": move_camera_pose_slightly(
                    self.poses_all[test_idx], i / n), "_centered": True}
                for i in range(n)
            ]
        elif self.split == "test_interpolation":
            c2ws = []
            for frame in self.meta["frames"]:
                pose = np.asarray(frame["transform_matrix"])
                pose = center_pose_from_avg(self.pose_avg, pose)
                pose[..., 3] /= cfg.scale_factor
                c2ws.append(pose[:3, :4].copy())
            c2ws = np.stack(c2ws)
            n = 64
            per_seg = max(n // max(len(c2ws) - 1, 1), 1)
            frames = []
            for k in range(len(c2ws) - 1):
                for p in interpolate_poses(c2ws[k], c2ws[k + 1], per_seg):
                    c2w = np.eye(4)
                    c2w[:3, :4] = p
                    frames.append({"transform_matrix": c2w,
                                   "_centered": True})
            self.meta["frames"] = frames[:n] if len(frames) > n else frames

    def read_frame_data(self, frame) -> dict:
        cfg = self.cfg
        pose = np.asarray(frame["transform_matrix"], np.float64)
        no_data = self.split in ("test_rotate", "test_draw",
                                 "test_interpolation")
        if not frame.get("_centered", False):
            pose = center_pose_from_avg(self.pose_avg, pose)
            pose[..., 3] /= cfg.scale_factor
        c2w = pose[:3, :4].astype(np.float32)

        rays_o, rays_d = get_rays(self.directions, c2w)
        rays = make_ray_buffer(rays_o, rays_d, self.near, self.far)
        if no_data:
            return {"rays": rays, "c2w": c2w, "pose": pose}

        image_path = os.path.join(self.root_dir, frame["file_path"])
        if not os.path.exists(image_path):
            return None
        img = _load_image(image_path, self.img_wh)
        c = img.shape[-1]
        flat = img.reshape(-1, c)
        if c == 4:
            valid_mask = flat[:, 3] > 0
            rgbs = flat[:, :3] * flat[:, 3:4] + (1.0 - flat[:, 3:4])
        else:
            valid_mask = np.ones(flat.shape[0], bool)
            rgbs = flat[:, :3]

        img_file_name = os.path.split(frame["file_path"])[-1]
        mask_path = os.path.join(self.root_dir, "masks", img_file_name)
        mirror_mask = _load_mask(mask_path, self.img_wh)
        if mirror_mask is None:
            self.wo_full_gt_mirror_masks = True
            mirror_mask = np.full((self.img_wh[1], self.img_wh[0]), -1.0,
                                  np.float32)
        return {
            "rays": rays,
            "rgbs": rgbs.astype(np.float32),
            "pose": pose,
            "c2w": c2w,
            "valid_mask": valid_mask,
            "mirror_mask": mirror_mask.reshape(-1).astype(np.float32),
            "image_path": image_path,
        }

    def __len__(self):
        if self.split == "train":
            return len(self.rays_wmask) if self.train_geometry_stage else len(
                self.all_rays)
        if self.split == "val":
            return 1
        return len(self.meta["frames"])

    def train_buffers(self):
        if self.train_geometry_stage:
            return self.rays_wmask, self.rgbs_wmask, self.mirror_masks_wmask
        return self.all_rays, self.all_rgbs, self.all_mirror_masks

    def get_image(self, idx: int) -> dict:
        if self.split == "val":
            frame = self.meta["frames"][self.val_idx]
        else:
            frame = self.meta["frames"][idx]
        return self.read_frame_data(frame)
