"""Blender-format dataset (synthetic mirror scenes).

Capability parity with reference `datasets/blender.py`: reads
`transforms_{split}.json`, rescales the focal from the 800-px reference width,
white-blends RGBA, binarizes mirror masks (missing mask → all −1 sentinel),
and builds flat ray buffers plus the `*_wmask` buffers (frames with valid GT
masks only) that serve as the dataset during the geometry stage.

Host-side numpy only — batches are sampled as index gathers and shipped to
device by the training loop.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.rays import get_ray_directions, get_rays, make_ray_buffer
from . import register


def _load_image(path: str, img_wh) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.size != tuple(img_wh):
        img = img.resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0  # (H, W, C)
    return arr


def _load_mask(path: str, img_wh) -> np.ndarray:
    import cv2

    mask = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    if mask is None:
        mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if mask is None:
        return None
    mask = cv2.resize(mask, tuple(img_wh), interpolation=cv2.INTER_NEAREST)
    mask = mask.astype(np.float32)
    if mask.max() > 1.0:
        mask = mask / 255.0
    mask = np.where(mask < 0.5, 0.0, np.where(mask > 0.5, 1.0, mask))
    return mask


@register("blender")
class BlenderDataset:
    white_back = False  # True only for single-object scenes

    def __init__(self, root_dir: str, split: str = "train", img_wh=(800, 800),
                 cfg=None):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.cfg = cfg
        self.wo_full_gt_mirror_masks = False
        self.train_geometry_stage = bool(cfg.train_geometry_stage) if cfg else False
        self._read_meta()

    # ---- metadata / buffers ----

    def _read_meta(self):
        cfg = self.cfg
        with open(os.path.join(self.root_dir,
                               f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        # focal stored relative to an 800-px wide reference render
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800

        self.near = cfg.near if cfg else 0.05
        self.far = cfg.far if cfg else 8.0
        self.directions = get_ray_directions(h, w, self.focal)

        if self.split == "train":
            skip = cfg.train_skip_step if cfg else 1
            self.meta["frames"] = self.meta["frames"][::skip]
            all_rays, all_rgbs, all_masks, poses = [], [], [], []
            w_rays, w_rgbs, w_masks, w_poses = [], [], [], []
            for idx, frame in enumerate(self.meta["frames"]):
                s = self.read_frame_data(frame)
                if s is None:
                    continue
                poses.append(s["pose"])
                all_rays.append(s["rays"])
                all_rgbs.append(s["rgbs"])
                all_masks.append(s["mirror_mask"])
                if (s["mirror_mask"] >= 0).all():
                    w_poses.append(s["pose"])
                    w_rays.append(s["rays"])
                    w_rgbs.append(s["rgbs"])
                    w_masks.append(s["mirror_mask"])
            self.poses = np.stack(poses)
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
            self.all_mirror_masks = np.concatenate(all_masks, 0)
            if w_rays:
                self.rays_wmask = np.concatenate(w_rays, 0)
                self.rgbs_wmask = np.concatenate(w_rgbs, 0)
                self.mirror_masks_wmask = np.concatenate(w_masks, 0)
            else:
                self.rays_wmask = self.all_rays[:0]
                self.rgbs_wmask = self.all_rgbs[:0]
                self.mirror_masks_wmask = self.all_mirror_masks[:0]
        elif self.split == "val":
            self.val_idx = cfg.val_idx if cfg else 0

    def read_frame_data(self, frame) -> dict:
        pose = np.asarray(frame["transform_matrix"], np.float32)
        c2w = pose[:3, :4]

        image_path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        if not os.path.exists(image_path):
            return None
        img = _load_image(image_path, self.img_wh)  # (H, W, C)
        c = img.shape[-1]
        flat = img.reshape(-1, c)
        if c == 4:
            valid_mask = flat[:, 3] > 0
            rgbs = flat[:, :3] * flat[:, 3:4] + (1.0 - flat[:, 3:4])
        else:
            valid_mask = np.ones(flat.shape[0], bool)
            rgbs = flat[:, :3]

        img_file_name = os.path.split(frame["file_path"])[-1]
        mask_path = os.path.join(
            self.root_dir, "masks", f"MirrorMask_{img_file_name[6:]}.png"
        )
        mirror_mask = _load_mask(mask_path, self.img_wh)
        if mirror_mask is None:
            self.wo_full_gt_mirror_masks = True
            mirror_mask = np.full((self.img_wh[1], self.img_wh[0]), -1.0,
                                  np.float32)
        mirror_mask = mirror_mask.reshape(-1)

        rays_o, rays_d = get_rays(self.directions, c2w)
        rays = make_ray_buffer(rays_o, rays_d, self.near, self.far)
        return {
            "rays": rays,
            "rgbs": rgbs.astype(np.float32),
            "pose": pose,
            "c2w": c2w,
            "valid_mask": valid_mask,
            "mirror_mask": mirror_mask.astype(np.float32),
        }

    # ---- access ----

    def __len__(self):
        if self.split == "train":
            return len(self.rays_wmask) if self.train_geometry_stage else len(
                self.all_rays)
        if self.split == "val":
            return 1
        return len(self.meta["frames"])

    def train_buffers(self):
        """(rays, rgbs, mirror_masks) flat host arrays for the current stage."""
        if self.train_geometry_stage:
            return self.rays_wmask, self.rgbs_wmask, self.mirror_masks_wmask
        return self.all_rays, self.all_rgbs, self.all_mirror_masks

    def get_image(self, idx: int) -> dict:
        """Full-image sample for val/test splits."""
        if self.split == "val":
            frame = self.meta["frames"][self.val_idx]
        else:
            frame = self.meta["frames"][idx]
        return self.read_frame_data(frame)
