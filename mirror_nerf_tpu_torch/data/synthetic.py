"""Procedural mirror-room scene with an exact numpy ray tracer.

Serves two purposes:
  * ground truth for end-to-end tests — a box room with smoothly textured
    walls and one perfectly planar mirror, rendered analytically (one
    reflection bounce), so a trained model's output can be compared against
    exact images;
  * a generator that writes the scene to disk in the reference's Blender
    dataset format (`transforms_{split}.json` + `r_*.png` +
    `masks/MirrorMask_*.png`, see reference `datasets/blender.py:27-156`),
    so the dataset loaders can be exercised without external downloads.

A copy of the JAX package's `data/synthetic.py` that writes its PNGs with
PIL, plus an ARKit-layout writer (`generate_scene_arkit`) for the
`real_arkit` loader.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.rays import get_ray_directions

HALF = 2.5  # room is the axis-aligned box [-HALF, HALF]^3
MIRROR_WALL = 2  # mirror on the z = -HALF wall (normal +z)
MIRROR_HALF_W = 1.6  # mirror rect: |x| < W, |y| < H on that wall
MIRROR_HALF_H = 1.4

_BASE_COLORS = {
    (0, +1): np.array([0.85, 0.30, 0.25]),  # +x wall: red-ish
    (0, -1): np.array([0.25, 0.60, 0.85]),  # -x wall: blue-ish
    (1, +1): np.array([0.90, 0.85, 0.70]),  # ceiling
    (1, -1): np.array([0.45, 0.40, 0.35]),  # floor
    (2, +1): np.array([0.35, 0.75, 0.40]),  # +z wall: green-ish
    (2, -1): np.array([0.55, 0.55, 0.60]),  # -z wall (mirror frame): gray
}


def _wall_uv(p: np.ndarray, axis: int) -> tuple:
    others = [a for a in range(3) if a != axis]
    return p[..., others[0]], p[..., others[1]]


def wall_color(p: np.ndarray, axis: np.ndarray, sign: np.ndarray) -> np.ndarray:
    """Smooth per-wall texture: base color + low-frequency sinusoid."""
    out = np.zeros(p.shape[:-1] + (3,), np.float32)
    for (ax, sg), base in _BASE_COLORS.items():
        sel = (axis == ax) & (sign == sg)
        if not sel.any():
            continue
        u, v = _wall_uv(p[sel], ax)
        tex = 0.15 * np.sin(1.7 * u) * np.sin(2.3 * v) + 0.08 * np.sin(0.9 * (u + v))
        out[sel] = np.clip(base[None, :] * (1.0 + tex[:, None]), 0.0, 1.0)
    return out


def _first_wall_hit(o: np.ndarray, d: np.ndarray):
    """Exit intersection of interior rays with the box. Returns t, axis, sign."""
    eps = 1e-9
    d_safe = np.where(np.abs(d) < eps, eps, d)
    sign = np.where(d_safe > 0, 1, -1)
    t_axis = (sign * HALF - o) / d_safe  # (N, 3) positive exit t per axis
    t_axis = np.where(t_axis <= 1e-6, np.inf, t_axis)
    axis = np.argmin(t_axis, axis=-1)
    t = np.take_along_axis(t_axis, axis[:, None], axis=-1)[:, 0]
    hit_sign = np.take_along_axis(sign, axis[:, None], axis=-1)[:, 0]
    return t, axis, hit_sign


def _in_mirror(p: np.ndarray, axis: np.ndarray, sign: np.ndarray) -> np.ndarray:
    on_wall = (axis == MIRROR_WALL) & (sign == -1)
    return on_wall & (np.abs(p[..., 0]) < MIRROR_HALF_W) & (
        np.abs(p[..., 1]) < MIRROR_HALF_H)


def trace_gt(o: np.ndarray, d: np.ndarray):
    """Exact one-bounce ray trace. Returns (rgb, mirror_mask, depth)."""
    o = o.reshape(-1, 3).astype(np.float64)
    d = d.reshape(-1, 3).astype(np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t, axis, sign = _first_wall_hit(o, d)
    p = o + t[:, None] * d
    mirror = _in_mirror(p, axis, sign)
    rgb = wall_color(p, axis, sign)

    if mirror.any():
        # reflect about the mirror normal (+z): (dx, dy, dz) -> (dx, dy, -dz)
        d2 = d[mirror].copy()
        d2[:, 2] = -d2[:, 2]
        o2 = p[mirror] + 1e-6 * d2
        t2, axis2, sign2 = _first_wall_hit(o2, d2)
        p2 = o2 + t2[:, None] * d2
        rgb[mirror] = wall_color(p2, axis2, sign2)
    return rgb.astype(np.float32), mirror.astype(np.float32), t.astype(np.float32)


def lookat_pose(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(3, 4) c2w with the reference convention: camera looks along -z."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


def camera_ring(n: int, radius: float = 1.3, height: float = 0.2,
                center_z: float = 1.2, phase: float = 0.0) -> np.ndarray:
    """Poses on an arc inside the room, all looking at the mirror wall.

    `phase` offsets the angular samples (in units of one sample step) so a
    val/test ring interleaves between, rather than lands on, train poses.
    """
    poses = []
    for k in range(n):
        ang = ((k + phase) / max(n, 1)) * 1.4 - 0.7  # sweep ±40°
        eye = np.array([radius * np.sin(ang), height * np.sin(2.1 * k),
                        center_z + 0.35 * np.cos(ang)])
        target = np.array([0.35 * np.sin(ang * 0.5), 0.0, -HALF])
        poses.append(lookat_pose(eye, target))
    return np.stack(poses)


def render_image(c2w: np.ndarray, H: int, W: int, focal: float):
    dirs = get_ray_directions(H, W, focal)
    rays_d = dirs.reshape(-1, 3) @ np.asarray(c2w[:, :3], np.float32).T
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    rgb, mask, depth = trace_gt(rays_o, rays_d)
    return (rgb.reshape(H, W, 3), mask.reshape(H, W), depth.reshape(H, W))


def _split_rings(n_train: int, n_val: int, n_test: int) -> dict:
    """The splits' poses. Val/test stay on the train camera shell (same
    radius, interleaved angles) — the NVS protocol of the reference's real
    scenes, whose test_interpolation split slerps between train poses
    (real_arkit.py:170-200). Poses off the shell start in space no train
    ray ever traversed, where any NeRF's density is unconstrained fog."""
    return {
        "train": camera_ring(n_train),
        "val": camera_ring(n_val, radius=1.3, height=0.12, phase=0.41),
        "test": camera_ring(n_test, radius=1.3, height=0.09, phase=0.23),
    }


def generate_scene(
    root_dir: str,
    n_train: int = 12,
    n_val: int = 2,
    n_test: int = 3,
    img_wh=(64, 64),
    camera_angle_x: float = 0.9,
    drop_mask_for_first_n: int = 0,
) -> str:
    """Write the procedural scene to disk in Blender dataset format."""
    from PIL import Image

    W, H = img_wh
    os.makedirs(os.path.join(root_dir, "masks"), exist_ok=True)
    # the reference computes focal from an 800px reference width
    # (blender.py:33-39); store camera_angle_x so that round-trips match.
    focal_at_this_res = 0.5 * W / np.tan(0.5 * camera_angle_x)

    splits = _split_rings(n_train, n_val, n_test)
    idx = 0
    for split, poses in splits.items():
        frames = []
        for pose in poses:
            # the loader derives the mask name by stripping a 6-char prefix
            # (reference blender.py:136-139), so images are "frame_<idx>"
            name = f"frame_{idx}"
            rgb, mask, _ = render_image(pose, H, W, focal_at_this_res)
            rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
            Image.fromarray((np.clip(rgba, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(root_dir, f"{name}.png"))
            if drop_mask_for_first_n <= 0 or idx >= drop_mask_for_first_n:
                Image.fromarray((mask * 255).astype(np.uint8)).save(
                    os.path.join(root_dir, "masks", f"MirrorMask_{idx}.png"))
            pose44 = np.eye(4, dtype=np.float64)
            pose44[:3] = pose
            frames.append(
                {"file_path": f"./{name}", "transform_matrix": pose44.tolist()}
            )
            idx += 1
        meta = {"camera_angle_x": camera_angle_x, "frames": frames}
        with open(os.path.join(root_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return root_dir


def generate_scene_colmap(
    root_dir: str,
    n_images: int = 24,
    img_wh=(64, 64),
    camera_angle_x: float = 0.9,
) -> str:
    """Write the procedural scene to disk in COLMAP-reconstruction layout
    (`sparse/cameras.bin` + `sparse/images.bin` + `images/` + `masks/`, the
    format `RealDatasetColmap` parses — reference
    `datasets/real_colmap.py:105-258`). Closes the parser→trainer seam for
    the real-capture path without external data: w2c extrinsics are derived
    by inverting the generator's c2w poses through the same axis-convention
    flip the loader undoes ("right up back" -> "right down front").
    """
    from PIL import Image as PILImage

    from .colmap_utils import Camera, Image, rotmat2qvec, \
        write_cameras_binary, write_images_binary

    W, H = img_wh
    os.makedirs(os.path.join(root_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "masks"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "sparse"), exist_ok=True)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    cameras = {1: Camera(1, "SIMPLE_PINHOLE", W, H,
                         np.array([focal, W / 2.0, H / 2.0]))}
    write_cameras_binary(cameras,
                         os.path.join(root_dir, "sparse", "cameras.bin"))

    poses = camera_ring(n_images)
    images = {}
    for i, c2w in enumerate(poses):
        name = f"img_{i:04d}.png"
        rgb, mask, _ = render_image(c2w, H, W, focal)
        PILImage.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root_dir, "images", name))
        PILImage.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(root_dir, "masks", name))
        # generator convention is the Blender/NeRF one ("right up back");
        # COLMAP stores w2c in "right down front" -> flip cols 1:3 then
        # invert (the loader inverts and flips back, real_colmap.py:57-69)
        c2w_cv = np.concatenate(
            [c2w[:, 0:1], -c2w[:, 1:3], c2w[:, 3:4]], axis=1)
        m = np.eye(4)
        m[:3] = c2w_cv
        w2c = np.linalg.inv(m)
        images[i + 1] = Image(
            i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
    write_images_binary(images, os.path.join(root_dir, "sparse", "images.bin"))
    return root_dir


def generate_scene_arkit(
    root_dir: str,
    n_train: int = 12,
    n_val: int = 2,
    n_test: int = 3,
    img_wh=(64, 64),
    camera_angle_x: float = 0.9,
) -> str:
    """Write the procedural scene to disk in the ARKit capture layout that
    `RealDatasetARKit` parses (reference `datasets/real_arkit.py`):
    `transforms.json` holding every frame (the loader centers all poses
    on their average), `transforms_{train,val,test}.json`, images under
    `images/` whose `file_path` keeps its extension, and `masks/` named
    after the image files. The focal is stored as `camera_angle_x`, which
    the loader reads against a 1920-px sensor and rescales to the width."""
    from PIL import Image

    W, H = img_wh
    os.makedirs(os.path.join(root_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(root_dir, "masks"), exist_ok=True)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    splits = _split_rings(n_train, n_val, n_test)
    idx = 0
    every = []
    for split, poses in splits.items():
        frames = []
        for pose in poses:
            name = f"frame_{idx:05d}.png"
            rgb, mask, _ = render_image(pose, H, W, focal)
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(root_dir, "images", name))
            Image.fromarray((mask * 255).astype(np.uint8)).save(
                os.path.join(root_dir, "masks", name))
            pose44 = np.eye(4, dtype=np.float64)
            pose44[:3] = pose
            frames.append({"file_path": f"images/{name}",
                           "transform_matrix": pose44.tolist()})
            idx += 1
        every += frames
        with open(os.path.join(root_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    with open(os.path.join(root_dir, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": every}, f)
    return root_dir
