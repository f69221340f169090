"""Camera-ray generation (numpy on host, jnp-safe on device).

Capability parity with reference `datasets/ray_utils.py:6-98`: pinhole ray
directions without +0.5 pixel centering, world-space rays with normalized
directions, and the NDC warp for forward-facing captures.

These run on the host once per dataset (ray buffers are precomputed), so they
are written against `numpy`; every function also works when handed jnp arrays.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    """Per-pixel ray directions in the camera frame, (H, W, 3).

    Convention (matches reference `ray_utils.py:6-26`): x right, y up, camera
    looks down -z; no half-pixel offset.
    """
    j, i = np.meshgrid(
        np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij"
    )
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1
    )
    return dirs.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space rays for one image.

    Args:
      directions: (H, W, 3) camera-frame directions.
      c2w: (3, 4) camera-to-world matrix.
    Returns:
      rays_o, rays_d: both (H*W, 3); rays_d unit length.
    """
    c2w = np.asarray(c2w, dtype=np.float32)
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), rays_d.reshape(-1, 3).astype(
        np.float32
    )


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o: np.ndarray,
                 rays_d: np.ndarray):
    """Warp world rays into NDC (for unbounded forward-facing scenes).

    Matches reference `ray_utils.py:57-98`.
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def make_ray_buffer(rays_o: np.ndarray, rays_d: np.ndarray, near: float,
                    far: float) -> np.ndarray:
    """Pack rays into the canonical (N, 8) = [o, d, near, far] layout.

    This is the ray contract used everywhere (reference `blender.py:159-168`,
    `rendering.py:73`).
    """
    n = np.full_like(rays_o[:, :1], near)
    f = np.full_like(rays_o[:, :1], far)
    return np.concatenate([rays_o, rays_d, n, f], axis=1).astype(np.float32)
