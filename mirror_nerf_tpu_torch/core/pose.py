"""Camera-pose utilities (host-side numpy; a copy of the JAX package's
`core/pose.py`).

Capability parity with reference `datasets/geo_utils.py`: pose averaging and
centering (used by the real-capture datasets so train/test share a world
frame), spiral/spheric render paths, small camera wobbles for turntable-style
eval splits, and quaternion slerp for the pose-interpolation eval split
(`datasets/real_arkit.py:170-200`).
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average c2w pose of (N, 3, 4) poses: mean center, mean z, Gram-Schmidt."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def _homo(pose_3x4: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3] = pose_3x4[:3]
    return out


def center_poses(poses: np.ndarray):
    """Re-express all poses in the average-pose frame. Returns (poses, avg)."""
    pose_avg = average_poses(poses)
    return center_poses_from_avg(pose_avg, poses), pose_avg


def center_pose_from_avg(pose_avg: np.ndarray, pose: np.ndarray) -> np.ndarray:
    return np.linalg.inv(_homo(pose_avg)) @ _homo(pose)


def center_poses_from_avg(pose_avg: np.ndarray, poses: np.ndarray) -> np.ndarray:
    inv_avg = np.linalg.inv(_homo(pose_avg))
    last_row = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    return (inv_avg @ poses_homo)[:, :3]


def create_spiral_poses(radii, focus_depth: float, n_poses: int = 120) -> np.ndarray:
    """LLFF-style spiral render path (two turns), (n_poses, 3, 4)."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0.0, 1.0, 0.0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center], 1))
    return np.stack(poses, 0)


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """Circular poses around +z looking 36° downwards, (n_poses, 3, 4)."""

    def spheric_pose(theta, phi, r):
        trans_t = np.array(
            [[1, 0, 0, 0], [0, 1, 0, -0.9 * r], [0, 0, 1, r], [0, 0, 0, 1.0]]
        )
        rot_phi = np.array(
            [
                [1, 0, 0, 0],
                [0, np.cos(phi), -np.sin(phi), 0],
                [0, np.sin(phi), np.cos(phi), 0],
                [0, 0, 0, 1.0],
            ]
        )
        rot_theta = np.array(
            [
                [np.cos(theta), 0, -np.sin(theta), 0],
                [0, 1, 0, 0],
                [np.sin(theta), 0, np.cos(theta), 0],
                [0, 0, 0, 1.0],
            ]
        )
        c2w = rot_theta @ rot_phi @ trans_t
        flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])
        return (flip @ c2w)[:3]

    return np.stack(
        [spheric_pose(th, -np.pi / 5, radius)
         for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]],
        0,
    )


def move_camera_pose_slightly(pose: np.ndarray, progress: float) -> np.ndarray:
    """Small camera-frame spiral wobble used by the `test_rotate` eval split."""
    t = progress * np.pi * 4
    center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * 0.1
    out = pose.copy()
    out[:3, 3] += out[:3, :3] @ center
    return out


# --- quaternion helpers for pose interpolation splits ---


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array(
            [0.25 / s, (R[2, 1] - R[1, 2]) * s, (R[0, 2] - R[2, 0]) * s,
             (R[1, 0] - R[0, 1]) * s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation between two quaternions."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    theta = theta0 * t
    q2 = normalize(q1 - q0 * dot)
    return q0 * np.cos(theta) + q2 * np.sin(theta)


def interpolate_poses(pose0: np.ndarray, pose1: np.ndarray, n: int) -> np.ndarray:
    """Slerp rotation + lerp translation between two (3,4) c2w poses."""
    q0, q1 = rotmat_to_quat(pose0[:3, :3]), rotmat_to_quat(pose1[:3, :3])
    out = []
    for t in np.linspace(0.0, 1.0, n, endpoint=False):
        R = quat_to_rotmat(slerp(q0, q1, float(t)))
        c = (1 - t) * pose0[:3, 3] + t * pose1[:3, 3]
        out.append(np.concatenate([R, c[:, None]], axis=1))
    return np.stack(out, 0)
