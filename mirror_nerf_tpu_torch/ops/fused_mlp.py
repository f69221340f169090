"""Fused flagship PE-MLP field, per-sample rows (the σ-noise passes and the
point queries).

Torch counterpart of `mirror_nerf_tpu/ops/pallas/fused_mlp.py`: the same
8×256 trunk and heads as ops/fused_mlp_t.py, but one row per sample out and
no compositing, so that a σ-noise pass can add its noise to raw σ first.
A row is 8 float32 values: lane 0 raw σ, 1:4 sigmoid rgb, 4:7 the unit
predicted normal, 7 the sigmoid mirror probability, 0 where the field lacks
the head (as the JAX packing gives); a σ-only row is raw σ alone.

  * `fused_rays_eval`: per-ray o, d, view dir (N, 3) and depths z (N, S) ->
    (N·S, 8) rows, ray-major (JAX `fused_rays_eval`).
  * `fused_packed_eval`: points xyz and view dirs (B, 3) -> (B, 8) rows
    (JAX `fused_packed_eval`); `fused_field_eval` splits them into
    (σ, rgb, normal | None, mirror | None), or (σ,) when σ-only.
  * `mlp_rows_reference` (points) and `mlp_rays_rows_reference` (rays) are
    the plain PyTorch version (the field modules of models/fields.py). CPU
    tensors take it; CUDA tensors launch the rows
    mode of the hand-written kernel `csrc/fused_mlp_t.cu` (sm_90a; see its
    source note), counted in `launches_rays` and `launches_points`. There is
    no fallback: a kernel that fails to build or launch raises.

The view dirs go to the posenc as given (the color head of
`MirrorNeRFField` does not normalize them either). Forward-only.
"""

from __future__ import annotations

import torch

from ..core.mathutil import l2_normalize
from .fused_cp import check_ray_inputs, on_cpu, prep
from .fused_mlp_t import check_kernel_call, launch_kernel

ROW = 8  # σ, rgb (3), normal (3), mirror

# kernel launches since import (or since a caller last reset them to 0):
# rays (JAX `_kernel_rays`) and points (JAX `_kernel`)
launches_rays = 0
launches_points = 0


def mlp_rows_reference(field, params: dict, xyz, dirs=None,
                       sigma_only: bool = False) -> torch.Tensor:
    """The plain PyTorch version (any device): (B, 3) points and view dirs
    -> (B, 8) rows, or (B, 1) raw σ when σ-only."""
    sigma, geo = field.density(params, xyz)
    if sigma_only:
        return sigma[:, None]
    b = xyz.shape[0]
    nrm = (l2_normalize(field.normal_head(params, geo))
           if field.predict_normal else geo.new_zeros((b, 3)))
    mir = (field.mirror_head(params, geo)[:, None]
           if field.predict_mirror_mask else geo.new_zeros((b, 1)))
    return torch.cat([sigma[:, None], field.color(params, geo, dirs), nrm,
                      mir], dim=-1)


def mlp_rays_rows_reference(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool = False) -> torch.Tensor:
    """The plain version in ray mode (any device): per-ray inputs ->
    (N·S, 8) rows, ray-major."""
    s = z_vals.shape[1]
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
           ).reshape(-1, 3)
    dirs = None if sigma_only else view_dirs.repeat_interleave(s, dim=0)
    return mlp_rows_reference(field, params, xyz, dirs, sigma_only)


def fused_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                    sigma_only: bool) -> torch.Tensor:
    """Launch the rows mode on the current stream. Inputs must be float32,
    contiguous, on one CUDA device: rays_o/rays_d/view_dirs (N, 3), z (N, S).
    Returns (N·S, 8) rows, or (N·S, 1) raw σ when σ-only."""
    check_kernel_call(field, params, (rays_o, rays_d, view_dirs, z_vals),
                      "relu", "rows")
    n, s = z_vals.shape
    check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only)
    rows = torch.empty((n * s, 1 if sigma_only else ROW),
                       dtype=torch.float32, device=z_vals.device)
    if n:
        launch_kernel(field, params, rays_o, rays_d, view_dirs, z_vals,
                      sigma_only, False, True, rows=rows)
    return rows


def fused_rays_eval(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                    sigma_only: bool = False) -> torch.Tensor:
    """Ray mode: (N, 3) origins/dirs/view dirs + (N, S) depths -> (N·S, 8)
    rows, ray-major ((N·S, 1) raw σ when σ-only). CPU tensors take the plain
    version; CUDA tensors the kernel."""
    global launches_rays
    if on_cpu(z_vals.device, "fused PE-MLP rows"):
        return mlp_rays_rows_reference(field, params, rays_o, rays_d,
                                       view_dirs, z_vals, sigma_only)
    rows = fused_rows_cuda(field, params, prep(rays_o), prep(rays_d),
                           None if sigma_only else prep(view_dirs),
                           prep(z_vals), sigma_only)
    if z_vals.shape[0]:
        launches_rays += 1
    return rows


def fused_packed_eval(field, params: dict, xyz, dirs=None,
                      sigma_only: bool = False) -> torch.Tensor:
    """Point mode: (B, 3) raw coords [+ (B, 3) view dirs] -> (B, 8) rows
    ((B, 1) raw σ when σ-only). On the card each point is a one-sample ray
    o = x, d = 0, z = 0 (x + 0·0 is x exactly), 256 to a block."""
    global launches_points
    if not sigma_only and dirs is None:
        raise ValueError("fused_packed_eval needs view dirs unless σ-only")
    if on_cpu(xyz.device, "fused PE-MLP rows"):
        return mlp_rows_reference(field, params, xyz, dirs, sigma_only)
    x = prep(xyz)
    zeros = torch.zeros_like(x)
    rows = fused_rows_cuda(field, params, x, zeros,
                           None if sigma_only else prep(dirs),
                           zeros[:, :1].contiguous(), sigma_only)
    if x.shape[0]:
        launches_points += 1
    return rows


def fused_field_eval(field, params: dict, xyz, dirs=None,
                     sigma_only: bool = False) -> tuple:
    """`fused_packed_eval` split into separate tensors: (σ,) when σ-only,
    else (σ, rgb, unit normal | None, mirror | None), None for a head the
    field lacks."""
    rows = fused_packed_eval(field, params, xyz, dirs, sigma_only)
    if sigma_only:
        return (rows[:, 0],)
    return (rows[:, 0], rows[:, 1:4],
            rows[:, 4:7] if field.predict_normal else None,
            rows[:, 7] if field.predict_mirror_mask else None)
