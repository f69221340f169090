"""The fused NGP composite: the hash-grid model's field (`NGPField`,
`--model_type nerf_tcnn`) and a noise-free pass's compositing in one kernel.

  * `fused_hash_rays_composite(field, params, rays_o, rays_d, view_dirs,
    z_vals, sigma_only, sigma_act)`: per-ray o, d, view dir (N, 3) and
    sorted depths z (N, S) in; `weights` (N, S) and, unless σ-only, per-ray
    `opacity`, `rgb` (N, 3), `normal` (N, 3), `mirror` and `depth` out, the
    dict of `fused_cp.fused_cp_rays_composite`. Eval semantics (no σ
    noise).

The kernel is `hash_field_kernel` of `csrc/fused_cp_composite.cu` (C entry
`mnerf_fused_hash_composite`, in the CP composite's library): the CP
composite's body with the hash grid's levels in place of the CP fold. Each
lane interpolates its samples' levels with ENCODE's device functions
(`csrc/hashgrid.cuh`) straight into the σ-net's 3×TF32 A fragments; the
heads, SH4 and the exclusive-prefix composite are the CP composite's. The
JAX package runs the same function on XLA: its hash encoder's gathers
(`mirror_nerf_tpu/ops/hashgrid.py:139`), the nets and the renderer's
compositing; on the card the port ran ENCODE (csrc/hashgrid.cu) and then
PyTorch for the rest.

The plain version, `hash_rays_composite_reference`, is the field modules
with the plain encoder plus the exclusive-prefix composite (any device).
The adapter dispatches on the device of z: CPU tensors take the plain
version, CUDA tensors the kernel, with no fallback (a kernel that fails to
build or launch raises). Launches are counted in `launches`. Forward-only:
an input or a parameter that requires grad under grad mode raises.

The wrapper hands the kernel the nets of `fused_cp._pack_nets` without the
fold (s1's K rows in `c_order`, zero rows past 2·levels), the flat (rows,
2) table as it is, and the level table of ENCODE (`hashgrid._level_table`).
"""

from __future__ import annotations

import ctypes

import torch

from ..train.checkpoints import tree_leaves
from ._build import Library, card_index
from .fused_cp import (_ACTS, _composite_outputs, _pack_nets, _ptr,
                       check_ray_inputs, cp_rays_composite_reference, on_cpu,
                       prep, split_per_ray)
from .fused_cp import _LIB as _CP_LIB
from .hashgrid import _level_table, hashgrid_encode_reference

_LIB = _CP_LIB  # the kernel is built into the CP composite's library
# the entry's negative return codes (see mnerf_fused_hash_composite)
_REFUSALS = {-1: "the level count is outside [1, 16]",
             -2: "S is outside [1, 256] samples per ray",
             -4: "the packed nets disagree with the kernel's layout",
             -6: "no rays"}

# kernel launches since import (or since a caller last reset them to 0)
launches = 0


def hash_density_reference(field, params: dict, xyz):
    """`field.density` through the plain encoder on any device (σ raw,
    geo)."""
    return field.density(params, xyz, encode=hashgrid_encode_reference)


def hash_rays_composite_reference(field, params: dict, rays_o, rays_d,
                                  view_dirs, z_vals, sigma_only: bool = False,
                                  sigma_act: str = "relu") -> dict:
    """The plain PyTorch version of the fused NGP composite (any device):
    the field modules with the plain encoder, then weights by the exclusive
    prefix of δ·act(σ) (δ_inf = 1e10 on each ray's last sample) and the
    per-ray sums."""
    return cp_rays_composite_reference(
        field, params, rays_o, rays_d, view_dirs, z_vals, sigma_only,
        sigma_act, density=lambda p, x: hash_density_reference(field, p, x))


# the entry's arguments before the card and the stream (_build.Library):
# rays_o, rays_d, vdir, z, table, levels, n_levels, nets, n_nets, n_rays, S,
# bound, inv_2b, sigma_only, softplus, weights, per_ray
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_library = Library(_LIB, {"mnerf_fused_hash_composite": [
    _P, _P, _P, _P, _P, _P, _I, _P, ctypes.c_longlong, _I, _I, _F, _F, _I,
    _I, _P, _P]}, _REFUSALS)
_F32 = (torch.float32,)


def fused_hash_composite_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                              z_vals, sigma_only: bool, sigma_act: str):
    """Launch the kernel on the current stream. Inputs must be float32,
    contiguous, on one CUDA device: rays_o/rays_d/view_dirs (N, 3), z
    (N, S). Returns (weights (N, S), per_ray (N, 9) or None), per_ray's
    columns [opacity, rgb, normal, mirror, depth]."""
    global launches
    # the guard first, so that it holds whatever else is wrong with the call
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (rays_o, rays_d, view_dirs, z_vals,
                      *tree_leaves(params))):
        raise ValueError(
            "the fused NGP composite is forward-only, and an input or a "
            "parameter requires grad: run it under torch.no_grad()")
    if not field.supports_fused_hash:
        raise ValueError("the fused NGP composite needs 2-feature levels, "
                         "at most 16, and the default net dims "
                         "(NGPField.supports_fused_hash)")
    if not z_vals.is_cuda:
        raise ValueError(f"the fused NGP composite needs CUDA tensors, got "
                         f"{z_vals.device}")
    if sigma_act not in _ACTS:
        raise ValueError(f"sigma_act must be one of {_ACTS}")
    n, s = z_vals.shape
    o, d, z, *v = check_ray_inputs(rays_o, rays_d, view_dirs, z_vals,
                                   sigma_only)
    outs = _composite_outputs(n, s, sigma_only, z.device)
    if n == 0:
        return outs["weights"], outs["per_ray"]
    spec = field.grid_spec
    table = params["grid"]
    if tuple(table.shape) != (spec.table_rows, spec.level_dim):
        raise ValueError(f"need the table ({spec.table_rows}, "
                         f"{spec.level_dim}), got {tuple(table.shape)}")
    nets = _pack_nets(params, ())
    words = _level_table(spec, z.device)
    dev = card_index("fused NGP composite", ("z_vals", z, _F32, 4),
                     ("table", table, _F32, 8), ("nets", nets, _F32, 16),
                     ("levels", words, (torch.int32,), 16))
    _library.launch(
        "mnerf_fused_hash_composite", "fused NGP composite", dev,
        o.data_ptr(), d.data_ptr(), _ptr(v[0] if v else None), z.data_ptr(),
        table.data_ptr(), words.data_ptr(), spec.num_levels,
        nets.data_ptr(), nets.numel(), n, s, float(field.bound),
        field.inv_2b, int(sigma_only), int(sigma_act == "softplus"),
        outs["weights"].data_ptr(), _ptr(outs["per_ray"]))
    launches += 1
    return outs["weights"], outs["per_ray"]


def fused_hash_rays_composite(field, params: dict, rays_o, rays_d,
                              view_dirs, z_vals, sigma_only: bool = False,
                              sigma_act: str = "relu") -> dict:
    """Weights (N, S) always; plus per-ray opacity/rgb/normal/mirror/depth
    unless sigma_only. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if on_cpu(z_vals.device, "fused NGP composite"):
        return hash_rays_composite_reference(field, params, rays_o, rays_d,
                                             view_dirs, z_vals, sigma_only,
                                             sigma_act)
    return split_per_ray(*fused_hash_composite_cuda(
        field, params, prep(rays_o), prep(rays_d),
        None if sigma_only else prep(view_dirs), prep(z_vals), sigma_only,
        sigma_act))
