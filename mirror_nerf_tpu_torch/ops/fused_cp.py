"""Fused CP-grid field + per-ray compositing (the eval path's kernel).

Torch counterpart of `fused_cp_rays_composite` in
`mirror_nerf_tpu/ops/pallas/fused_cp.py`, same contract: per-ray inputs
(o, d, view dir) and sorted depths z (N, S) in; a dict out with `weights`
(N, S) and, unless σ-only, per-ray `opacity`, `rgb` (N, 3), `normal` (N, 3),
`mirror` and `depth`.

  * `cp_rays_composite_reference` is the plain PyTorch version: the field
    modules of models/ + the exclusive-prefix transmittance.
  * `fused_cp_composite_cuda` launches the hand-written kernel
    `csrc/fused_cp_composite.cu` (sm_90a; see its source note) and counts
    its launches in the module-level `launches`.
  * `fused_cp_rays_composite` dispatches on the device of the inputs: the
    plain version for CPU tensors, the kernel for CUDA tensors. There is no
    fallback: a kernel that fails to build or launch raises.

Forward-only, eval semantics (no σ noise).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.mathutil import l2_normalize
from ..render.renderer import sigma_activation
from ..train.checkpoints import tree_leaves

_LIB = "fused_cp_composite"
_ACTS = ("relu", "softplus")
# the kernel entry's negative return codes (see mnerf_fused_cp_composite)
_REFUSALS = {-1: "the level count is outside [1, 8]",
             -2: "S is outside [1, 256] samples per ray",
             -3: "a level has G < 2 or R < 1",
             -4: "the packed nets disagree with the kernel's layout",
             -5: "the nets exceed the kernel's shared memory",
             -6: "no rays"}

# kernel launches since import (or since a caller last reset it to 0)
launches = 0


def prefix_weights(sd: torch.Tensor) -> torch.Tensor:
    """(N, S) sd = δ·act(σ) -> compositing weights
    w_i = exp(−Σ_{j<i} sd_j)·(1 − exp(−sd_i)). The prefix is EXCLUSIVE by
    construction, never the inclusive sum minus sd_i: each ray's last sd
    carries δ_inf = 1e10, and fp32 (1e10 + prefix) − 1e10 cancels the
    whole prefix."""
    excl = torch.cat([torch.zeros_like(sd[:, :1]),
                      torch.cumsum(sd[:, :-1], dim=-1)], dim=-1)
    return torch.exp(-excl) * (1.0 - torch.exp(-sd))


def cp_rays_composite_reference(field, params: dict, rays_o, rays_d,
                                view_dirs, z_vals, sigma_only: bool = False,
                                sigma_act: str = "relu") -> dict:
    """The plain PyTorch version of the kernel (any device)."""
    n, s = z_vals.shape
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    sigma, geo = field.density(params, xyz.reshape(-1, 3))
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                        torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    w = prefix_weights(
        deltas * sigma_activation(sigma.reshape(n, s), sigma_act))
    if sigma_only:
        return {"weights": w}
    dirs = l2_normalize(view_dirs, eps=1e-12).repeat_interleave(s, dim=0)
    rgb = field.color(params, geo, dirs).reshape(n, s, 3)
    nrm = l2_normalize(field.normal_head(params, geo)).reshape(n, s, 3)
    mir = field.mirror_head(params, geo).reshape(n, s)
    return {"weights": w, "opacity": w.sum(-1),
            "rgb": (w[..., None] * rgb).sum(1),
            "normal": (w[..., None] * nrm).sum(1),
            "mirror": (w * mir).sum(-1), "depth": (w * z_vals).sum(-1)}


def _pack_nets(params: dict) -> torch.Tensor:
    """Fold + nets in the kernel's order (`net_offsets` in the .cu), each
    matrix flattened in its (in, out) layout."""
    s, c, nn_, m = (params["sigma_net"], params["color_net"],
                    params["normal"], params["is_mirror"])
    parts = [params["grid"]["fold"], s[0]["w"], s[1]["w"], c[0]["w"],
             c[1]["w"], c[2]["w"], nn_[0]["w"], nn_[1]["w"], m[0]["w"],
             m[0]["b"], m[1]["w"], m[1]["b"]]
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)


def _pack_tables(params: dict, levels):
    """All (level, axis) tables in one flat buffer + their float offsets."""
    axes = params["grid"]["axes"]
    parts, offsets, off = [], [], 0
    for li in range(len(levels)):
        for a in range(3):
            t = axes[a][li].reshape(-1)
            parts.append(t)
            offsets.append(off)
            off += t.numel()
    return torch.cat(parts).to(torch.float32), offsets


_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library(_LIB)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mnerf_fused_cp_composite.argtypes = [
            p, p, p, p, p, p, ctypes.c_longlong, p, p, p, i, i, i,
            ctypes.c_float, i, i, p, p, p]
        lib.mnerf_fused_cp_composite.restype = i
        lib.mnerf_cuda_error_string.argtypes = [i]
        lib.mnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_cp_composite_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool, sigma_act: str):
    """Launch the CUDA kernel on the current stream. Inputs must be float32,
    contiguous, on one CUDA device: rays_o/rays_d/view_dirs (N, 3), z (N, S).
    Returns (weights (N, S), per_ray (N, 9) or None), per_ray's columns
    [opacity, rgb, normal, mirror, depth]."""
    global launches
    dev = z_vals.device
    if dev.type != "cuda":
        raise ValueError(f"fused_cp_composite_cuda needs CUDA tensors, got "
                         f"{dev}")
    if sigma_act not in _ACTS:
        raise ValueError(f"sigma_act must be one of {_ACTS}")
    if not field.supports_fused_cp:
        raise ValueError("the fused CP kernel needs the default net dims "
                         "(TPUGridField.supports_fused_cp)")
    n, s = z_vals.shape
    ins = {"rays_o": rays_o, "rays_d": rays_d, "z_vals": z_vals}
    if not sigma_only:
        ins["view_dirs"] = view_dirs
    for name, t in ins.items():
        want = (n, s) if name == "z_vals" else (n, 3)
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous float32 {want} tensor on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*ins.values(), *tree_leaves(params))):
        raise ValueError(
            "the fused CP composite kernel is forward-only, and an input or "
            "a parameter requires grad: run it under torch.no_grad(), or "
            "train through the differentiable kernels of "
            "ops/fused_cp_train.py")
    levels = tuple(field.grid_levels)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    per_ray = None if sigma_only else torch.empty(
        (n, 9), dtype=torch.float32, device=dev)
    if n == 0:
        return weights, per_ray
    lib = _library()
    nets = _pack_nets(params)
    tables, offsets = _pack_tables(params, levels)
    if nets.device != dev or tables.device != dev:
        raise ValueError(f"params must lie on {dev}")
    g_arr = (ctypes.c_int * len(levels))(*[g for g, _ in levels])
    r_arr = (ctypes.c_int * len(levels))(*[r for _, r in levels])
    off_arr = (ctypes.c_longlong * len(offsets))(*offsets)
    with torch.cuda.device(dev):  # the runtime launches on the current one
        rc = lib.mnerf_fused_cp_composite(
            rays_o.data_ptr(), rays_d.data_ptr(),
            None if sigma_only else view_dirs.data_ptr(), z_vals.data_ptr(),
            tables.data_ptr(), nets.data_ptr(), nets.numel(), g_arr, r_arr,
            off_arr, len(levels), n, s, float(field.bound), int(sigma_only),
            int(sigma_act == "softplus"), weights.data_ptr(),
            None if sigma_only else per_ray.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc < 0:
        raise ValueError(f"fused CP kernel refused its arguments: "
                         f"{_REFUSALS.get(rc, rc)}")
    if rc > 0:
        raise RuntimeError("fused CP kernel launch failed: "
                           + lib.mnerf_cuda_error_string(rc).decode())
    launches += 1
    return weights, per_ray


def fused_cp_rays_composite(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool = False,
                            sigma_act: str = "relu") -> dict:
    """Composite-mode adapter: weights (N, S) always; plus per-ray
    opacity/rgb/normal/mirror/depth unless sigma_only. CPU tensors take the
    plain version; CUDA tensors the kernel."""
    dev = z_vals.device
    if dev.type == "cpu":
        return cp_rays_composite_reference(field, params, rays_o, rays_d,
                                           view_dirs, z_vals, sigma_only,
                                           sigma_act)
    if dev.type != "cuda":
        raise ValueError(f"no fused CP path for device {dev}")

    def prep(t):
        return t.to(torch.float32).contiguous()

    weights, per_ray = fused_cp_composite_cuda(
        field, params, prep(rays_o), prep(rays_d),
        None if sigma_only else prep(view_dirs), prep(z_vals), sigma_only,
        sigma_act)
    res = {"weights": weights}
    if not sigma_only:
        res.update(opacity=per_ray[:, 0], rgb=per_ray[:, 1:4],
                   normal=per_ray[:, 4:7], mirror=per_ray[:, 7],
                   depth=per_ray[:, 8])
    return res
