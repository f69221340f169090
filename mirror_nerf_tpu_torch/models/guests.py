"""Guest object fields for the reflect-newly-placed-objects application
(torch counterpart of `mirror_nerf_tpu/models/guests.py`).

  * D-NeRF's `DirectTemporalNeRF`: a canonical NeRF conditioned through a
    time-deformation net Δx(x, t) (zero at t = 0), rendered by the D-NeRF
    pipeline (`dnerf_render`); two plain 8×256 MLPs, their products on
    cuBLAS on the card;
  * the vanilla nerf_pl NeRF: `MirrorNeRFField` without the normal and
    mirror heads, rendered by `render_rays` (its eval kernel on the card).

Both load the reference's torch checkpoints: a D-NeRF `.tar` with
`network_fn_state_dict` / `network_fine_state_dict` and the `config.txt`
beside it, a nerf_pl Lightning `.ckpt`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.sampling import merge_fine_z_vals, stratified_z_vals
from ..ops.segment_scan import exp_plain
from .embedding import posenc, posenc_dim
from .nn import init_linear, linear, relu


@dataclass(frozen=True)
class DNeRFField:
    """DirectTemporalNeRF in the port's functional style: parameters are a
    dict of {"w": (in, out), "b": (out,)} linears, the JAX package's
    layout."""

    depth: int = 8
    width: int = 256
    multires: int = 10
    multires_views: int = 4
    skips: Tuple[int, ...] = (4,)
    zero_canonical: bool = True

    @property
    def in_pts(self) -> int:
        return posenc_dim(3, self.multires)

    @property
    def in_views(self) -> int:
        return posenc_dim(3, self.multires_views)

    @property
    def in_time(self) -> int:
        return posenc_dim(1, self.multires)

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> dict:
        D, W = self.depth, self.width

        def lin(i, o):
            return init_linear(generator, i, o, device=device)

        def trunk(first_in):
            return [lin(first_in, W)] + [
                lin(W + (self.in_pts if i in self.skips else 0), W)
                for i in range(D - 1)]

        return {"pts": trunk(self.in_pts),
                "views": [lin(self.in_views + W, W // 2)],
                "feature": lin(W, W), "alpha": lin(W, 1),
                "rgb": lin(W // 2, 3),
                "time": trunk(self.in_pts + self.in_time),
                "time_out": lin(W, 3)}

    def query_time(self, params: dict, pts_emb, t_emb):
        """Δx(x, t). The skip re-concatenates the embedded points only
        (run_dnerf_helpers.py:127-135)."""
        h = torch.cat([pts_emb, t_emb], dim=-1)
        for i, layer in enumerate(params["time"]):
            h = relu(linear(layer, h))
            if i in self.skips:
                h = torch.cat([pts_emb, h], dim=-1)
        return linear(params["time_out"], h)

    def raw(self, params: dict, xyz, dirs, t: float):
        """(N, 3) points + (N, 3) view dirs + time t -> (N, 4) raw
        [rgb, σ]. At t = 0 the canonical field (Δx = 0)."""
        pts_emb = posenc(xyz, self.multires)
        if self.zero_canonical and float(t) == 0.0:
            x = xyz
        else:
            t_emb = posenc(torch.full_like(xyz[:, :1], float(t)),
                           self.multires)
            x = xyz + self.query_time(params, pts_emb, t_emb)
        h0 = posenc(x, self.multires)
        h = h0
        for i, layer in enumerate(params["pts"]):
            h = relu(linear(layer, h))
            if i in self.skips:
                h = torch.cat([h0, h], dim=-1)
        alpha = linear(params["alpha"], h)
        feat = linear(params["feature"], h)
        v = posenc(dirs, self.multires_views)
        hv = relu(linear(params["views"][0], torch.cat([feat, v], dim=-1)))
        return torch.cat([linear(params["rgb"], hv), alpha], dim=-1)


def dnerf_raw2outputs(raw, z_vals, rays_d, white_bkgd: bool = False):
    """D-NeRF compositing (run_dnerf.py:381-438): δ_inf = 1e10 on the last
    sample, δ·‖d‖, transmittance a cumprod of 1 − α + 1e-10; the
    exponential by `exp_plain` (no MKL on the CPU)."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[:, None]
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - exp_plain(-relu(raw[..., 3]) * dists)
    shifted = torch.cat([torch.ones_like(alpha[:, :1]),
                         1.0 - alpha + 1e-10], -1)
    weights = alpha * torch.cumprod(shifted[:, :-1], dim=-1)
    rgb_map = (weights[..., None] * rgb).sum(1)
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[:, None])
    return rgb_map, depth_map, acc_map, weights


def dnerf_render(field: DNeRFField, params: dict, rays, t: float,
                 N_samples: int = 64, N_importance: int = 0,
                 white_bkgd: bool = False,
                 params_fine: Optional[dict] = None) -> dict:
    """Render (N, 8) rays through the D-NeRF pipeline at time t ∈ [0, 1]:
    z linear from near to far, then, with N_importance, a deterministic
    inverse-CDF fine pass through the fine network (if there is one)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z_vals = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], N_samples)

    def run(p, z):
        n, s = z.shape
        xyz = o[:, None, :] + d[:, None, :] * z[..., None]
        raw = field.raw(p, xyz.reshape(-1, 3),
                        viewdirs.repeat_interleave(s, dim=0), t)
        return dnerf_raw2outputs(raw.reshape(n, s, 4), z, d, white_bkgd)

    rgb, depth, acc, weights = run(params, z_vals)
    if N_importance > 0:
        z_all = merge_fine_z_vals(z_vals, weights, N_importance, 0.0)
        rgb, depth, acc, _ = run(params_fine or params, z_all)
    return {"rgb": rgb, "depth": depth, "opacity": acc}


# ---- torch checkpoint interop ----


def _tl(sd: dict, prefix: str) -> dict:
    out = {"w": np.asarray(sd[f"{prefix}.weight"], np.float32).T}
    if f"{prefix}.bias" in sd:
        out["b"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return out


def dnerf_params_from_torch(sd: dict, depth: int = 8) -> dict:
    """A reference DirectTemporalNeRF state dict (`_occ.*`, `_time.*`,
    `_time_out`) -> the DNeRFField parameter tree, as numpy arrays."""
    sd = {k: _cpu(v) for k, v in sd.items()}
    return {
        "pts": [_tl(sd, f"_occ.pts_linears.{i}") for i in range(depth)],
        "views": [_tl(sd, "_occ.views_linears.0")],
        "feature": _tl(sd, "_occ.feature_linear"),
        "alpha": _tl(sd, "_occ.alpha_linear"),
        "rgb": _tl(sd, "_occ.rgb_linear"),
        "time": [_tl(sd, f"_time.{i}") for i in range(depth)],
        "time_out": _tl(sd, "_time_out"),
    }


def dnerf_state_dict(params: dict) -> dict:
    """A DNeRFField parameter tree -> the reference DirectTemporalNeRF
    state dict (CPU tensors, torch's (out, in) weights): the inverse of
    `dnerf_params_from_torch`, for writing a D-NeRF `.tar`."""
    sd = {}

    def put(prefix, lp):
        for key, v in (("weight", np.asarray(_cpu(lp["w"])).T),
                       ("bias", _cpu(lp.get("b")))):
            if v is not None:
                sd[f"{prefix}.{key}"] = torch.from_numpy(
                    np.ascontiguousarray(v, np.float32))

    for i, lp in enumerate(params["pts"]):
        put(f"_occ.pts_linears.{i}", lp)
    put("_occ.views_linears.0", params["views"][0])
    for name in ("feature", "alpha", "rgb"):
        put(f"_occ.{name}_linear", params[name])
    for i, lp in enumerate(params["time"]):
        put(f"_time.{i}", lp)
    put("_time_out", params["time_out"])
    return sd


def _cpu(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def dnerf_params_from_numpy(tree: dict, device="cpu") -> dict:
    """A DNeRFField tree of numpy arrays (the JAX package's parameters
    through `np.asarray`, or `dnerf_params_from_torch`'s) -> fp32 tensors
    on `device`."""
    missing = {"pts", "views", "feature", "alpha", "rgb", "time",
               "time_out"} - set(tree)
    if missing:
        raise KeyError(f"D-NeRF parameters lack {sorted(missing)}")

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return torch.from_numpy(np.array(v, np.float32, copy=True)).to(
            device)

    return conv(tree)


def parse_dnerf_config(path: str) -> dict:
    """Minimal configargparse `config.txt` reader (key = value lines)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if "=" not in line:
                continue
            k, v = [s.strip() for s in line.split("=", 1)]
            if v in ("True", "true"):
                out[k] = True
            elif v in ("False", "false"):
                out[k] = False
            else:
                try:
                    out[k] = int(v)
                except ValueError:
                    try:
                        out[k] = float(v)
                    except ValueError:
                        out[k] = v
    return out


class ObjectRenderer:
    """A guest object's render: `fn(rays (N, 8), frame_time)` -> {"rgb",
    "depth", "opacity"}, with the scene's (translation, scale) as
    `transform`."""

    def __init__(self, fn, transform):
        self.fn = fn
        self.transform = transform

    def __call__(self, rays, frame_time: float) -> dict:
        return self.fn(rays, frame_time)


def make_object_render_fn(model_type: str, ckpt_path: str,
                          transform=((0.0, 0.0, 0.0), 1.0),
                          device="cpu") -> ObjectRenderer:
    """The guest object's renderer for the eval app, its weights on
    `device`: `d_nerf` from a D-NeRF `.tar` (and the `config.txt` beside
    it), `nerf_pl` from a nerf_pl Lightning `.ckpt`."""
    if model_type == "d_nerf":
        dconf = parse_dnerf_config(
            os.path.join(os.path.dirname(ckpt_path), "config.txt"))
        field = DNeRFField(
            depth=dconf.get("netdepth", 8), width=dconf.get("netwidth", 256),
            multires=dconf.get("multires", 10),
            multires_views=dconf.get("multires_views", 4))
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        params = dnerf_params_from_numpy(dnerf_params_from_torch(
            ckpt["network_fn_state_dict"], field.depth), device)
        params_fine = None
        if ckpt.get("network_fine_state_dict"):
            params_fine = dnerf_params_from_numpy(dnerf_params_from_torch(
                ckpt["network_fine_state_dict"], field.depth), device)
        n_samples = dconf.get("N_samples", 64)
        n_importance = dconf.get("N_importance", 0)

        def fn(rays, frame_time):
            # the app sets near 2, far 6 (reference eval.py:1077)
            rays = rays.clone()
            rays[:, 6] = 2.0
            rays[:, 7] = 6.0
            return dnerf_render(field, params, rays, frame_time, n_samples,
                                n_importance, white_bkgd=True,
                                params_fine=params_fine)
    elif model_type == "nerf_pl":
        from ..render.renderer import RenderSettings, render_rays
        from ..train.checkpoints import load_torch_ckpt
        from .fields import MirrorNeRFField

        field = MirrorNeRFField(predict_normal=False,
                                predict_mirror_mask=False)
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sides = ["coarse"] + (["fine"] if any(
            k.startswith("nerf_fine.") for k in sd.get("state_dict", sd))
            else [])
        like = {s: field.init(torch.Generator().manual_seed(i), device)
                for i, s in enumerate(sides)}
        params = load_torch_ckpt(ckpt_path, like, field)
        # the flagship's eval kernel where it takes the field (on the
        # card; its plain version on the CPU)
        rs = RenderSettings(N_samples=64, N_importance=64, perturb=0.0,
                            noise_std=0.0, test_time=False,
                            compute_normal=False, white_back=True,
                            fine_pass="fine" if "fine" in params else "none",
                            fused_field=field.supports_fused)

        def fn(rays, frame_time):
            res = render_rays(field, params, rays, rs)
            typ = "fine" if "rgb_fine" in res else "coarse"
            return {"rgb": res[f"rgb_{typ}"], "depth": res[f"depth_{typ}"],
                    "opacity": res[f"opacity_{typ}"]}
    else:
        raise ValueError(f"unknown obj_model_type {model_type!r}")
    return ObjectRenderer(fn, transform)
