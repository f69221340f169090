"""Plain PyTorch reference of Instant-NGP's field as torch-ngp builds it
(Müller et al., SIGGRAPH 2022; torch-ngp's `gridencoder` and `NeRFNetwork`
as the Mirror-NeRF reference vendors them): a multiresolution hash grid of
`n_levels` levels × 2 features, 2^log2_hashmap_size rows a level at most,
base resolution 16, per-level scale exp2(log2(2048·bound/16)/15),
trilinear interpolation with the half-cell offset, torch-ngp's spatial hash
(xor of coordinate × prime, uint32) where a level's dense grid outgrows its
rows, features zero outside [0, 1]³; a 32→64→16 bias-free σ-net (raw σ,
15 geometry features), SH degree 4 of the view direction, a 31→64→64→3
bias-free colour net with a sigmoid, a 15→64→3 normal net and a
15→32→1 mirror net (LeakyReLU 0.01, sigmoid).
"""

from __future__ import annotations

import numpy as np
import torch

from .common import linear, mm
from .weights import linear_tree, uniform

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def _mul32(a: torch.Tensor, p: int) -> torch.Tensor:
    """a·p mod 2³² for a in [0, 2³²), in int64 without overflow."""
    lo, hi = p & 0xFFFF, p >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _MASK32


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 values) of unit d."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    c2, c3 = _SH_C2, _SH_C3
    return torch.stack([
        torch.full_like(x, _SH_C0), -_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x,
        c2[0] * xy, c2[1] * yz, c2[2] * (2.0 * zz - xx - yy), c2[3] * xz,
        c2[4] * (xx - yy),
        c3[0] * y * (3.0 * xx - yy), c3[1] * xy * z,
        c3[2] * y * (4.0 * zz - xx - yy),
        c3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        c3[4] * x * (4.0 * zz - xx - yy), c3[5] * z * (xx - yy),
        c3[6] * x * (xx - 3.0 * yy)], -1)


class Field:
    def __init__(self, spec: dict):
        self.bound = float(spec["bound"])
        self.n_levels = spec["n_levels"]
        self.level_dim = spec["level_dim"]
        self.base = spec["base_resolution"]
        self.log2_rows = spec["log2_hashmap_size"]
        self.hidden = spec["hidden_dim"]
        self.geo = spec["geo_feat_dim"]
        self.hidden_color = spec["hidden_dim_color"]
        self.inv_2b = float(np.float32(1.0) / np.float32(2.0 * self.bound))
        self.levels = self._levels()
        self.rows = sum(lv["size"] for lv in self.levels)

    def _levels(self) -> list:
        """Each level's scale, row offset, rows, whether it hashes, and its
        dense strides (a stride past the level's rows is 0)."""
        log2_scale = float(np.log2(
            np.exp2(np.log2(2048 * self.bound / self.n_levels)
                    / (self.n_levels - 1))))
        out, offset = [], 0
        for lvl in range(self.n_levels):
            scale = float(np.exp2(lvl * log2_scale) * self.base - 1.0)
            side = int(np.ceil(scale)) + 2
            size = min(2 ** self.log2_rows, side ** 3)
            size = int(np.ceil(size / 8) * 8)
            strides, stride = [], 1
            for _ in range(3):
                strides.append(stride if stride <= size else 0)
                stride *= side
            out.append({"scale": scale, "offset": offset, "size": size,
                        "hash": stride > size, "strides": strides})
            offset += size
        return out

    def dense_rows(self) -> int:
        """Rows of the levels that do not hash (the leading ones)."""
        return sum(lv["size"] for lv in self.levels if not lv["hash"])

    def init_params(self, generator: torch.Generator, device) -> dict:
        """Coarse and fine networks: the table U(±1e-4), the nets
        U(±1/√fan_in), each kind drawn on `device` in one call."""
        g = self.geo
        nobias = {net: {"sigma_net": [(32, self.hidden),
                                      (self.hidden, 1 + g)],
                        "color_net": [(16 + g, self.hidden_color),
                                      (self.hidden_color, self.hidden_color),
                                      (self.hidden_color, 3)],
                        "normal": [(g, self.hidden), (self.hidden, 3)]}
                  for net in ("coarse", "fine")}
        biased = {net: {"is_mirror": [(g, self.hidden // 2),
                                      (self.hidden // 2, 1)]}
                  for net in ("coarse", "fine")}
        params = linear_tree(nobias, generator, device, bias=False)
        mirror = linear_tree(biased, generator, device, bias=True)
        tables = uniform((2, self.rows, self.level_dim), 1e-4, generator,
                         device)
        for i, net in enumerate(("coarse", "fine")):
            params[net].update(mirror[net])
            params[net]["grid"] = tables[i].clone()
        return params

    def opaque(self, params: dict, scale: float,
               dense_scale: float) -> dict:
        """σ made opaque: the σ column of the σ-net's last layer |w|·scale,
        the dense levels' rows ×dense_scale (at the ±1e-4 init σ is ~0)."""
        n = self.dense_rows()
        out = {}
        for net, p in params.items():
            q = dict(p)
            w = p["sigma_net"][1]["w"].clone()
            w[:, 0] = w[:, 0].abs() * scale
            q["sigma_net"] = [p["sigma_net"][0], {"w": w}]
            grid = p["grid"].clone()
            grid[:n] *= dense_scale
            q["grid"] = grid
            out[net] = q
        return out

    def encode(self, table: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
        """(N, 3) in [0, 1]³ → (N, 2·levels), zero outside the cube."""
        corners = torch.tensor([[(c >> d) & 1 for d in range(3)]
                                for c in range(8)], device=x01.device)
        feats = []
        for lv in self.levels:
            s = float(np.float32(lv["scale"]))
            pos = (x01.double() * s + 0.5).float()
            pf = torch.floor(pos)
            frac = pos - pf
            cpos = (pf.to(torch.int64)[None] + corners[:, None, :]) & _MASK32
            if lv["hash"]:
                idx = _mul32(cpos[..., 0], _PRIMES[0])
                for d in (1, 2):
                    idx = idx ^ _mul32(cpos[..., d], _PRIMES[d])
            else:
                idx = torch.zeros_like(cpos[..., 0])
                for d, stride in enumerate(lv["strides"]):
                    if stride:
                        idx = (idx + _mul32(cpos[..., d], stride)) & _MASK32
            rows = table[lv["offset"] + idx % lv["size"]]  # (8, N, C)
            f = torch.where(corners[:, None, :] == 1, frac[None],
                            1.0 - frac[None])
            w = (f[..., 0] * f[..., 1]) * f[..., 2]
            feats.append(torch.sum(w[..., None] * rows, 0))
        out = torch.cat(feats, -1)
        oob = torch.any((x01 < 0.0) | (x01 > 1.0), -1, keepdim=True)
        return torch.where(oob, torch.zeros((), device=out.device), out)

    def density(self, p: dict, xyz: torch.Tensor, prec: str):
        h = self.encode(p["grid"], (xyz + self.bound) * self.inv_2b)
        h = torch.clamp_min(mm(h, p["sigma_net"][0]["w"], prec), 0.0)
        h = mm(h, p["sigma_net"][1]["w"], prec)
        return h[..., 0], h[..., 1:]

    def color(self, p: dict, geo, dirs, prec: str):
        h = torch.cat([sh4(dirs), geo], -1)
        for layer in p["color_net"][:-1]:
            h = torch.clamp_min(mm(h, layer["w"], prec), 0.0)
        return torch.sigmoid(mm(h, p["color_net"][-1]["w"], prec))

    def normal(self, p: dict, geo, prec: str):
        h = torch.clamp_min(mm(geo, p["normal"][0]["w"], prec), 0.0)
        return mm(h, p["normal"][1]["w"], prec)

    def mirror_logit(self, p: dict, geo, prec: str):
        h = linear(p["is_mirror"][0], geo, prec)
        h = torch.where(h >= 0, h, 0.01 * h)
        return linear(p["is_mirror"][1], h, prec)[..., 0]

