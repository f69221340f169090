"""Plain PyTorch reference of the Mirror-NeRF paper's field (Zeng et al.,
ACM MM 2023; the reference implementation's `models/mirror_nerf.py`):
posenc 10 / 4, an 8×256 ReLU trunk with the encoding concatenated before
layer 4, a raw-σ head, xyz_final → [·, posenc(dir)] → 128 ReLU → rgb
sigmoid, a two-linear normal head, and a mirror head (linear, LeakyReLU
0.01, linear, sigmoid). Linear layers are {"w": (in, out), "b": (out,)}.
"""

from __future__ import annotations

import torch

from .common import linear, posenc
from .weights import linear_tree


class Field:
    def __init__(self, spec: dict):
        self.n_xyz = spec["N_emb_xyz"]
        self.n_dir = spec["N_emb_dir"]
        self.depth = spec["depth"]
        self.width = spec["width"]
        self.skips = tuple(spec["skips"])

    @property
    def in_xyz(self) -> int:
        return 3 * (1 + 2 * self.n_xyz)

    @property
    def in_dir(self) -> int:
        return 3 * (1 + 2 * self.n_dir)

    def shapes(self) -> dict:
        """The parameter tree of one network: each linear (in, out)."""
        w = self.width
        return {"trunk": [(self.in_xyz if i == 0 else
                           (w + self.in_xyz if i in self.skips else w), w)
                          for i in range(self.depth)],
                "sigma": (w, 1), "xyz_final": (w, w),
                "dir_enc": (w + self.in_dir, w // 2), "rgb": (w // 2, 3),
                "normal": [(w, w // 2), (w // 2, 3)],
                "is_mirror": [(w, w // 2), (w // 2, 1)]}

    def init_params(self, generator: torch.Generator, device) -> dict:
        """Coarse and fine networks, every linear U(±1/√fan_in), drawn on
        `device` in one call."""
        return linear_tree({"coarse": self.shapes(), "fine": self.shapes()},
                           generator, device, bias=True)

    def opaque(self, params: dict, scale: float) -> dict:
        """σ made opaque: the σ head's weights |w|·scale."""
        out = {}
        for net, p in params.items():
            q = dict(p)
            q["sigma"] = {"w": p["sigma"]["w"].abs() * scale,
                          "b": p["sigma"]["b"]}
            out[net] = q
        return out

    def density(self, p: dict, xyz: torch.Tensor, prec: str):
        h0 = posenc(xyz, self.n_xyz)
        h = h0
        for i, layer in enumerate(p["trunk"]):
            if i in self.skips:
                h = torch.cat([h0, h], -1)
            h = torch.clamp_min(linear(layer, h, prec), 0.0)
        return linear(p["sigma"], h, prec)[..., 0], h

    def color(self, p: dict, geo, dirs, prec: str):
        h = linear(p["xyz_final"], geo, prec)
        h = torch.cat([h, posenc(dirs, self.n_dir)], -1)
        h = torch.clamp_min(linear(p["dir_enc"], h, prec), 0.0)
        return torch.sigmoid(linear(p["rgb"], h, prec))

    def normal(self, p: dict, geo, prec: str):
        return linear(p["normal"][1], linear(p["normal"][0], geo, prec),
                      prec)

    def mirror_logit(self, p: dict, geo, prec: str):
        h = linear(p["is_mirror"][0], geo, prec)
        h = torch.where(h >= 0, h, 0.01 * h)
        return linear(p["is_mirror"][1], h, prec)[..., 0]
