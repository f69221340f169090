"""NGP-style field heads (torch counterpart of `mirror_nerf_tpu/models/ngp.py`).

  * 2×64 bias-free σ-net → (raw σ, 15-d geo_feat); σ has no activation here
  * SH(degree 4) direction encoding + 3×64 bias-free color net + sigmoid
  * normal net: 2×64 bias-free MLP with interior ReLU (unnormalized output)
  * mirror net: Linear(15,32) + LeakyReLU(0.01) + Linear(32,1) + sigmoid

The field is a static description; its parameters are a dict of tensors
with the JAX package's leaf names and (in, out) layout. The hash-grid
encoder itself is not ported yet, so `NGPField.density` raises;
`TPUGridField` (models/tpugrid.py) supplies the CP-grid encoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.sh import sh_encode
from .nn import _uniform, init_linear, leaky_relu, linear, relu, sigmoid

_HASHGRID_TODO = ("the hash-grid encoder (nerf_tcnn) is not ported yet: "
                  "ROADMAP.md queue 1, item 4 (hash-grid model)")


def _init_linear_nobias(generator, in_dim, out_dim, device) -> dict:
    # torch nn.Linear(bias=False) default init: U(±1/sqrt(in))
    return {"w": _uniform((in_dim, out_dim), 1.0 / (in_dim ** 0.5),
                          generator, device)}


@dataclass(frozen=True)
class NGPField:
    bound: float = 1.0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    log2_hashmap_size: int = 19
    n_levels: int = 16
    predict_normal: bool = True
    predict_mirror_mask: bool = True
    compute_dtype: str = "float32"

    @property
    def in_dim(self) -> int:
        return 32

    @property
    def in_dim_dir(self) -> int:
        return self.sh_degree ** 2  # 16

    def _init_grid(self, generator, device) -> dict:
        raise NotImplementedError(_HASHGRID_TODO)

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> dict:
        p = {"grid": self._init_grid(generator, device)}
        dims = [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [
            1 + self.geo_feat_dim]
        p["sigma_net"] = [
            _init_linear_nobias(generator, dims[i], dims[i + 1], device)
            for i in range(self.num_layers)
        ]
        cdims = [self.in_dim_dir + self.geo_feat_dim] + [
            self.hidden_dim_color] * (self.num_layers_color - 1) + [3]
        p["color_net"] = [
            _init_linear_nobias(generator, cdims[i], cdims[i + 1], device)
            for i in range(self.num_layers_color)
        ]
        if self.predict_normal:
            ndims = [self.geo_feat_dim] + [self.hidden_dim] * (
                self.num_layers - 1) + [3]
            p["normal"] = [
                _init_linear_nobias(generator, ndims[i], ndims[i + 1], device)
                for i in range(self.num_layers)
            ]
        if self.predict_mirror_mask:
            p["is_mirror"] = [
                init_linear(generator, self.geo_feat_dim,
                            self.hidden_dim // 2, device=device),
                init_linear(generator, self.hidden_dim // 2, 1,
                            device=device),
            ]
        return p

    # ---- forward pieces (Field protocol) ----

    def _sigma_net(self, params: dict, h: torch.Tensor):
        for i, layer in enumerate(params["sigma_net"]):
            h = h @ layer["w"]
            if i != self.num_layers - 1:
                h = relu(h)
        return h[..., 0], h[..., 1:]

    def density(self, params: dict, xyz: torch.Tensor):
        """Raw world coords in [-bound, bound] → (σ raw, geo_feat)."""
        raise NotImplementedError(_HASHGRID_TODO)

    def color(self, params: dict, geo_feat: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
        h = torch.cat([sh_encode(dirs, self.sh_degree), geo_feat], dim=-1)
        for i, layer in enumerate(params["color_net"]):
            h = h @ layer["w"]
            if i != self.num_layers_color - 1:
                h = relu(h)
        return sigmoid(h)

    def normal_head(self, params: dict, geo_feat: torch.Tensor):
        h = geo_feat
        for i, layer in enumerate(params["normal"]):
            h = h @ layer["w"]
            if i != self.num_layers - 1:
                h = relu(h)
        return h

    def mirror_head(self, params: dict, geo_feat: torch.Tensor):
        h = leaky_relu(linear(params["is_mirror"][0], geo_feat))
        return sigmoid(linear(params["is_mirror"][1], h))[..., 0]
