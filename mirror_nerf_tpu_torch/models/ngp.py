"""NGP-style field: hash-grid encoder + small MLPs + SH direction encoding
(torch counterpart of `mirror_nerf_tpu/models/ngp.py`; `--model_type
nerf_tcnn`).

  * 16-level ×2-feature hash grid, log2_hashmap 19, base 16, per-level scale
    exp2(log2(2048·bound/16)/15) (ops/hashgrid.py; on the card the ENCODE
    mode of csrc/hashgrid.cu, its gradient BWD and BWD2)
  * 2×64 bias-free σ-net → (raw σ, 15-d geo_feat); σ has no activation here
  * SH(degree 4) direction encoding + 3×64 bias-free color net + sigmoid
  * normal net: 2×64 bias-free MLP with interior ReLU (unnormalized output)
  * mirror net: Linear(15,32) + LeakyReLU(0.01) + Linear(32,1) + sigmoid
  * world coords scaled (x + bound)·fp32(1/(2·bound)) before encoding

With `compute_dtype="bfloat16"` the σ-net and the color net run in bf16, as
the JAX field's do: the encoder's fp32 features (ENCODE, BWD and BWD2 keep
fp32 inputs and outputs; autograd's casts carry the gradients back) and the
SH/geo concatenation are cast to bf16, each product and ReLU rounds to
bf16, and the last product of each net comes out fp32 unrounded, as XLA
computes it (`linear_out`): σ, geo and rgb are fp32. The normal and mirror
heads stay fp32.

`supports_fused_hash` says whether the fused NGP composite
(ops/fused_hash.py) takes the field: the renderer's noise-free passes with
`fused_field` then run the whole field and the compositing in one kernel.

The field is a static description; its parameters are a dict of tensors
with the JAX package's leaf names and (in, out) layout (`grid` the flat
(rows, 2) table). `TPUGridField` (models/tpugrid.py) swaps the encoder for
the CP grid. The nets are plain `torch.matmul`, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops._dtype import cast, compute_dtype
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from ..ops.sh import sh_encode
from .nn import (_uniform, init_linear, leaky_relu, linear, linear_out, relu,
                 sigmoid)


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
    def grid_spec(self) -> HashGridSpec:
        n_levels = self.n_levels
        per_level_scale = float(
            np.exp2(np.log2(2048 * self.bound / n_levels) / (n_levels - 1)))
        return HashGridSpec(
            input_dim=3, num_levels=n_levels, level_dim=2,
            base_resolution=16, log2_hashmap_size=self.log2_hashmap_size,
            per_level_scale=per_level_scale,
        )

    @property
    def in_dim(self) -> int:
        return self.grid_spec.output_dim  # 32

    @property
    def fused_nets(self) -> bool:
        """Both heads and the net dims the fused kernels hard-code: σ-net
        →64→16, color 31→64→64→3, normal 15→64→3, mirror 15→32→1, SH4."""
        return (self.predict_normal and self.predict_mirror_mask
                and self.geo_feat_dim == 15 and self.hidden_dim == 64
                and self.num_layers == 2 and self.num_layers_color == 3
                and self.hidden_dim_color == 64 and self.sh_degree == 4)

    @property
    def supports_fused_hash(self) -> bool:
        """The fused NGP composite (ops/fused_hash.py) takes 2-feature
        levels, at most 16 (its K of 32, zero-padded below 16), and
        `fused_nets`; any bound and table size."""
        spec = self.grid_spec
        return (spec.level_dim == 2 and 1 <= spec.num_levels
                and 2 * spec.num_levels <= 32 and self.fused_nets)

    @property
    def inv_2b(self) -> float:
        """fp32(1/(2·bound)): x01 = (x + bound)·inv_2b."""
        return float(np.float32(1.0) / np.float32(2.0 * self.bound))

    @property
    def in_dim_dir(self) -> int:
        return self.sh_degree ** 2  # 16

    def _init_grid(self, generator, device) -> torch.Tensor:
        return init_hashgrid(generator, self.grid_spec, device)

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
        dt = compute_dtype(self.compute_dtype)
        h = cast(h, dt)
        for layer in params["sigma_net"][:-1]:
            h = relu(h @ cast(layer["w"], dt))
        h = linear_out(params["sigma_net"][-1], h, dt)
        return h[..., 0], h[..., 1:]

    def density(self, params: dict, xyz: torch.Tensor, encode=None):
        """Raw world coords in [-bound, bound] → (σ raw, geo_feat);
        `encode` the hash-grid encoder (default `hashgrid_encode`, the
        differentiable encoder: ENCODE on the card, its backward BWD and
        BWD2). x01's chain factor fp32(1/2b) reaches ∂/∂xyz by autograd."""
        # × the fp32 reciprocal of 2·bound, as PyTorch divides a CUDA tensor
        # by a scalar and XLA a traced one by a constant: written out, every
        # device puts a point in the same cell. A point on the +bound face
        # lands at exactly 1.0, in bound: (b + b)·fp32(1/2b) rounds to 1.0
        # for every integer bound 1–32 (ROADMAP.md §3).
        x01 = (xyz + self.bound) * self.inv_2b
        return self._sigma_net(params, (encode or hashgrid_encode)(
            params["grid"], x01, self.grid_spec))

    def color(self, params: dict, geo_feat: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.compute_dtype)
        h = cast(torch.cat([sh_encode(dirs, self.sh_degree), geo_feat],
                           dim=-1), dt)
        for layer in params["color_net"][:-1]:
            h = relu(h @ cast(layer["w"], dt))
        return sigmoid(linear_out(params["color_net"][-1], h, dt))

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
