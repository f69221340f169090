"""Field models (torch counterpart of `mirror_nerf_tpu/models/fields.py`).

`MirrorNeRFField` is the flagship PE-MLP (`--model_type nerf`), the
reference's default model: an 8×256 trunk on the positional encoding with a
skip at layer 4 ([posenc, h] concatenated, posenc first), a raw-σ head, a
view-conditioned RGB head (xyz_final → [·, posenc(dir)] → dir_enc ReLU →
rgb sigmoid), a two-linear normal head with no activation between, and a
mirror head (linear, LeakyReLU(0.01), linear, sigmoid). Its parameters are
a dict of tensors with the JAX package's leaf names and (in, out) layout, so
an npz written by either package loads in the other.

`make_field` builds it, the hash-grid model (`nerf_tcnn`, models/ngp.py)
or the CP-grid model (`nerf_tpu`, models/tpugrid.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .embedding import posenc, posenc_dim
from .ngp import NGPField
from .nn import init_linear, leaky_relu, linear, relu, sigmoid
from .tpugrid import TPUGridField


@dataclass(frozen=True)
class MirrorNeRFField:
    N_emb_xyz: int = 10
    N_emb_dir: int = 4
    depth: int = 8
    width: int = 256
    skips: Tuple[int, ...] = (4,)
    predict_normal: bool = True
    predict_mirror_mask: bool = True

    @property
    def in_xyz(self) -> int:
        return posenc_dim(3, self.N_emb_xyz)

    @property
    def in_dir(self) -> int:
        return posenc_dim(3, self.N_emb_dir)

    @property
    def supports_fused(self) -> bool:
        """Whether the CUDA eval kernel (csrc/fused_mlp_t.cu) takes this
        architecture: the default trunk — width 256, depth 8, the skip at
        layer 4 — with at most 20 posenc frequencies each for positions and
        view dirs (≤ 123 rows, as the JAX kernel's 128 lanes), and with or
        without the normal and the mirror head. (The JAX property accepts
        any width that is a multiple of 128, though its kernel adapter
        always builds the 256-wide spec.) With `--fused_field` on the card,
        a field outside this set raises (render/renderer.py)."""
        return (self.width == 256 and self.depth == 8
                and tuple(self.skips) == (4,)
                and 0 <= self.N_emb_xyz <= 20 and 0 <= self.N_emb_dir <= 20)

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> dict:
        W = self.width

        def lin(i, o):
            return init_linear(generator, i, o, device=device)

        p = {"trunk": [lin(self.in_xyz if i == 0 else
                           (W + self.in_xyz if i in self.skips else W), W)
                       for i in range(self.depth)]}
        p["sigma"] = lin(W, 1)
        p["xyz_final"] = lin(W, W)
        p["dir_enc"] = lin(W + self.in_dir, W // 2)
        p["rgb"] = lin(W // 2, 3)
        if self.predict_normal:
            p["normal"] = [lin(W, W // 2), lin(W // 2, 3)]
        if self.predict_mirror_mask:
            p["is_mirror"] = [lin(W, W // 2), lin(W // 2, 1)]
        return p

    def density(self, params: dict, xyz: torch.Tensor):
        """(N, 3) raw world coords -> (σ raw (N,), trunk features (N, W))."""
        h0 = posenc(xyz, self.N_emb_xyz)
        h = h0
        for i, layer in enumerate(params["trunk"]):
            if i in self.skips:
                h = torch.cat([h0, h], dim=-1)
            h = relu(linear(layer, h))
        return linear(params["sigma"], h)[..., 0], h

    def color(self, params: dict, geo_feat: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
        """(N, W) trunk features + (N, 3) view dirs (as given) -> (N, 3)."""
        d = posenc(dirs, self.N_emb_dir)
        h = linear(params["xyz_final"], geo_feat)
        h = relu(linear(params["dir_enc"], torch.cat([h, d], dim=-1)))
        return sigmoid(linear(params["rgb"], h))

    def normal_head(self, params: dict, geo_feat: torch.Tensor):
        """Predicted (unnormalized) normal, (N, 3): two linears, no act."""
        return linear(params["normal"][1],
                      linear(params["normal"][0], geo_feat))

    def mirror_head(self, params: dict, geo_feat: torch.Tensor):
        """Per-point mirror probability, (N,)."""
        h = leaky_relu(linear(params["is_mirror"][0], geo_feat))
        return sigmoid(linear(params["is_mirror"][1], h))[..., 0]


def parse_grid_levels(spec: str):
    """"res:rank,res:rank,..." -> ((res, rank), ...)."""
    return tuple((int(g), int(r))
                 for g, r in (lv.split(":") for lv in spec.split(",") if lv))


def make_field(cfg):
    """Build the field described by a Config (model_type dispatch)."""
    if cfg.model_type not in ("nerf", "nerf_tcnn", "nerf_tpu"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the port computes in float32 only; bf16 comes with the faster "
            "kernels of ROADMAP.md queue 2")
    if cfg.model_type == "nerf":
        return MirrorNeRFField(
            N_emb_xyz=cfg.N_emb_xyz,
            N_emb_dir=cfg.N_emb_dir,
            predict_normal=cfg.predict_normal,
            predict_mirror_mask=cfg.predict_mirror_mask,
        )
    if cfg.model_type == "nerf_tcnn":
        return NGPField(
            bound=cfg.bound,
            predict_normal=cfg.predict_normal,
            predict_mirror_mask=cfg.predict_mirror_mask,
            compute_dtype=cfg.compute_dtype,
            log2_hashmap_size=cfg.log2_hashmap_size,
        )
    return TPUGridField(
        bound=cfg.bound,
        predict_normal=cfg.predict_normal,
        predict_mirror_mask=cfg.predict_mirror_mask,
        compute_dtype=cfg.compute_dtype,
        grid_levels=parse_grid_levels(cfg.grid_levels),
    )
