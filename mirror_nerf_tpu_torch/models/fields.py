"""Field models (torch counterpart of `mirror_nerf_tpu/models/fields.py`).

`MirrorNeRFField` is the flagship PE-MLP (`--model_type nerf`), the
reference's default model: an 8×256 trunk on the positional encoding with a
skip at layer 4 ([posenc, h] concatenated, posenc first), a raw-σ head, a
view-conditioned RGB head (xyz_final → [·, posenc(dir)] → dir_enc ReLU →
rgb sigmoid), a two-linear normal head with no activation between, and a
mirror head (linear, LeakyReLU(0.01), linear, sigmoid). Its parameters are
a dict of tensors with the JAX package's leaf names and (in, out) layout, so
an npz written by either package loads in the other.

With `compute_dtype="bfloat16"` (`--compute_dtype bfloat16`) it casts as
the JAX field's `_cast` and `_lin` do: the posenc, weights and biases in
bf16, so every product, bias and activation of the trunk and heads rounds to
bf16; σ, rgb, the normal and the mirror probability come back fp32, the
trunk feature that `density` returns stays bf16; the rgb and each head's
last linear leave their bias add unrounded, as XLA does right before a cast
(`linear_out`), while σ, sliced before its cast, rounds as any bf16 linear.
The parameters stay fp32.

`make_field` builds it, the hash-grid model (`nerf_tcnn`, models/ngp.py)
or the CP-grid model (`nerf_tpu`, models/tpugrid.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops._dtype import cast, compute_dtype
from .embedding import posenc, posenc_dim
from .ngp import NGPField
from .nn import init_linear, leaky_relu, linear, linear_out, relu, sigmoid
from .tpugrid import TPUGridField


# the widest trunk the rows kernel on the tensor cores takes
# (csrc/fused_mlp_rows_tc.cu: 8 CTAs × 8 parts of 64 columns)
FUSED_TC_MAX_WIDTH = 4096


@dataclass(frozen=True)
class MirrorNeRFField:
    N_emb_xyz: int = 10
    N_emb_dir: int = 4
    depth: int = 8
    width: int = 256
    skips: Tuple[int, ...] = (4,)
    predict_normal: bool = True
    predict_mirror_mask: bool = True
    compute_dtype: str = "float32"

    @property
    def in_xyz(self) -> int:
        return posenc_dim(3, self.N_emb_xyz)

    @property
    def in_dir(self) -> int:
        return posenc_dim(3, self.N_emb_dir)

    @property
    def supports_fused(self) -> bool:
        """Whether the per-sample rows kernels (ops/fused_mlp.py) take this
        architecture, the JAX property's range: a width that is a multiple
        of 128, any depth and skips, at most 20 posenc frequencies each for
        positions and view dirs (≤ 123 rows, the JAX kernel's 128 lanes),
        with or without the normal and the mirror head. Up to width
        FUSED_TC_MAX_WIDTH they run on csrc/fused_mlp_rows_tc.cu
        (`supports_fused_tc`), wider ones on the layer-major GEMMs of
        csrc/fused_mlp_layers.cu (ops/fused_mlp.py `rows_route`). With
        `--fused_field` on the card, a field outside this set raises
        (render/renderer.py)."""
        return (self.width > 0 and self.width % 128 == 0 and self.depth >= 1
                and 0 <= self.N_emb_xyz <= 20 and 0 <= self.N_emb_dir <= 20)

    @property
    def supports_fused_t(self) -> bool:
        """Whether the composite kernel csrc/fused_mlp_t.cu takes this
        architecture: the default trunk — width 256,
        depth 8, the skip at layer 4 — within `supports_fused`. Another
        trunk's noise-free passes take the rows kernel and composite
        outside it, JAX's `_inference_fused` route."""
        return (self.supports_fused and self.width == 256
                and self.depth == 8 and tuple(self.skips) == (4,))

    @property
    def supports_fused_tc(self) -> bool:
        """Whether the rows kernel on the tensor cores,
        csrc/fused_mlp_rows_tc.cu, takes this architecture: a width up to
        FUSED_TC_MAX_WIDTH within `supports_fused` (128, 256, 384 and 512
        its template instances, wider ones its cluster instance), any
        depth and skips, the default trunk included. It is the rows route
        of these widths; wider trunks take the layer-major kernel
        csrc/fused_mlp_layers.cu."""
        return self.supports_fused and self.width <= FUSED_TC_MAX_WIDTH

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

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return cast(x, compute_dtype(self.compute_dtype))

    def _lin(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return linear(p, x, compute_dtype(self.compute_dtype))

    def _lin_out(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """A head's last linear, fp32 out (`linear_out`)."""
        return linear_out(p, x, compute_dtype(self.compute_dtype))

    def density(self, params: dict, xyz: torch.Tensor):
        """(N, 3) raw world coords -> (σ raw (N,), trunk features (N, W) in
        the compute dtype)."""
        h0 = self._cast(posenc(xyz, self.N_emb_xyz))
        h = h0
        for i, layer in enumerate(params["trunk"]):
            if i in self.skips:
                h = torch.cat([h0, h], dim=-1)
            h = relu(self._lin(layer, h))
        sigma = self._lin(params["sigma"], h)[..., 0]
        return (sigma if self.compute_dtype == "float32" else sigma.float()), h

    def color(self, params: dict, geo_feat: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
        """(N, W) trunk features + (N, 3) view dirs (as given) -> (N, 3)."""
        d = self._cast(posenc(dirs, self.N_emb_dir))
        h = self._lin(params["xyz_final"], self._cast(geo_feat))
        h = relu(self._lin(params["dir_enc"], torch.cat([h, d], dim=-1)))
        return sigmoid(self._lin_out(params["rgb"], h))

    def normal_head(self, params: dict, geo_feat: torch.Tensor):
        """Predicted (unnormalized) normal, (N, 3): two linears, no act."""
        h = self._lin(params["normal"][0], self._cast(geo_feat))
        return self._lin_out(params["normal"][1], h)

    def mirror_head(self, params: dict, geo_feat: torch.Tensor):
        """Per-point mirror probability, (N,)."""
        h = leaky_relu(self._lin(params["is_mirror"][0],
                                 self._cast(geo_feat)))
        return sigmoid(self._lin_out(params["is_mirror"][1], h))[..., 0]


def parse_grid_levels(spec: str):
    """"res:rank,res:rank,..." -> ((res, rank), ...)."""
    return tuple((int(g), int(r))
                 for g, r in (lv.split(":") for lv in spec.split(",") if lv))


def make_field(cfg):
    """Build the field described by a Config (model_type dispatch)."""
    if cfg.model_type not in ("nerf", "nerf_tcnn", "nerf_tpu"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    compute_dtype(cfg.compute_dtype)  # float32 or bfloat16
    if cfg.model_type == "nerf":
        return MirrorNeRFField(
            N_emb_xyz=cfg.N_emb_xyz,
            N_emb_dir=cfg.N_emb_dir,
            predict_normal=cfg.predict_normal,
            predict_mirror_mask=cfg.predict_mirror_mask,
            compute_dtype=cfg.compute_dtype,
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
