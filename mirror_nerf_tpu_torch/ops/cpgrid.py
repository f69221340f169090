"""CP-factorized multiscale feature grid (torch counterpart of
`mirror_nerf_tpu/ops/cpgrid.py`).

Per axis a dense 1-D table A_axis ∈ (G, R) per scale; the feature of a point
is the rank-wise product of three linearly interpolated rows, the scales'
ranks concatenated and folded to `n_features` by a dense matmul. The lookup
is the paired-gather lerp (`_lerp_rows`); on a GPU a gather is the natural
primitive, so the JAX package's hat-basis matmul form is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class CPGridSpec:
    # (resolution, rank) per scale; ranks concatenate before the fold matmul
    levels: Tuple[Tuple[int, int], ...] = ((64, 64), (256, 64), (512, 64))
    n_features: int = 32
    input_dim: int = 3

    @property
    def total_rank(self) -> int:
        return sum(r for _, r in self.levels)

    @property
    def output_dim(self) -> int:
        return self.n_features


def init_cpgrid(generator: Optional[torch.Generator], spec: CPGridSpec,
                device="cpu") -> dict:
    """axes[a][l]: (G_l, R_l) tables near 1 (product identity) with 0.1-scale
    normal noise; fold: (ΣR, F) uniform ±1/sqrt(ΣR)."""
    axes = []
    for _ in range(spec.input_dim):
        tables = []
        for (g, r) in spec.levels:
            noise = torch.randn((g, r), generator=generator) * 0.1
            tables.append((1.0 + noise).to(device))
        axes.append(tables)
    bound = 1.0 / (spec.total_rank ** 0.5)
    u = torch.rand((spec.total_rank, spec.n_features), generator=generator)
    return {"axes": axes, "fold": ((u * 2.0 - 1.0) * bound).to(device)}


def _lerp_rows(table: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """Linearly interpolated rows of a (G, R) table at x01 ∈ [0,1]: (N, R).
    Inputs are clamped to [0, 1]; the left index is min(floor, G-2)."""
    g = table.shape[0]
    xf = torch.clamp(x01, 0.0, 1.0) * (g - 1)
    xi = torch.clamp_max(torch.floor(xf).to(torch.int64), g - 2)
    w = (xf - xi.to(xf.dtype))[:, None]
    a = table[xi]
    b = table[xi + 1]
    return a * (1.0 - w) + b * w


def cpgrid_encode(params: dict, x01: torch.Tensor,
                  spec: CPGridSpec) -> torch.Tensor:
    """(N, input_dim) in [0,1] -> (N, n_features)."""
    per_level = []
    for li in range(len(spec.levels)):
        prod = None
        for a in range(spec.input_dim):
            rows = _lerp_rows(params["axes"][a][li], x01[:, a])
            prod = rows if prod is None else prod * rows
        per_level.append(prod)
    feats = torch.cat(per_level, dim=-1)
    return feats @ params["fold"]
