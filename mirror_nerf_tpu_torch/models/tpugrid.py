"""CP-grid field: CP-factorized grid encoder + the NGP heads (torch
counterpart of `mirror_nerf_tpu/models/tpugrid.py`; `--model_type
nerf_tpu`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.cpgrid import CPGridSpec, cpgrid_encode, init_cpgrid
from .ngp import NGPField


@dataclass(frozen=True)
class TPUGridField(NGPField):
    # (resolution, rank) per scale
    grid_levels: Tuple[Tuple[int, int], ...] = ((64, 64), (256, 64),
                                                (512, 64))

    @property
    def cp_spec(self) -> CPGridSpec:
        return CPGridSpec(levels=self.grid_levels, n_features=32)

    @property
    def supports_fused_cp(self) -> bool:
        """The fused composite kernel (ops/fused_cp.py) hard-codes these
        net dims; other dims take the unfused path."""
        return self.fused_nets

    @property
    def supports_fused_hash(self) -> bool:
        """No hash grid: the renderer's hash route never takes this field."""
        return False

    @property
    def supports_fused_train(self) -> bool:
        """The fused density + ∇σ kernels (ops/fused_cp_train.py) hard-code
        the 2-layer, 64-wide σ-net with 15 geo features; any grid levels
        and bound work."""
        return (self.num_layers == 2 and self.hidden_dim == 64
                and self.geo_feat_dim == 15)

    @property
    def in_dim(self) -> int:
        return self.cp_spec.output_dim  # 32

    def _init_grid(self, generator, device) -> dict:
        return init_cpgrid(generator, self.cp_spec, device)

    def density(self, params: dict, xyz: torch.Tensor):
        """Raw world coords in [-bound, bound] → (σ raw, geo_feat)."""
        # × the fp32 reciprocal of 2·bound, which is how PyTorch divides a
        # CUDA tensor by a scalar: written out, the CPU (which would divide)
        # puts every sample in the same grid cell as the card and as the
        # train kernel. ∇σ jumps across cell boundaries, so a sample within
        # an ulp of a node must not switch cells between devices.
        x01 = (xyz + self.bound) * self.inv_2b
        return self._sigma_net(params,
                               cpgrid_encode(params["grid"], x01,
                                             self.cp_spec))
