"""Encoder factory (torch counterpart of `mirror_nerf_tpu/models/encoding.py`;
the reference's `models/encoding.py`).

`get_encoder(name)` returns `(encoder, output_dim)` for the names the
reference factory dispatches on: None / frequency / sphere_harmonics /
hashgrid / tiledgrid, with the JAX package's output dims. Frequency and SH
encoders are plain functions (`ops/sh.py` takes degrees 1..8); the grid
encoders are `GridEncoder`s, which hold the static `HashGridSpec`, make
their tables with `init(generator)` and encode world coordinates in
[-bound, bound] through the port's `hashgrid_encode`: on the card ENCODE,
with BWD and BWD2 as its backward (x01 = (x + bound)·fp32(1/(2·bound)), as
`NGPField` takes it). ENCODE takes 3-d inputs, 2 features a
level, align_corners=False and linear interpolation; any other spec raises
on the card (ROADMAP.md queue 1, item 15) and runs on the CPU through the
plain version, differentiable by autograd, as the JAX package runs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.hashgrid import (HashGridSpec, hashgrid_encode,
                            hashgrid_encode_reference, init_hashgrid)
from ..ops.sh import sh_encode
from .embedding import posenc, posenc_dim


def kernel_takes(spec: HashGridSpec) -> bool:
    """Whether ENCODE, BWD and BWD2 take the spec."""
    return (spec.input_dim == 3 and spec.level_dim == 2
            and not spec.align_corners and spec.interpolation == "linear")


@dataclass(frozen=True)
class GridEncoder:
    spec: HashGridSpec

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> torch.Tensor:
        return init_hashgrid(generator, self.spec, device)

    def __call__(self, table: torch.Tensor, x: torch.Tensor,
                 bound: float = 1.0) -> torch.Tensor:
        # × the fp32 reciprocal of 2·bound, as PyTorch divides a CUDA tensor
        # by a scalar: every device puts a point in the same cell
        x01 = (x + bound) * float(np.float32(1.0) / np.float32(2.0 * bound))
        if kernel_takes(self.spec):
            return hashgrid_encode(table, x01, self.spec)
        if x01.is_cuda or table.is_cuda:
            raise NotImplementedError(
                f"the hash-grid kernel has no mode for {self.spec} (it "
                "takes 3-d inputs, 2 features a level, align_corners=False "
                "and linear interpolation): ROADMAP.md queue 1, item 15. "
                "The CPU runs it through the plain version")
        return hashgrid_encode_reference(table, x01, self.spec)


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    multires: int = 6,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    align_corners: bool = False,
    **kwargs,
):
    if encoding == "None":
        return (lambda x, **kw: x), input_dim

    if encoding == "frequency":
        def freq(x, **kw):
            return posenc(x, multires)

        return freq, posenc_dim(input_dim, multires)

    if encoding == "sphere_harmonics":
        def sh(x, **kw):
            return sh_encode(x, degree)

        return sh, degree ** 2

    if encoding in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners,
        )
        enc = GridEncoder(spec)
        return enc, enc.output_dim

    raise NotImplementedError(
        "Unknown encoding mode, choose from "
        "[None, frequency, sphere_harmonics, hashgrid, tiledgrid]")
