"""Frequency (sinusoidal) positional encoding (torch counterpart of
`mirror_nerf_tpu/models/embedding.py`).

Output layout, as in the reference `Embedding` and the JAX package: the raw
input, then per frequency f a sin block and a cos block,
[x, sin(f0·x), cos(f0·x), sin(f1·x), cos(f1·x), ...], so N_freqs=10 on a
3-d input gives 63 channels and N_freqs=4 gives 27.

The cos band is computed as the JAX package computes it, sin(f·x + fp32(π/2)),
not cos(f·x): at |f·x| ≈ 4096 (f = 2⁹, |x| ≈ 8) one fp32 ulp of the argument
is 4.9e-4, so the two differ by up to that much in a feature. f·x is an
elementwise product (exact for f = 2ᵏ), never a matmul, which on the card
could run in TF32 and round the positions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def posenc_dim(in_dim: int, n_freqs: int) -> int:
    return in_dim * (1 + 2 * n_freqs)


@functools.lru_cache(maxsize=None)
def _posenc_consts(in_dim: int, n_freqs: int, logscale: bool, device,
                   dtype):
    """Per output column j of the interleaved
    [sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] layout: the input it
    reads (j mod in_dim), its frequency and its phase (0, or fp32(π/2) for a
    cos column: cos(z) = sin(z + π/2)), on `device`."""
    if logscale:
        freqs = 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)
    else:
        freqs = np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs)
    idx = np.tile(np.arange(in_dim), 2 * n_freqs)
    f = np.repeat(freqs, 2 * in_dim).astype(np.float32)
    phase = np.tile(np.repeat(np.float32([0.0, np.pi / 2.0]), in_dim),
                    n_freqs)
    return tuple(torch.from_numpy(a).to(device, t) for a, t in (
        (idx, torch.long), (f, dtype), (phase, dtype)))


def posenc(x: torch.Tensor, n_freqs: int,
           logscale: bool = True) -> torch.Tensor:
    """Embed (..., F) -> (..., F*(1+2*n_freqs)). n_freqs=0 is the identity."""
    if n_freqs == 0:
        return x
    idx, freqs, phase = _posenc_consts(x.shape[-1], n_freqs, logscale,
                                       x.device, x.dtype)
    return torch.cat([x, torch.sin(x[..., idx] * freqs + phase)], dim=-1)
