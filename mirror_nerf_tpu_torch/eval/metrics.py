"""Image quality metrics: PSNR and SSIM (numpy; a copy of the JAX
package's `eval/metrics.py`). Still unported (ROADMAP.md queue 1, item 5):
the LPIPS forward (`eval/lpips_jax.py`; its pretrained weights are not in
the repository), with the rest of item 5 (visualization's remainder,
profiling, `native.py`, SH degrees 5–8).
"""

from __future__ import annotations

import numpy as np


def mse(pred: np.ndarray, gt: np.ndarray, valid_mask=None) -> float:
    se = (np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2
    if valid_mask is not None:
        se = se[valid_mask]
    return float(np.mean(se))


def psnr(pred: np.ndarray, gt: np.ndarray, valid_mask=None) -> float:
    return float(-10.0 * np.log10(mse(pred, gt, valid_mask)))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution over the leading two axes of (H, W, C)."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(k)
    v = sliding_window_view(img, n, axis=0)  # (H-n+1, W, C, n)
    v = np.tensordot(v, k, axes=([-1], [0]))
    v = sliding_window_view(v, n, axis=1)  # (H-n+1, W-n+1, C, n)
    return np.tensordot(v, k, axes=([-1], [0]))


def ssim(pred: np.ndarray, gt: np.ndarray, window: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> float:
    """Mean SSIM over an (H, W, 3) image pair (Wang et al. 2004)."""
    p = np.asarray(pred, np.float64)
    g = np.asarray(gt, np.float64)
    if p.ndim == 2:
        p, g = p[..., None], g[..., None]
    k = _gaussian_kernel(window, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p = _filter2d_sep(p, k)
    mu_g = _filter2d_sep(g, k)
    mu_pp = _filter2d_sep(p * p, k)
    mu_gg = _filter2d_sep(g * g, k)
    mu_pg = _filter2d_sep(p * g, k)
    var_p = mu_pp - mu_p ** 2
    var_g = mu_gg - mu_g ** 2
    cov = mu_pg - mu_p * mu_g
    num = (2 * mu_p * mu_g + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2)
    return float(np.mean(num / den))
