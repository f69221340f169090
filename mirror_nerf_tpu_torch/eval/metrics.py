"""Image quality metrics (torch counterpart of the JAX package's
`eval/metrics.py`): PSNR and SSIM in numpy, and LPIPS(alex) through
`eval/lpips.py` when a weight file is given (`$LPIPS_WEIGHTS`), else NaN.
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


def lpips(pred: np.ndarray, gt: np.ndarray, weights_path: str = None,
          device="cuda") -> float:
    """LPIPS(alex) (`eval/lpips.py`) on `device`, the card unless the caller
    passes "cpu". Needs the weights on disk (`weights_path` or
    $LPIPS_WEIGHTS); NaN when the file is absent, and NaN with a warning
    when it is unreadable or incompatible (e.g. a torchscript archive): a
    metrics run must not abort on a bad perceptual-weights file. A card
    that is not there raises: the score never moves to the host."""
    import os
    import warnings

    import torch

    from .lpips import lpips_from_file

    weights_path = weights_path or os.environ.get("LPIPS_WEIGHTS", "")
    if not weights_path or not os.path.exists(weights_path):
        return float("nan")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("LPIPS on the card needs CUDA; pass device='cpu' "
                           "to score on the host")
    try:
        return lpips_from_file(pred, gt, weights_path, device)
    except Exception as e:  # noqa: BLE001 - incompatible/corrupt weights
        warnings.warn(f"LPIPS weights unusable ({type(e).__name__}: {e}); "
                      "reporting NaN")
        return float("nan")
