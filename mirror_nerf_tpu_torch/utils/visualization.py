"""Depth visualization (numpy + cv2; the JAX package's
`utils/visualization.visualize_depth`)."""

from __future__ import annotations

import numpy as np


def visualize_depth(depth: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) float RGB in [0, 1], JET colormap."""
    import cv2

    x = np.nan_to_num(depth.astype(np.float32))
    mi = np.min(x) if vmin is None else vmin
    ma = np.max(x) if vmax is None else vmax
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0, 1)).astype(np.uint8)
    colored = cv2.applyColorMap(x, cv2.COLORMAP_JET)
    return cv2.cvtColor(colored, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
