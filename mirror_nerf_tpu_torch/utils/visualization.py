"""Validation image panels (numpy + cv2; the JAX package's
`utils/visualization.py`): JET-colormapped depth, min-max normalization, the
labeled multi-panel validation grid, and a PIL image writer."""

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


def minmax_norm(x: np.ndarray) -> np.ndarray:
    mi, ma = float(np.min(x)), float(np.max(x))
    return (x - mi) / (ma - mi + 1e-8)


def _label(img: np.ndarray, text: str) -> np.ndarray:
    import cv2

    out = (np.clip(img, 0, 1) * 255).astype(np.uint8).copy()
    cv2.putText(out, text, (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                (255, 255, 255), 1, cv2.LINE_AA)
    return out.astype(np.float32) / 255.0


def visualize_val_image(img_wh, batch: dict, results: dict,
                        add_text: bool = True) -> np.ndarray:
    """Every available panel (GT, renders, reflections, depth, masks,
    normals, surface points) in one (H·rows, W·4, 3) image."""
    w, h = img_wh

    def im(x, c=3):
        x = np.asarray(x)
        return x.reshape(h, w, c) if c == 3 else x.reshape(h, w)

    panels = []

    def add(name, img):
        img = np.clip(np.asarray(img, np.float32), 0, 1)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        panels.append(_label(img, name) if add_text else img)

    if "rgbs" in batch:
        add("GT", im(batch["rgbs"]))
    typ = "fine" if "rgb_fine" in results else "coarse"
    for t in ("fine", "coarse"):
        if f"rgb_{t}" in results:
            add(f"rgb_{t}", im(results[f"rgb_{t}"]))
    for key, name in ((f"rgb_{typ}_reflect", "reflect"),
                      (f"rgb_{typ}_direct", "direct")):
        if key in results:
            add(name, im(results[key]))
    if f"depth_{typ}" in results:
        add("depth", visualize_depth(im(results[f"depth_{typ}"], 1)))
    if f"depth_{typ}_reflect" in results:
        add("depth_reflect",
            visualize_depth(im(results[f"depth_{typ}_reflect"], 1)))
    if "mirror_mask" in batch:
        add("GT mask", np.clip(im(np.asarray(batch["mirror_mask"],
                                             np.float32), 1), 0, 1))
    if f"mirror_mask_{typ}" in results:
        add("pred mask", im(results[f"mirror_mask_{typ}"], 1))
    if f"surface_normal_{typ}" in results:
        add("pred normal", im(results[f"surface_normal_{typ}"]) * 0.5 + 0.5)
    if f"surface_normal_grad_{typ}" in results:
        add("grad normal",
            im(results[f"surface_normal_grad_{typ}"]) * 0.5 + 0.5)
    if "secondary_rays_o" in results:
        add("secondary o", minmax_norm(im(results["secondary_rays_o"])))
    if "reflect_direction" in results:
        add("reflect dir", im(results["reflect_direction"]) * 0.5 + 0.5)
    if f"x_surface_{typ}" in results:
        add("x_surface", minmax_norm(im(results[f"x_surface_{typ}"])))

    cols = 4
    rows = (len(panels) + cols - 1) // cols
    panels += [np.zeros((h, w, 3), np.float32)] * (rows * cols - len(panels))
    return np.concatenate(
        [np.concatenate(panels[r * cols:(r + 1) * cols], axis=1)
         for r in range(rows)], axis=0)


def save_image(path: str, img: np.ndarray) -> None:
    """Write a float image in [0, 1] as an 8-bit PNG (PIL)."""
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
