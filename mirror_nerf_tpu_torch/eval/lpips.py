"""LPIPS(alex) perceptual distance, forward pass in PyTorch (torch
counterpart of `mirror_nerf_tpu/eval/lpips_jax.py`; the reference's
`lpips.LPIPS(net="alex")`, Zhang et al. 2018).

Inputs in [-1, 1] are channel-shifted and scaled, pushed through the
torchvision-AlexNet feature stack (five convolutions, two 3×3/stride-2 max
pools), and the five post-ReLU taps are unit-normalized over channels,
squared-differenced, weighted by the learned non-negative 1×1 "lin"
weights, averaged over space and summed.

The pretrained weights are not in the repository and cannot be fetched, so
the score needs a weight file (`lpips_from_file`'s path or
`$LPIPS_WEIGHTS`) in one of the JAX package's two layouts:

- ``.npz`` with ``conv{i}/w`` (OIHW), ``conv{i}/b`` for i in 0..4 and
  ``lin{i}/w`` (1-D, the tap's channels);
- a torch ``.pt``/``.pth`` state dict holding torchvision AlexNet keys
  (``features.{0,3,6,8,10}.weight/bias``, any prefix) and the lpips
  package's ``lin{i}.model.1.weight`` (or ``lins.{i}.model.1.weight``).

The convolutions and pools are `torch.nn.functional.conv2d` / `max_pool2d`
(the JAX package computes them with XLA's convolution, no Pallas kernel).
They run in fp32 whatever the caller's backend flags: cuDNN would take its
convolutions in TF32 by default (`torch.backends.cudnn.allow_tf32`), ~1e-3
from fp32, so the forward pins it off. Weights are cached per (path,
device). The score runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet feature stack: (out_ch, kernel, stride, pad), with a
# 3x3/stride-2 max pool before stages 1 and 2
_ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_BEFORE = (1, 2)

# LPIPS ScalingLayer constants (inputs in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_weights(path: str) -> dict:
    """{conv{i}/w, conv{i}/b, lin{i}/w} as float32 numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(data[k], np.float32) for k in data.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()
          if hasattr(v, "shape")}
    out = {}
    for i, fi in enumerate((0, 3, 6, 8, 10)):
        for kind in ("weight", "bias"):
            matches = [v for k, v in sd.items()
                       if k.endswith(f"features.{fi}.{kind}")]
            if not matches:
                raise KeyError(f"missing AlexNet features.{fi}.{kind}")
            out[f"conv{i}/{'w' if kind == 'weight' else 'b'}"] = matches[0]
    for i in range(5):
        matches = [v for k, v in sd.items()
                   if k.endswith(f"lin{i}.model.1.weight")
                   or k.endswith(f"lins.{i}.model.1.weight")]
        if not matches:
            raise KeyError(f"missing lpips lin{i} weight")
        out[f"lin{i}/w"] = matches[0].reshape(-1)
    return out


def weights_to(weights: dict, device) -> dict:
    """The weight arrays as fp32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in weights.items()}


def _alex_taps(w: dict, x: torch.Tensor) -> list:
    """x: (N, 3, H, W) in [-1, 1] -> the five post-ReLU feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    taps = []
    for i, (_, _, s, p) in enumerate(_ALEX):
        if i in _POOL_BEFORE:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
        h = F.relu(F.conv2d(h, w[f"conv{i}/w"], w[f"conv{i}/b"], stride=s,
                            padding=p))
        taps.append(h)
    return taps


def lpips_forward(weights: dict, img0, img1) -> float:
    """LPIPS distance between (H, W, 3) images in [0, 1]; `weights` as
    `weights_to` gives them (the images go to their device)."""
    dev = weights["conv0/w"].device

    def prep(im):
        a = torch.as_tensor(np.asarray(im, np.float32) if not isinstance(
            im, torch.Tensor) else im, dtype=torch.float32, device=dev)
        if a.dim() == 3:
            a = a[None]
        return a.permute(0, 3, 1, 2) * 2.0 - 1.0

    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False,
            allow_tf32=False):
        t0 = _alex_taps(weights, prep(img0))
        t1 = _alex_taps(weights, prep(img1))
        total = 0.0
        for i, (f0, f1) in enumerate(zip(t0, t1)):
            n0 = f0 / torch.sqrt(torch.sum(f0 ** 2, dim=1, keepdim=True)
                                 + 1e-10)
            n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, dim=1, keepdim=True)
                                 + 1e-10)
            lin = weights[f"lin{i}/w"].view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((n0 - n1) ** 2 * lin,
                                                 dim=1), dim=(1, 2))
    return float(total[0])


_CACHE: dict = {}


def lpips_from_file(img0, img1, weights_path: str = None,
                    device="cuda") -> float:
    """LPIPS(alex) given a weight file (`weights_path` or $LPIPS_WEIGHTS),
    on `device`; NaN when no weight file is there."""
    weights_path = weights_path or os.environ.get("LPIPS_WEIGHTS", "")
    if not weights_path or not os.path.exists(weights_path):
        return float("nan")
    key = (os.path.abspath(weights_path), str(torch.device(device)))
    if key not in _CACHE:
        _CACHE[key] = weights_to(load_weights(weights_path), device)
    return lpips_forward(_CACHE[key], img0, img1)
