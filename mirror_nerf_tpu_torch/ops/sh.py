"""Real spherical-harmonics direction encoding (torch counterpart of
`mirror_nerf_tpu/ops/sh.py`; same constants, index layout and polynomials):
output dim degree², unit directions in, degrees 1..8. Degrees 1..4 (the
models' degree 4) are closed forms; 5..8 come from the associated-Legendre
recurrence, a fixed polynomial for each degree whose constants are computed
once (real SH with the Condon–Shortley phase, the reference CUDA encoder's
table). Backward is autograd."""

from __future__ import annotations

import functools
import math

import torch

_C0 = 0.28209479177387814  # 1/(2 sqrt(pi))
_C1 = 0.4886025119029199  # sqrt(3)/(2 sqrt(pi))
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


@functools.lru_cache(maxsize=None)
def _recurrence_plan(degree: int):
    """The recurrence's constants for `degree`, fixed once: for each order
    m, ~P_m^m = (−1)^m (2m−1)!!, and for each l ≥ m the scale K_l^m =
    sqrt((2l+1)/(4π) · (l−m)!/(l+m)!) (×√2 for m > 0)."""
    plan = []
    for m in range(degree):
        pmm = float((-1) ** m) * float(math.prod(range(1, 2 * m, 2)) or 1)
        ks = [math.sqrt((2 * l + 1) / (4.0 * math.pi)
                        * math.factorial(l - m) / math.factorial(l + m))
              * (math.sqrt(2.0) if m else 1.0) for l in range(m, degree)]
        plan.append((pmm, tuple(ks)))
    return tuple(plan)


def _sh_recurrence(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH of any degree by the associated-Legendre recurrence, in the
    JAX package's order of operations:
      A_m + i B_m = (x + iy)^m,  ~P_{m+1}^m = (2m+1) z ~P_m^m,
      ~P_l^m = ((2l−1) z ~P_{l−1}^m − (l+m−1) ~P_{l−2}^m) / (l−m),
    Y[l²+l±m] = √2 K_l^m ~P_l^m {A_m, B_m}, Y[l²+l] = K_l^0 ~P_l^0."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(x)
    a, b = [one], [torch.zeros_like(x)]
    for m in range(1, degree):  # (x + iy)^m
        a.append(x * a[m - 1] - y * b[m - 1])
        b.append(x * b[m - 1] + y * a[m - 1])
    out = [None] * (degree * degree)
    for m, (pmm, ks) in enumerate(_recurrence_plan(degree)):
        p_lm1 = p_l = None  # ~P_{l-1}^m, ~P_l^m of the previous l
        for l in range(m, degree):
            if l == m:
                p = pmm * one
            elif l == m + 1:
                p = (2 * m + 1.0) * z * p_l
            else:
                p = ((2 * l - 1.0) * z * p_l
                     - (l + m - 1.0) * p_lm1) / float(l - m)
            p_lm1, p_l = p_l, p
            k, base = ks[l - m], l * l + l
            if m == 0:
                out[base] = k * p
            else:
                out[base + m] = k * p * a[m]
                out[base - m] = k * p * b[m]
    return torch.stack(out, dim=-1)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """(..., 3) unit directions → (..., degree²) SH basis values."""
    if not (1 <= degree <= 8):
        raise ValueError("sh_encode supports degree in [1, 8]")
    if degree > 4:
        return _sh_recurrence(dirs, degree)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)
