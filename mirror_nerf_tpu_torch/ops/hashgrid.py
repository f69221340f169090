"""Multiresolution hash-grid encoder (torch counterpart of
`mirror_nerf_tpu/ops/hashgrid.py`), and the two lookups of the in-kernel
hash probe (`tools/exp_hash_inkernel.py`).

Per level ℓ a feature grid at resolution ceil(2^(ℓS)·H − 1) + 1, dense when
it fits the level's table, spatially hashed (xor of coordinate·prime in
uint32) when it does not, interpolated (linear or smoothstep weights over
the 2^D corners) at pos = x·scale + 0.5 (x·scale with align_corners);
inputs outside [0, 1]^D give zero features. The level layout (`LevelSpec`,
`HashGridSpec.levels`) is the JAX package's, row for row, so a table trained
by either package works in the other.

Five kernel modes of one hand-written library (`csrc/hashgrid.cu`, sm_90a;
see its source note), each with a plain PyTorch version beside it:

  * ENCODE (`encode_forward`): (N, D) x01 → (N, L·C) features, every level
    of a point; the hash-grid model's encoder;
  * BWD (`encode_backward`), ENCODE's backward: from dy (N, L·C) the table
    grads (scatter-added) and/or dx01 (N, D); with dx01 alone the ∇σ of an
    eval render;
  * BWD2 (`encode_backward2`), BWD's backward for a cotangent g (N, D) of
    dx01, the normal losses' grad-of-grad: d_dy, the table grads and
    d_x01, any subset;
  * `gather_rows(table, idx)` (GATHER): `table[idx]` for an (R, C) fp32 or
    bf16 table and int32 indices of any shape, copied bit for bit;
  * `dense_level_lookup(level_rows, x01, scale, side)` (DENSE): the
    trilinear lookup of one dense level from its flat rows (row index
    x + y·side + z·side², modulo the row count), without the out-of-bound
    mask.

BWD's and BWD2's table grads leave a warp as one reduction a run of lanes
in one cell and corner; `reduction_plan` is that plan in plain PyTorch
(which pairs are summed on chip before a reduction goes to L2). The
general ENCODE and BWD build a level's corners by trees over the axes
with a per-level row rule; `any_corners`, `index_rule` and
`any_reduction_plan` are their arithmetic and plan in plain PyTorch.

ENCODE, BWD and BWD2 take every spec the JAX encoder takes (`check_spec`:
input_dim 1..7, any level_dim and level count, align_corners, linear or
smoothstep, hashed or tiled): the hash-grid model's spec (`tuned_spec`) on
the tuned kernels of `csrc/hashgrid.cu`, any other on the general ones of
`csrc/hashgrid_any.cu` (counted in `launches_general_encode`, `_bwd`,
`_bwd2`); the plain versions are the same formulas for any spec.

Each dispatches on the device of its inputs: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises (no fallback). The
kernel's launches are counted per mode in `launches_encode`,
`launches_bwd`, `launches_bwd2`, `launches_gather` and `launches_dense`.
Each launch goes through `_build.Library` (one fast check, the raw current
stream, the device guard in C).

`hashgrid_encode(table, x01, spec)`, the model's encoder, is the
`HashEncode` autograd Function: its forward is ENCODE, its backward
`HashEncodeBackward`, whose forward is BWD and whose backward is BWD2 (and,
for a cotangent on BWD's table grads, ENCODE and BWD with that cotangent
as the table). Both backwards are differentiable graphs on every device, so
the CPU tests run the Function graph the card runs. Each mode computes
only the outputs that the autograd engine will use. GATHER and DENSE are
probes and forward-only: on the card, under grad mode, an input that
requires grad raises. `tv_loss` is the JAX package's total-variation loss,
plain PyTorch (no kernel there either).

pos = x·scale + 0.5 is rounded once, as a fused multiply-add: the JAX
package's XLA contracts it (on the CPU, as the reference's CUDA encoder
does), and separate roundings move pos by one ulp — at the finest level
5e-4 of a cell — for a few % of the points. The plain version emulates the
single rounding in float64 (the product of two floats is exact there).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import Library, card_index, on_card
from .invoke_floor import fma32

# the reference's spatial-hash primes (gridencoder.cu:55-56); the identity
# prime on dim 0 keeps close x-coords in close buckets
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_MASK32 = 0xFFFFFFFF

_LIB = "hashgrid"
# the kernel entries' negative return codes (see csrc/hashgrid.cu)
_REFUSALS = {-1: "the level count is outside [1, 32]",
             -2: "the row width C is not 2 (ENCODE, BWD, BWD2, DENSE) or "
                 "not 1, 2, 4 or 8 (GATHER)",
             -3: "the element size is not 2 or 4 bytes",
             -4: "a level or the table has no rows, or side < 2",
             -5: "no output asked for"}

# kernel launches since import (or since a caller last reset them to 0):
# the tuned library's five modes, and the general ENCODE, BWD and BWD2 of
# `csrc/hashgrid_any.cu` (every spec `tuned_spec` does not take)
launches_encode = 0
launches_bwd = 0
launches_bwd2 = 0
launches_gather = 0
launches_dense = 0
launches_general_encode = 0
launches_general_bwd = 0
launches_general_bwd2 = 0

_ANY_LIB = "hashgrid_any"
MAX_INPUT_DIM = len(_PRIMES)  # the hash's primes: input_dim 1..7
# the general entries' negative return codes (see csrc/hashgrid_any.cu)
_ANY_REFUSALS = {-1: f"input_dim is outside [1, {MAX_INPUT_DIM}]",
                 -2: "no levels", -3: "level_dim < 1",
                 -5: "no output asked for",
                 -6: "more blocks than one launch takes"}
# the general ENCODE's and BWD's layout (csrc/hashgrid_any.cu): BWD's block
# of consecutive points (a warp 32 of them), and the most floats of grads a
# level summed in its shared memory
ANY_BWD_TILE = 128
ANY_SHARED_FLOATS = 2048
# the level table's flags (LevelAny.flags)
_FLAG_MODULO, _FLAG_SHARED = 1, 2


@dataclass(frozen=True)
class LevelSpec:
    resolution: int  # grid cells per side: ceil(scale)+1
    scale: float  # 2^(level*S)*H - 1
    offset: int  # row offset into the flat table
    size: int  # rows in this level's table
    use_hash: bool
    dense_strides: Tuple[int, ...]  # per-dim stride while stride <= size


@dataclass(frozen=True)
class HashGridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: int = 0  # >0 overrides per_level_scale
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"  # "linear" | "smoothstep"

    @property
    def scale_log2(self) -> float:
        if self.desired_resolution:
            return float(
                np.log2(self.desired_resolution / self.base_resolution)
                / (self.num_levels - 1))
        return float(np.log2(self.per_level_scale))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def levels(self) -> Tuple[LevelSpec, ...]:
        return _levels(self)

    @property
    def table_rows(self) -> int:
        last = self.levels()[-1]
        return last.offset + last.size


@functools.lru_cache(maxsize=None)
def _levels(spec: HashGridSpec) -> Tuple[LevelSpec, ...]:
    out = []
    offset = 0
    max_params = 2 ** spec.log2_hashmap_size
    for lvl in range(spec.num_levels):
        scale = float(np.exp2(lvl * spec.scale_log2) * spec.base_resolution
                      - 1.0)
        resolution = int(np.ceil(scale)) + 1
        side = resolution if spec.align_corners else resolution + 1
        params_in_level = min(max_params, side ** spec.input_dim)
        params_in_level = int(np.ceil(params_in_level / 8) * 8)
        # the CUDA index loop: strides accumulate while stride <= table size
        # (gridencoder.cu:68-79)
        strides = []
        stride = 1
        for _ in range(spec.input_dim):
            strides.append(stride if stride <= params_in_level else 0)
            stride *= side
        use_hash = spec.gridtype == "hash" and stride > params_in_level
        out.append(LevelSpec(resolution, scale, offset, params_in_level,
                             use_hash, tuple(strides)))
        offset += params_in_level
    return tuple(out)


def init_hashgrid(generator: Optional[torch.Generator], spec: HashGridSpec,
                  device="cpu") -> torch.Tensor:
    """U(-1e-4, 1e-4) init, matching reference grid.py:204-206."""
    u = torch.rand((spec.table_rows, spec.level_dim), generator=generator)
    return (u * 2e-4 - 1e-4).to(device)


def _mul32(a: torch.Tensor, p: int) -> torch.Tensor:
    """a·p modulo 2³² for int64 a in [0, 2³²) and p < 2³², without
    overflowing int64 (p split into 16-bit halves)."""
    lo, hi = p & 0xFFFF, p >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _MASK32


def _fast_hash(pos: torch.Tensor, d: int) -> torch.Tensor:
    """xor_i(pos_i * prime_i) over uint32 (gridencoder.cu:51-66); pos holds
    uint32 values in int64."""
    acc = _mul32(pos[..., 0], _PRIMES[0])
    for i in range(1, d):
        acc = acc ^ _mul32(pos[..., i], _PRIMES[i])
    return acc


def _corner_indices(spec: HashGridSpec, lv: LevelSpec,
                    pos_grid: torch.Tensor) -> torch.Tensor:
    """Row index within the level table (int64) for integer corners
    (..., D), computed as the JAX package does in uint32."""
    pos_u = pos_grid.to(torch.int64) & _MASK32
    if lv.use_hash:
        idx = _fast_hash(pos_u, spec.input_dim)
    else:
        idx = torch.zeros(pos_grid.shape[:-1], dtype=torch.int64,
                          device=pos_grid.device)
        for d, stride in enumerate(lv.dense_strides):
            if stride:
                idx = (idx + _mul32(pos_u[..., d], stride)) & _MASK32
    return idx % lv.size


def _corner_offsets(d: int, device) -> torch.Tensor:
    return torch.tensor([[(c >> dd) & 1 for dd in range(d)]
                         for c in range(2 ** d)], dtype=torch.int64,
                        device=device)  # (2^D, D)


def _grid_pos(x01: torch.Tensor, scale: float, offset: float):
    """pos = x·scale + offset rounded once (float64 holds the exact product
    of two floats), its floor (int64) and fraction (float32)."""
    s = float(np.float32(scale))
    pos = (x01.double() * s + offset).float()
    pf = torch.floor(pos)
    return pf.to(torch.int64), pos - pf


def _level_lookup(spec: HashGridSpec, lv: LevelSpec, rows: torch.Tensor,
                  x01: torch.Tensor) -> torch.Tensor:
    """One level's trilinear interpolation, (N, D) → (N, C), from the
    level's rows (size, C); no out-of-bound mask."""
    d = spec.input_dim
    corners = _corner_offsets(d, x01.device)
    pg, frac = _grid_pos(x01, lv.scale,
                         0.0 if spec.align_corners else 0.5)
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    cpos = pg[None, :, :] + corners[:, None, :]  # (2^D, N, D)
    idx = _corner_indices(spec, lv, cpos)  # (2^D, N)
    f = torch.where(corners[:, None, :] == 1, frac[None], 1.0 - frac[None])
    w = f[..., 0]
    for dd in range(1, d):
        w = w * f[..., dd]  # ((w0·w1)·w2), the JAX product order
    return torch.sum(w[..., None] * rows[idx], dim=0)


def hashgrid_encode_reference(table: torch.Tensor, x01: torch.Tensor,
                              spec: HashGridSpec) -> torch.Tensor:
    """The plain version of ENCODE (any device): positions x ∈ [0,1]^D →
    (N, L·C) features, zero for a point outside [0,1]^D; differentiable
    w.r.t. the table (scatter-add) and x by autograd."""
    oob = torch.any((x01 < 0.0) | (x01 > 1.0), dim=-1, keepdim=True)
    outs = [_level_lookup(spec, lv, table[lv.offset:lv.offset + lv.size],
                          x01) for lv in spec.levels()]
    out = torch.cat(outs, dim=-1)
    return torch.where(oob, torch.zeros((), dtype=out.dtype,
                                        device=out.device), out)


def _in_cube(x01: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the point lies in [0, 1]^D (ENCODE's mask)."""
    return ~torch.any((x01 < 0.0) | (x01 > 1.0), dim=-1)


def _level_corners(spec: HashGridSpec, lv: LevelSpec, x01: torch.Tensor):
    """One level's 2^D corners as BWD and BWD2 use them: the rows in the
    flat table (2^D, N) int64, the factors f (2^D, N, D) fp32 (S(t_d) for
    corner bit d set, else 1 − S(t_d)), their derivatives ∂f_d/∂t_d
    (±S'(t_d)) and second derivatives (±S''(t_d)), same shape. S is the
    identity (S' = 1, S'' = 0) or smoothstep (t·t)·(3 − 2t), S' = 6t·(1 − t),
    S'' = 6 − 12t."""
    corners = _corner_offsets(spec.input_dim, x01.device)
    pg, t = _grid_pos(x01, lv.scale, 0.0 if spec.align_corners else 0.5)
    rows = lv.offset + _corner_indices(spec, lv,
                                       pg[None] + corners[:, None, :])
    if spec.interpolation == "smoothstep":
        s, s1, s2 = (t * t) * (3.0 - 2.0 * t), (6.0 * t) * (1.0 - t), \
            6.0 - 12.0 * t
    else:
        s, s1, s2 = t, torch.ones_like(t), torch.zeros_like(t)
    up = corners[:, None, :] == 1
    f = torch.where(up, s[None], 1.0 - s[None])
    df = torch.where(up, s1[None], -s1[None])
    ddf = torch.where(up, s2[None], -s2[None])
    return rows, f, df, ddf


def _weights(f: torch.Tensor) -> torch.Tensor:
    """w_c = Π_d f_d in axis order ((f_0·f_1)·f_2 …), the JAX product."""
    w = f[..., 0]
    for d in range(1, f.shape[-1]):
        w = w * f[..., d]
    return w


def _others(f: torch.Tensor, skip) -> torch.Tensor:
    """Π f_k over the axes k not in `skip`, in axis order (1 if none)."""
    keep = [k for k in range(f.shape[-1]) if k not in skip]
    if not keep:
        return torch.ones_like(f[..., 0])
    out = f[..., keep[0]]
    for k in keep[1:]:
        out = out * f[..., k]
    return out


def _weight_grads(f: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """∂w_c/∂t_d = ∂f_d/∂t_d · Π_{e≠d} f_e, (2^D, N, D)."""
    return df * torch.stack([_others(f, (d,)) for d in range(f.shape[-1])],
                            dim=-1)


def _hessian_rows(f, df, ddf, g, smooth: bool) -> torch.Tensor:
    """Σ_e g_e ∂²w_c/∂t_d∂t_e for each axis d, (2^D, N, D): the mixed terms
    ∂f_d/∂t_d·∂f_e/∂t_e·Π_{k≠d,e} f_k summed over e ≠ d in axis order, then,
    for smoothstep, the diagonal ∂²f_d/∂t_d²·Π_{k≠d} f_k."""
    dims = f.shape[-1]
    out = []
    for d in range(dims):
        acc = None
        for e in range(dims):
            if e == d:
                continue
            lo, hi = min(d, e), max(d, e)
            term = g[:, e] * ((df[..., lo] * df[..., hi])
                              * _others(f, (d, e)))
            acc = term if acc is None else acc + term
        if smooth:
            diag = g[:, d] * (ddf[..., d] * _others(f, (d,)))
            acc = diag if acc is None else acc + diag
        out.append(torch.zeros_like(f[..., 0]) if acc is None else acc)
    return torch.stack(out, dim=-1)


def _check_bwd_spec(spec: HashGridSpec) -> None:
    """The summation plan (`reduction_plan`) is the tuned kernels'
    (`tuned_spec`)."""
    if not tuned_spec(spec):
        raise ValueError("the tuned hash-grid backward takes 3-d inputs, 2 "
                         "features a level, align_corners=False, linear "
                         "interpolation and at most 32 levels")


def encode_backward_reference(table: torch.Tensor, x01: torch.Tensor,
                              dy: torch.Tensor, spec: HashGridSpec,
                              need_table: bool = True,
                              need_dx: bool = True):
    """The plain version of BWD (any device, any spec), from its formulas:
    d_table (R, C) += w_c·dy_l at corner c's row, and dx01 (N, D) = Σ_l s_l
    Σ_c ∇_t w_c ⟨T[row_c], dy_l⟩ with s_l = fp32(scale) and ∂w_c/∂t_d =
    ∂f_d/∂t_d·(product of the other factors); a point outside [0, 1]^D
    adds nothing and gets dx01 = 0. Returns (d_table or None, dx01 or
    None)."""
    c = spec.level_dim
    inb = _in_cube(x01)
    dy = torch.where(inb[:, None], dy, torch.zeros((), dtype=dy.dtype))
    d_table = torch.zeros_like(table) if need_table else None
    dx = torch.zeros_like(x01) if need_dx else None
    for li, lv in enumerate(spec.levels()):
        dyl = dy[:, c * li:c * li + c]
        rows, f, df, _ = _level_corners(spec, lv, x01)
        if need_table:
            d_table.index_add_(0, rows.reshape(-1),
                               (_weights(f)[..., None] * dyl[None]
                                ).reshape(-1, c))
        if need_dx:
            dot = (table[rows] * dyl[None]).sum(-1)
            dx += (_weight_grads(f, df) * dot[..., None]).sum(0) * float(
                np.float32(lv.scale))
    if need_dx:
        dx = torch.where(inb[:, None], dx, torch.zeros((), dtype=dx.dtype))
    return d_table, dx


def encode_backward2_reference(table: torch.Tensor, x01: torch.Tensor,
                               dy: torch.Tensor, g: torch.Tensor,
                               spec: HashGridSpec, need_table: bool = True,
                               need_ddy: bool = True, need_dx: bool = True):
    """The plain version of BWD2 (any device, any spec), from its formulas,
    for the cotangent g (N, D) of BWD's dx01: with u_c = s_l ∇_t w_c · g,
    d_dy_l = Σ_c u_c T[row_c], d_table[row_c] += u_c·dy_l and d_x01_d =
    Σ_l s_l² Σ_c ⟨T[row_c], dy_l⟩ Σ_e g_e ∂²w_c/∂t_d∂t_e (`_hessian_rows`:
    the mixed terms, and smoothstep's diagonal); zero outside [0, 1]^D.
    Returns (d_table, d_dy, d_x01), None where not asked for."""
    c = spec.level_dim
    smooth = spec.interpolation == "smoothstep"
    inb = _in_cube(x01)
    g = torch.where(inb[:, None], g, torch.zeros((), dtype=g.dtype))
    d_table = torch.zeros_like(table) if need_table else None
    d_dy = torch.zeros_like(dy) if need_ddy else None
    d_x = torch.zeros_like(x01) if need_dx else None
    for li, lv in enumerate(spec.levels()):
        s = float(np.float32(lv.scale))
        dyl = dy[:, c * li:c * li + c]
        rows, f, df, ddf = _level_corners(spec, lv, x01)
        u = s * (_weight_grads(f, df) * g[None]).sum(-1)  # (2^D, N)
        if need_table:
            d_table.index_add_(0, rows.reshape(-1),
                               (u[..., None] * dyl[None]).reshape(-1, c))
        if need_ddy or need_dx:
            v = table[rows]  # (2^D, N, C)
        if need_ddy:
            d_dy[:, c * li:c * li + c] = (u[..., None] * v).sum(0)
        if need_dx:
            dot = (v * dyl[None]).sum(-1)
            e = _hessian_rows(f, df, ddf, g, smooth)
            d_x += ((e * dot[..., None]).sum(0) * s) * s
    return d_table, d_dy, d_x


# BWD's and BWD2's tile, as csrc/hashgrid.cu sets it (TILE): a block's
# consecutive points, a warp's lanes at one level
BWD_TILE = 32


def pair_values(spec: HashGridSpec, dy: torch.Tensor,
                g: Optional[torch.Tensor] = None):
    """The table-grad values of each corner pair, as a `values_of(level,
    f, sign)` → (8, N, 2) for `table_grad_pairs` and `reduction_plan`:
    BWD's w_c·dy_l, or with the cotangent g BWD2's u_c·dy_l, u_c =
    s_l ∇_t w_c · g."""
    def values(li, f, sign):
        if g is None:
            w = _weights(f)
        else:
            w = float(np.float32(spec.levels()[li].scale)) * (
                _weight_grads(f, sign) * g[None]).sum(-1)
        return w[..., None] * dy[None, :, 2 * li:2 * li + 2]
    return values


def table_grad_pairs(spec: HashGridSpec, x01: torch.Tensor, values_of):
    """Every (row, value) pair the table grads add: corner c of every
    level of every point in [0, 1]³; (rows (P,) int64, values (P, 2))."""
    inb = _in_cube(x01)
    rows, vals = [], []
    for li, lv in enumerate(spec.levels()):
        r, f, sign, _ = _level_corners(spec, lv, x01)
        rows.append(r[:, inb].reshape(-1))
        vals.append(values_of(li, f, sign)[:, inb].reshape(-1, 2))
    return torch.cat(rows), torch.cat(vals)


def reduction_plan(spec: HashGridSpec, x01: torch.Tensor, values_of):
    """The table-grad reductions that BWD and BWD2 send to L2, in plain
    PyTorch: per level, the (row, value) pairs of a tile's lanes (corner c
    of every point in [0, 1]³, `values_of(level, f, sign)` → (8, N, 2), as
    `pair_values` makes it) are summed over each run (a lane and the
    following lanes of its tile that are in the cube and in the same cell:
    the same eight rows), one reduction a run and corner. Returns (rows
    (R,) int64, values (R, 2), per level (pairs, reductions, distinct rows
    a tile)); `index_add_` of the plan into zeros equals `index_add_` of
    every pair."""
    _check_bwd_spec(spec)
    n = x01.shape[0]
    idx = torch.arange(n, device=x01.device)
    tile = idx // BWD_TILE
    live = _in_cube(x01)
    rows_out, vals_out, by_level = [], [], []
    for li, lv in enumerate(spec.levels()):
        rows, f, sign, _ = _level_corners(spec, lv, x01)
        vals = values_of(li, f, sign)  # (8, N, 2)
        cell, _ = _grid_pos(x01, lv.scale, 0.5)
        head = torch.ones(n, dtype=torch.bool, device=x01.device)
        head[1:] = ~((cell[1:] == cell[:-1]).all(-1) & live[1:] & live[:-1])
        head |= idx % BWD_TILE == 0
        run = torch.cumsum(head.long(), 0) - 1
        sums = vals.new_zeros((8, int(head.sum()), 2)).index_add_(
            1, run, torch.where(live[None, :, None], vals,
                                vals.new_zeros(())))
        keep = live[head]
        r = rows[:, head][:, keep].reshape(-1)
        v = sums[:, keep].reshape(-1, 2)
        pairs = rows[:, live]
        per_tile = torch.unique(tile[live].expand(8, -1) * spec.table_rows
                                + pairs).numel()
        by_level.append((pairs.numel(), r.numel(),
                         per_tile / max(int(torch.unique(tile[live])
                                            .numel()), 1)))
        rows_out.append(r)
        vals_out.append(v)
    return torch.cat(rows_out), torch.cat(vals_out), by_level


def any_corners(spec: HashGridSpec, lv: LevelSpec, x01: torch.Tensor):
    """One level's corners as the general ENCODE and BWD build them
    (csrc/hashgrid_any.cu `Walk`), in plain PyTorch: per axis the factors
    (1 − S_d, S_d) and the row terms (g_d·m_d, (g_d + 1)·m_d) in uint32 (m_d
    the prime of a hashed level, else the dense stride); the 2^D weights
    and rows by doubling over the axes in order (w·f_d; r xor or + the
    term); each row reduced by the level's `index_rule`. Returns (rows
    (2^D, N) int64 in the flat table, weights (2^D, N) fp32), corner c's
    bit d for +1 along axis d, for every point (the kernels use those in
    [0, 1]^D only)."""
    pg, t = _grid_pos(x01, lv.scale, 0.0 if spec.align_corners else 0.5)
    if spec.interpolation == "smoothstep":
        t = (t * t) * (3.0 - 2.0 * t)
    f = (1.0 - t, t)
    g = pg & _MASK32
    mult = _PRIMES if lv.use_hash else lv.dense_strides
    terms = [(_mul32(g[:, d], mult[d]), _mul32((g[:, d] + 1) & _MASK32,
                                               mult[d]))
             for d in range(spec.input_dim)]
    w = [f[0][:, 0], f[1][:, 0]]
    r = list(terms[0])
    for d in range(1, spec.input_dim):
        w = [wc * f[b][:, d] for b in (0, 1) for wc in w]
        r = [(rc ^ terms[d][b]) if lv.use_hash
             else (rc + terms[d][b]) & _MASK32 for b in (0, 1) for rc in r]
    rule, msk, sub = index_rule(spec, lv)
    idx = torch.stack(r) & msk
    idx = torch.minimum(idx, (idx - sub) & _MASK32)
    if rule == "modulo":
        idx = idx % lv.size
    return lv.offset + idx, torch.stack(w)


def _vector_reductions(c: int) -> int:
    """Reductions the general BWD sends for one corner's C features: one
    (4, 8 or 16 B) for C 1, 2, 4; 16-B chunks for a multiple of 4; else a
    float each."""
    return 1 if c in (1, 2, 4) else (c // 4 if c % 4 == 0 else c)


def any_reduction_plan(spec: HashGridSpec, x01: torch.Tensor,
                       dy: torch.Tensor, g: Optional[torch.Tensor] = None):
    """The table-grad reductions that the general BWD and BWD2
    (csrc/hashgrid_any.cu) send, in plain PyTorch, for a d_table aligned
    for vector reductions (the wrappers allocate it). Per level, corner c of
    each point in [0, 1]^D adds its value times dy_l: BWD's weight w_c
    (`any_corners`), or with the cotangent g (N, D) of BWD's dx01 BWD2's
    u_c = s_l ∇_t w_c · g (`pair_values`' values):
    - on a shared level (`shared_level`) a block's ANY_BWD_TILE points sum
      their values per table element in shared memory, flushed as one
      scalar reduction a nonzero element;
    - else a warp's runs (a lane and the following lanes of its warp that
      are in the box and in the same cell: the same 2^D rows) are summed,
      and each run's first lane sends one 16-B reduction an x-pair
      (corners c, c + 1) where both rows lie in one 16-B block of the
      table (C 2: {2k, 2k + 1}; C 1: the same block of four), else
      `_vector_reductions(C)` a corner.
    Returns (flat element indices (E,) int64 into the (rows·C,) table,
    values (E,), per level a dict of its pairs (corner values of live
    points), reductions and whether it is shared); `index_add_` of the
    plan into zeros equals `index_add_` of every pair."""
    n, c = x01.shape[0], spec.level_dim
    dev = x01.device
    idx = torch.arange(n, device=dev)
    live = _in_cube(x01)
    k = torch.arange(c, device=dev)
    elems, vals, by_level = [], [], []
    for li, lv in enumerate(spec.levels()):
        rows, w = any_corners(spec, lv, x01)
        if g is not None:
            _, f, df, _ = _level_corners(spec, lv, x01)
            w = float(np.float32(lv.scale)) * (_weight_grads(f, df)
                                               * g[None]).sum(-1)
        v = w[..., None] * dy[None, :, c * li:c * li + c]  # (2^D, N, C)
        pairs = int(live.sum()) * rows.shape[0]
        if shared_level(spec, lv):
            block = (idx // ANY_BWD_TILE).expand_as(rows)[:, live]
            key = block * lv.size + (rows[:, live] - lv.offset)
            sums = v.new_zeros((int(block.max()) + 1 if pairs else 0)
                               * lv.size, c).index_add_(
                0, key.reshape(-1), v[:, live].reshape(-1, c))
            nz = sums.reshape(-1) != 0
            el = (lv.offset * c + torch.arange(sums.numel(), device=dev)
                  % (lv.size * c))[nz]
            elems.append(el)
            vals.append(sums.reshape(-1)[nz])
            by_level.append(dict(pairs=pairs, reductions=int(nz.sum()),
                                 shared=True))
            continue
        cell, _ = _grid_pos(x01, lv.scale, 0.0 if spec.align_corners
                            else 0.5)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = ~((cell[1:] == cell[:-1]).all(-1) & live[1:] & live[:-1])
        head |= idx % 32 == 0
        run = torch.cumsum(head.long(), 0) - 1
        sums = v.new_zeros((rows.shape[0], int(head.sum()), c)).index_add_(
            1, run, torch.where(live[None, :, None], v, v.new_zeros(())))
        keep = live[head]
        r = rows[:, head][:, keep]  # (2^D, runs)
        if c <= 2:  # both rows in one 16-B block
            xor = r[0::2] ^ r[1::2]
            paired = (xor >= 1) & (xor <= (3 if c == 1 else 1))
            sent = int(paired.sum()) + 2 * int((~paired).sum())
        else:
            sent = r.numel() * _vector_reductions(c)
        elems.append((r[..., None] * c + k).reshape(-1))
        vals.append(sums[:, keep].reshape(-1))
        by_level.append(dict(pairs=pairs, reductions=sent, shared=False))
    return torch.cat(elems), torch.cat(vals), by_level


def tv_loss(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec,
            weight: float = 1e-7) -> torch.Tensor:
    """Total-variation loss at sampled points (the JAX package's `tv_loss`,
    the reference's `grad_total_variation`, gridencoder.cu:584-752): per
    level and axis the squared difference between the row of a point's
    cell and that of its +1 neighbour (its corner clamped to the resolution
    on every axis), summed, × weight / N. Plain PyTorch, differentiable by autograd."""
    loss = table.new_zeros(())
    for lv in spec.levels():
        pg, _ = _grid_pos(x01, lv.scale,
                          0.0 if spec.align_corners else 0.5)
        base = table[lv.offset + _corner_indices(spec, lv, pg)]
        for d in range(spec.input_dim):
            nb = pg.clone()
            nb[:, d] += 1
            nb = torch.clamp_max(nb, lv.resolution - 1)  # every axis, as JAX
            diff = base - table[lv.offset + _corner_indices(spec, lv, nb)]
            loss = loss + torch.sum(diff * diff)
    return weight * loss / x01.shape[0]


def gather_rows_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """The plain version of GATHER: table[idx], (*idx.shape, C), with JAX's
    index semantics: r < 0 reads row R + r, and the result is clamped into
    [0, R), so every int32 index reads a row."""
    r = idx.long()
    r = torch.where(r < 0, r + table.shape[0], r)
    return table[r.clamp(0, table.shape[0] - 1)]


def _dense_spec(scale: float, side: int, rows: int) -> Tuple:
    spec = HashGridSpec(num_levels=1, level_dim=1)  # input_dim 3, linear
    return spec, LevelSpec(side - 1, float(scale), 0, rows, False,
                           (1, side, side * side))


def dense_corner_rows(n_rows: int, x01: torch.Tensor, scale: float,
                      side: int) -> torch.Tensor:
    """DENSE's eight corner rows of each point, (8, N) int64: corner c has
    bit d set for +1 along axis d, row (x + y·side + z·side²) mod R in
    uint32 arithmetic, at pos = x·scale + 0.5 rounded once."""
    spec, lv = _dense_spec(scale, side, n_rows)
    pos = fma32(x01, scale, 0.5)
    corners = _corner_offsets(3, x01.device)
    return _corner_indices(
        spec, lv, torch.floor(pos).to(torch.int64)[None]
        + corners[:, None, :])


def dense_pair_loads(rows8: torch.Tensor, base_ptr: int) -> torch.Tensor:
    """Which x-pairs of corners (c = 2k, 2k + 1; rows r, r') the kernel
    loads as one 16-B access, (4, N) bool: r' = r + 1 and row r of 8-B rows
    from `base_ptr` starts on a 16-B boundary (`dense_corners`)."""
    r0, r1 = rows8[0::2], rows8[1::2]
    return (r1 == r0 + 1) & ((base_ptr + r0 * 8) % 16 == 0)


def dense_level_lookup_reference(level_rows: torch.Tensor,
                                 x01: torch.Tensor, scale: float,
                                 side: int) -> torch.Tensor:
    """The plain version of DENSE: one dense level's trilinear lookup at
    pos = x·scale + 0.5 from its flat (R, C) rows, row index
    (x + y·side + z·side²) mod R; (N, 3) → (N, C), in fp32. For x ∈ [0,1]³
    it is `hashgrid_encode`'s slice of that level. The kernel's arithmetic,
    so that the two agree bit for bit: pos as one FMA, the fraction
    t = pos − floor(pos), w = ((w_x·w_y)·w_z) in fp32, and the corners
    summed 0..7 by single-rounding FMAs (`fma32`) from 0."""
    pos = fma32(x01, scale, 0.5)
    frac = pos - torch.floor(pos)
    corners = _corner_offsets(3, x01.device)
    f = torch.where(corners[:, None, :] == 1, frac[None], 1.0 - frac[None])
    w = (f[..., 0] * f[..., 1]) * f[..., 2]  # (8, N)
    vals = level_rows[dense_corner_rows(level_rows.shape[0], x01, scale,
                                        side)]  # (8, N, C)
    acc = torch.zeros_like(vals[0])
    for c in range(8):
        acc = fma32(vals[c], w[c][:, None], acc)
    return acc


# ---- the CUDA kernel (csrc/hashgrid.cu) ----

# each entry's arguments before the card and the stream (_build.Library):
# ENCODE x, table, levels, n_levels, c, n, out; BWD x, table, levels,
# n_levels, c, n, dy, d_table, dx; BWD2 x, table, levels, n_levels, c, n,
# dy, g, d_dy, d_table, d_x (a null output is not computed); GATHER table, rows, c,
# element size, idx, n, out; DENSE rows, row count, c, x, n, scale, side, out
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_library = Library(_LIB, {
    "mnerf_hash_encode": [_P, _P, _P, _I, _I, _LL, _P],
    "mnerf_hash_bwd": [_P, _P, _P, _I, _I, _LL, _P, _P, _P],
    "mnerf_hash_bwd2": [_P, _P, _P, _I, _I, _LL, _P, _P, _P, _P, _P],
    "mnerf_hash_gather": [_P, _LL, _I, _I, _P, _LL, _P],
    "mnerf_hash_dense": [_P, _LL, _I, _P, _LL, ctypes.c_float, _I, _P]},
    _REFUSALS)
# the general entries': x, table, levels, d, n_levels, c, n,
# align_corners, smooth, then ENCODE out; BWD dy, d_table, dx; BWD2 dy, g,
# d_dy, d_table, d_x (a null output is not computed)
_ANY = [_P, _P, _P, _I, _I, _I, _LL, _I, _I]
_any_library = Library(_ANY_LIB, {
    "mnerf_hash_any_encode": [*_ANY, _P],
    "mnerf_hash_any_bwd": [*_ANY, _P, _P, _P],
    "mnerf_hash_any_bwd2": [*_ANY, _P, _P, _P, _P, _P]}, _ANY_REFUSALS)
_F32 = (torch.float32,)
_ROWS = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


def _need(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name}: need a {ndim}-d tensor, got "
                         f"{tuple(t.shape)}")


def _forward_only(mode: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"the hash-grid {mode} kernel is a forward-only probe, and an "
            "input requires grad: run it under torch.no_grad() (the "
            "encoder's gradient is `hashgrid_encode`'s)")


def _row_align(t: torch.Tensor) -> int:
    """The kernel moves a row of C·elem bytes in accesses of min(row, 16)
    bytes: the table must start at a multiple of that."""
    return min(t.shape[-1] * t.element_size(), 16) if t.dim() else 1


_level_words: dict = {}


def _level_table(spec: HashGridSpec, device) -> torch.Tensor:
    """The kernel's level table on `device`, cached: 8 int32 words a level
    (offset, size, fp32 scale bits, three dense strides, use_hash, 0)."""
    key = (spec, str(device))
    if key not in _level_words:
        words = np.zeros((spec.num_levels, 8), np.int32)
        for li, lv in enumerate(spec.levels()):
            words[li, 0] = lv.offset
            words[li, 1] = lv.size
            words[li, 2] = np.float32(lv.scale).view(np.int32)
            words[li, 3:6] = np.asarray(lv.dense_strides, np.int64).astype(
                np.uint32).view(np.int32)
            words[li, 6] = int(lv.use_hash)
        _level_words[key] = torch.from_numpy(words).to(device)
    return _level_words[key]


def tuned_spec(spec: HashGridSpec) -> bool:
    """Whether the tuned ENCODE, BWD and BWD2 of `csrc/hashgrid.cu` take the
    spec (the hash-grid model's): 3-d inputs, 2 features a level,
    align_corners off, linear interpolation, at most 32 levels. Every other
    spec of the range (`check_spec`) takes `csrc/hashgrid_any.cu`."""
    return (spec.input_dim == 3 and spec.level_dim == 2
            and not spec.align_corners and spec.interpolation == "linear"
            and 1 <= spec.num_levels <= 32)


def check_spec(spec: HashGridSpec) -> None:
    """The range of the kernels, the JAX package's: input_dim 1..7 (its
    hash primes), level_dim ≥ 1, ≥ 1 level, linear or smoothstep; a
    ValueError naming the limit otherwise."""
    if not 1 <= spec.input_dim <= MAX_INPUT_DIM:
        raise ValueError(
            f"the hash-grid kernels take input_dim 1..{MAX_INPUT_DIM} (the "
            f"spatial hash's {MAX_INPUT_DIM} primes), got {spec.input_dim}")
    if spec.level_dim < 1 or spec.num_levels < 1:
        raise ValueError("the hash-grid kernels need level_dim ≥ 1 and at "
                         f"least one level, got {spec}")
    if spec.interpolation not in ("linear", "smoothstep"):
        raise ValueError("the hash-grid kernels interpolate linear or "
                         f"smoothstep, got {spec.interpolation!r}")


def _check_shapes(spec: HashGridSpec, table: torch.Tensor,
                  x01: torch.Tensor, *per_point) -> None:
    """What every ENCODE/BWD/BWD2 launch takes besides `card_index`'s
    checks: the spec, x01 (N, D), the table (rows, C) and (name, tensor,
    width) per-point tensors (N, width)."""
    check_spec(spec)
    _need("x01", x01, 2)
    _need("table", table, 2)
    if x01.shape[1] != spec.input_dim or tuple(table.shape) != (
            spec.table_rows, spec.level_dim):
        raise ValueError(f"need x01 (N, {spec.input_dim}) and table "
                         f"({spec.table_rows}, {spec.level_dim}), got "
                         f"{tuple(x01.shape)} and {tuple(table.shape)}")
    for name, t, width in per_point:
        if tuple(t.shape) != (x01.shape[0], width):
            raise ValueError(f"{name}: need ({x01.shape[0]}, {width}), got "
                             f"{tuple(t.shape)}")


def _max_index(spec: HashGridSpec, lv: LevelSpec) -> int:
    """The largest index Σ_d (g_d + 1)·stride_d (an integer, before any
    uint32 wrap) that a corner of a point in [0, 1]^D reaches on a dense
    level: g_d at x_d = 1, pos = fp32(scale + offset), the kernels' FMA."""
    pos = np.float32(np.float64(np.float32(lv.scale))
                     + (0.0 if spec.align_corners else 0.5))
    top = int(np.floor(pos)) + 1
    return sum(top * stride for stride in lv.dense_strides)


def index_rule(spec: HashGridSpec, lv: LevelSpec) -> Tuple[str, int, int]:
    """How the general ENCODE and BWD reduce a corner's uint32 index i to
    the level's row, as (rule, msk, sub) with the row min(i & msk, (i & msk)
    − sub) in uint32, then a true modulo for "modulo": "mask" (msk = size −
    1) where the size is a power of two, as every hashed level's is; on a
    dense level whose index, for points in [0, 1]^D, stays below the size
    "none", or below twice the size "subtract" (sub = size; align_corners
    reaches the size at x = 1); else "modulo". Each equals `% size` wherever
    a point in [0, 1]^D takes it (`any_corners`)."""
    size = lv.size
    if size & (size - 1) == 0:
        return "mask", size - 1, 0
    if not lv.use_hash:
        top = _max_index(spec, lv)
        if top < size:
            return "none", _MASK32, 0
        if top < 2 * size <= _MASK32:
            return "subtract", _MASK32, size
    return "modulo", _MASK32, 0


def divisor_magic(size: int) -> Tuple[int, int]:
    """M = ⌈2⁶⁴ / size⌉ as (low, high) uint32 words: for every uint32 i,
    ⌊i·M / 2⁶⁴⌋ = ⌊i / size⌋, so the general kernels take i mod size as
    i − ⌊i·M / 2⁶⁴⌋·size (`index_of`)."""
    m = -(-(1 << 64) // size)
    return m & _MASK32, m >> 32


def shared_level(spec: HashGridSpec, lv: LevelSpec) -> bool:
    """Whether the general BWD sums a level's table grads in a block's
    shared memory and flushes them once: its grads fit ANY_SHARED_FLOATS
    and it has no more rows than a block has corners (ANY_BWD_TILE·2^D), as
    the coarse dense levels."""
    return (lv.size * spec.level_dim <= ANY_SHARED_FLOATS
            and lv.size <= ANY_BWD_TILE * 2 ** spec.input_dim)


_level_words_any: dict = {}


def _level_table_any(spec: HashGridSpec, device) -> torch.Tensor:
    """The general kernels' level table on `device`, cached: 16 int32 words
    a level (offset, size, fp32 scale bits, use_hash, the D dense strides;
    at 11-13 the index rule's msk and sub (`index_rule`) and the flags:
    1 a true modulo, 2 BWD's shared-memory level (`shared_level`); at 14-15
    the modulo's multiplier ⌈2⁶⁴ / size⌉, low word first)."""
    key = (spec, str(device))
    if key not in _level_words_any:
        words = np.zeros((spec.num_levels, 16), np.int32)
        for li, lv in enumerate(spec.levels()):
            words[li, 0] = np.uint32(lv.offset).view(np.int32)
            words[li, 1] = np.uint32(lv.size).view(np.int32)
            words[li, 2] = np.float32(lv.scale).view(np.int32)
            words[li, 3] = int(lv.use_hash)
            words[li, 4:4 + spec.input_dim] = np.asarray(
                lv.dense_strides, np.int64).astype(np.uint32).view(np.int32)
            rule, msk, sub = index_rule(spec, lv)
            words[li, 11] = np.uint32(msk).view(np.int32)
            words[li, 12] = np.uint32(sub).view(np.int32)
            words[li, 13] = ((_FLAG_MODULO if rule == "modulo" else 0)
                             | (_FLAG_SHARED if shared_level(spec, lv)
                                else 0))
            if rule == "modulo":
                words[li, 14:16] = np.asarray(
                    divisor_magic(lv.size), np.uint32).view(np.int32)
        _level_words_any[key] = torch.from_numpy(words).to(device)
    return _level_words_any[key]


def _any_args(spec: HashGridSpec, table, x01) -> tuple:
    """The general entries' leading arguments: x, table, levels, d,
    n_levels, c, n, align_corners, smooth."""
    return (x01.data_ptr(), table.data_ptr(),
            _level_table_any(spec, x01.device).data_ptr(), spec.input_dim,
            spec.num_levels, spec.level_dim, x01.shape[0],
            int(spec.align_corners), int(spec.interpolation == "smoothstep"))


def hashgrid_encode_cuda(table: torch.Tensor, x01: torch.Tensor,
                         spec: HashGridSpec) -> torch.Tensor:
    """ENCODE: launch the kernel on CUDA tensors, the tuned one for the
    model's spec, else the general one (raises for anything neither
    takes). A mode call: its output carries no graph (`hashgrid_encode` is
    the differentiable encoder)."""
    global launches_encode, launches_general_encode
    tuned = tuned_spec(spec)
    dev = card_index("hash-grid ENCODE", ("x01", x01, _F32, 4),
                     ("table", table, _F32,
                      _row_align(table) if tuned else 4))
    _check_shapes(spec, table, x01)
    n = x01.shape[0]
    out = x01.new_empty((n, spec.output_dim))
    if n == 0:
        return out
    if tuned:
        words = _level_table(spec, x01.device)
        _library.launch("mnerf_hash_encode", "hash-grid ENCODE", dev,
                        x01.data_ptr(), table.data_ptr(), words.data_ptr(),
                        spec.num_levels, spec.level_dim, n, out.data_ptr())
        launches_encode += 1
    else:
        _any_library.launch("mnerf_hash_any_encode", "hash-grid ENCODE",
                            dev, *_any_args(spec, table, x01),
                            out.data_ptr())
        launches_general_encode += 1
    return out


def encode_backward_cuda(table: torch.Tensor, x01: torch.Tensor,
                         dy: torch.Tensor, spec: HashGridSpec,
                         need_table: bool = True, need_dx: bool = True):
    """BWD: launch the kernel, tuned or general as ENCODE (a mode call, no
    graph); (d_table or None, dx01 or None). The table is read only for
    dx01."""
    global launches_bwd, launches_general_bwd
    tuned = tuned_spec(spec)
    align = 8 if tuned else 4
    dev = card_index("hash-grid BWD", ("x01", x01, _F32, 4),
                     ("table", table, _F32, align), ("dy", dy, _F32, align))
    _check_shapes(spec, table, x01, ("dy", dy, spec.output_dim))
    if not (need_table or need_dx):
        raise ValueError("hash-grid BWD: no output asked for")
    d_table = torch.zeros_like(table) if need_table else None
    dx = torch.empty_like(x01) if need_dx else None
    n = x01.shape[0]
    if n == 0:
        return d_table, dx
    outs = (d_table.data_ptr() if need_table else None,
            dx.data_ptr() if need_dx else None)
    if tuned:
        _library.launch(
            "mnerf_hash_bwd", "hash-grid BWD", dev, x01.data_ptr(),
            table.data_ptr(), _level_table(spec, x01.device).data_ptr(),
            spec.num_levels, spec.level_dim, n, dy.data_ptr(), *outs)
        launches_bwd += 1
    else:
        _any_library.launch("mnerf_hash_any_bwd", "hash-grid BWD", dev,
                            *_any_args(spec, table, x01), dy.data_ptr(),
                            *outs)
        launches_general_bwd += 1
    return d_table, dx


def encode_backward2_cuda(table: torch.Tensor, x01: torch.Tensor,
                          dy: torch.Tensor, g: torch.Tensor,
                          spec: HashGridSpec, need_table: bool = True,
                          need_ddy: bool = True, need_dx: bool = True):
    """BWD2: launch the kernel, tuned or general as ENCODE (a mode call, no
    graph); (d_table, d_dy, d_x01), None where not asked for."""
    global launches_bwd2, launches_general_bwd2
    tuned = tuned_spec(spec)
    align = 8 if tuned else 4
    dev = card_index("hash-grid BWD2", ("x01", x01, _F32, 4),
                     ("table", table, _F32, align), ("dy", dy, _F32, align),
                     ("g", g, _F32, 4))
    _check_shapes(spec, table, x01, ("dy", dy, spec.output_dim),
                  ("g", g, spec.input_dim))
    if not (need_table or need_ddy or need_dx):
        raise ValueError("hash-grid BWD2: no output asked for")
    d_table = torch.zeros_like(table) if need_table else None
    d_dy = torch.empty_like(dy) if need_ddy else None
    d_x = torch.empty_like(x01) if need_dx else None
    n = x01.shape[0]
    if n == 0:
        return d_table, d_dy, d_x
    outs = [t.data_ptr() if t is not None else None
            for t in (d_dy, d_table, d_x)]
    if tuned:
        _library.launch(
            "mnerf_hash_bwd2", "hash-grid BWD2", dev, x01.data_ptr(),
            table.data_ptr(), _level_table(spec, x01.device).data_ptr(),
            spec.num_levels, spec.level_dim, n, dy.data_ptr(), g.data_ptr(),
            *outs)
        launches_bwd2 += 1
    else:
        _any_library.launch("mnerf_hash_any_bwd2", "hash-grid BWD2", dev,
                            *_any_args(spec, table, x01), dy.data_ptr(),
                            g.data_ptr(), *outs)
        launches_general_bwd2 += 1
    return d_table, d_dy, d_x


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """GATHER: launch the kernel. Rows are copied bit for bit, with JAX's
    `table[idx]` semantics as in the plain version: r < 0 reads row R + r,
    then the row is clamped into [0, R)."""
    global launches_gather
    _forward_only("GATHER", table)
    dev = card_index("hash-grid GATHER",
                     ("table", table, _ROWS, _row_align(table)),
                     ("idx", idx, _I32, 4))
    _need("table", table, 2)
    r, c = table.shape
    out = table.new_empty((*idx.shape, c))
    n = idx.numel()
    if n == 0:
        return out
    _library.launch("mnerf_hash_gather", "hash-grid GATHER", dev,
                    table.data_ptr(), r, c, table.element_size(),
                    idx.data_ptr(), n, out.data_ptr())
    launches_gather += 1
    return out


def dense_level_lookup_cuda(level_rows: torch.Tensor, x01: torch.Tensor,
                            scale: float, side: int) -> torch.Tensor:
    """DENSE: launch the kernel."""
    global launches_dense
    _forward_only("DENSE", level_rows, x01)
    dev = card_index("hash-grid DENSE", ("x01", x01, _F32, 4),
                     ("level_rows", level_rows, _F32,
                      _row_align(level_rows)))
    _need("x01", x01, 2)
    _need("level_rows", level_rows, 2)
    if x01.shape[1] != 3:
        raise ValueError(f"need x01 (N, 3), got {tuple(x01.shape)}")
    r, c = level_rows.shape
    n = x01.shape[0]
    out = x01.new_empty((n, c))
    if n == 0:
        return out
    _library.launch("mnerf_hash_dense", "hash-grid DENSE", dev,
                    level_rows.data_ptr(), r, c, x01.data_ptr(), n,
                    float(scale), int(side), out.data_ptr())
    launches_dense += 1
    return out


def encode_forward(table: torch.Tensor, x01: torch.Tensor,
                   spec: HashGridSpec) -> torch.Tensor:
    """ENCODE, a mode call: CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if x01.is_cuda or on_card("hash-grid encode", table, x01):
        return hashgrid_encode_cuda(table, x01, spec)
    return hashgrid_encode_reference(table, x01, spec)


def encode_backward(table, x01, dy, spec, need_table=True, need_dx=True):
    """BWD, a mode call: CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if x01.is_cuda or on_card("hash-grid backward", table, x01, dy):
        return encode_backward_cuda(table, x01, dy, spec, need_table,
                                    need_dx)
    return encode_backward_reference(table, x01, dy, spec, need_table,
                                     need_dx)


def encode_backward2(table, x01, dy, g, spec, need_table=True,
                     need_ddy=True, need_dx=True):
    """BWD2, a mode call: CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if x01.is_cuda or on_card("hash-grid backward2", table, x01, dy, g):
        return encode_backward2_cuda(table, x01, dy, g, spec, need_table,
                                     need_ddy, need_dx)
    return encode_backward2_reference(table, x01, dy, g, spec, need_table,
                                      need_ddy, need_dx)


def _wanted(ctx, i: int) -> bool:
    """Whether the backward's gradient for input i will be used: the input
    requires grad and the engine runs its node in this pass (a
    `torch.autograd.grad` for x alone, as the σ-gradient normal takes, runs
    no table node: BWD then skips the table's scatter). The engine's query
    raises for a leaf whose gradient `torch.autograd.grad` captures as a
    result: that gradient is wanted. Any other error propagates."""
    if not ctx.needs_input_grad[i]:
        return False
    try:
        return torch._C._will_engine_execute_node(ctx.next_functions[i][0])
    except RuntimeError as e:
        if "leaf node" in str(e) and "autograd.grad()" in str(e):
            return True
        raise


class HashEncode(torch.autograd.Function):
    """The differentiable encoder: forward ENCODE, backward
    `HashEncodeBackward` (BWD, itself differentiable through BWD2)."""

    @staticmethod
    def forward(ctx, table, x01, spec):
        ctx.spec = spec
        ctx.save_for_backward(table, x01)
        return encode_forward(table, x01, spec)

    @staticmethod
    def backward(ctx, dy):
        table, x01 = ctx.saved_tensors
        need_table, need_dx = _wanted(ctx, 0), _wanted(ctx, 1)
        if not (need_table or need_dx):
            return None, None, None
        d_table, dx = HashEncodeBackward.apply(
            table, x01, dy.contiguous(), ctx.spec, need_table, need_dx)
        return d_table, dx, None


class HashEncodeBackward(torch.autograd.Function):
    """BWD as a Function of (table, x01, dy) → (d_table, dx01), either None
    where not asked for. Its backward takes the cotangents (G, g) of
    (d_table, dx01): BWD2 for g; for G, d_dy is ENCODE with G as the table
    and d_x01 BWD's dx01 with G as the table (d_table is linear in dy and
    does not depend on the table). Past this, a third derivative raises."""

    @staticmethod
    def forward(ctx, table, x01, dy, spec, need_table, need_dx):
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(table, x01, dy)
        return encode_backward(table, x01, dy, spec, need_table, need_dx)

    @staticmethod
    def backward(ctx, big_g, g):
        table, x01, dy = ctx.saved_tensors
        spec = ctx.spec
        if torch.is_grad_enabled() and any(ctx.needs_input_grad[:3]):
            raise NotImplementedError(
                "a third derivative of the hash-grid encoder is not "
                "implemented (create_graph=True through its grad-of-grad)")
        need_table, need_x, need_dy = (_wanted(ctx, i) for i in range(3))
        d_table = d_x = d_dy = None
        if g is not None and (need_table or need_x or need_dy):
            d_table, d_dy, d_x = encode_backward2(
                table, x01, dy, g.contiguous(), spec, need_table, need_dy,
                need_x)
        if big_g is not None:
            big_g = big_g.contiguous()
            if need_dy:
                enc = encode_forward(big_g, x01, spec)
                d_dy = enc if d_dy is None else d_dy + enc
            if need_x:
                _, dxg = encode_backward(big_g, x01, dy, spec, False, True)
                d_x = dxg if d_x is None else d_x + dxg
        return d_table, d_x, d_dy, None, None, None


def hashgrid_encode(table: torch.Tensor, x01: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """(N, D) positions in [0,1] → (N, L·C), differentiable twice w.r.t.
    the table and x01 (`HashEncode`). CPU tensors take the plain versions,
    CUDA tensors the ENCODE, BWD and BWD2 kernels."""
    return HashEncode.apply(table, x01, spec)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]. CPU tensors take the plain version, CUDA tensors the
    GATHER kernel."""
    if table.is_cuda or on_card("hash-grid gather", table, idx):
        return gather_rows_cuda(table, idx)
    return gather_rows_reference(table, idx)


def dense_level_lookup(level_rows: torch.Tensor, x01: torch.Tensor,
                       scale: float, side: int) -> torch.Tensor:
    """One dense level's trilinear lookup. CPU tensors take the plain
    version, CUDA tensors the DENSE kernel."""
    if x01.is_cuda or on_card("dense level lookup", level_rows, x01):
        return dense_level_lookup_cuda(level_rows, x01, scale, side)
    return dense_level_lookup_reference(level_rows, x01, scale, side)
