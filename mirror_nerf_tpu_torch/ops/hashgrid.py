"""Multiresolution hash-grid encoder (torch counterpart of
`mirror_nerf_tpu/ops/hashgrid.py`), and the two lookups of the in-kernel
hash probe (`tools/exp_hash_inkernel.py`).

Per level ℓ a feature grid at resolution ceil(2^(ℓS)·H − 1) + 1, dense when
it fits the level's table, spatially hashed (xor of coordinate·prime in
uint32) when it does not, trilinearly interpolated at pos = x·scale + 0.5;
inputs outside [0, 1]³ give zero features. The level layout (`LevelSpec`,
`HashGridSpec.levels`) is the JAX package's, row for row, so a table trained
by either package works in the other.

Three functions, each a plain PyTorch version beside a mode of one
hand-written kernel (`csrc/hashgrid.cu`, sm_90a; see its source note):

  * `hashgrid_encode(table, x01, spec)` (ENCODE): (N, 3) x01 → (N, L·C)
    features, every level of a point; the hash-grid model's encoder;
  * `gather_rows(table, idx)` (GATHER): `table[idx]` for an (R, C) fp32 or
    bf16 table and int32 indices of any shape, copied bit for bit;
  * `dense_level_lookup(level_rows, x01, scale, side)` (DENSE): the
    trilinear lookup of one dense level from its flat rows (row index
    x + y·side + z·side², modulo the row count), without the out-of-bound
    mask.

Each dispatches on the device of its inputs: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises (no fallback). The
kernel's launches are counted per mode in `launches_encode`,
`launches_gather` and `launches_dense`. Each launch goes through
`_build.Library` (one fast check, the raw current stream, the device guard
in C). The kernel is forward-only: on the card, under grad mode, a table or
an input that requires grad raises (training the hash-grid model is
ROADMAP.md queue 1, item 11). On the CPU the plain versions are
differentiable by autograd.

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
             -2: "the row width C is not 2 (ENCODE, DENSE) or not 1, 2, 4 "
                 "or 8 (GATHER)",
             -3: "the element size is not 2 or 4 bytes",
             -4: "a level or the table has no rows, or side < 2"}
_TRAIN_TODO = ("ROADMAP.md queue 1, item 11 (hash-grid training: the "
               "encoder's backward as a scatter-add kernel)")

# kernel launches since import (or since a caller last reset them to 0)
launches_encode = 0
launches_gather = 0
launches_dense = 0


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
# ENCODE x, table, levels, n_levels, c, n, out; GATHER table, rows, c,
# element size, idx, n, out; DENSE rows, row count, c, x, n, scale, side, out
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_library = Library(_LIB, {
    "mnerf_hash_encode": [_P, _P, _P, _I, _I, _LL, _P],
    "mnerf_hash_gather": [_P, _LL, _I, _I, _P, _LL, _P],
    "mnerf_hash_dense": [_P, _LL, _I, _P, _LL, ctypes.c_float, _I, _P]},
    _REFUSALS)
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
            f"the hash-grid {mode} kernel is forward-only, and an input "
            "requires grad: run it under torch.no_grad(); training the "
            f"hash-grid model is not ported yet: {_TRAIN_TODO}")


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


def hashgrid_encode_cuda(table: torch.Tensor, x01: torch.Tensor,
                         spec: HashGridSpec) -> torch.Tensor:
    """ENCODE: launch the kernel on CUDA tensors (raises for anything it
    does not take)."""
    global launches_encode
    _forward_only("ENCODE", table, x01)
    dev = card_index("hash-grid ENCODE", ("x01", x01, _F32, 4),
                     ("table", table, _F32, _row_align(table)))
    if (spec.input_dim != 3 or spec.align_corners
            or spec.interpolation != "linear"):
        raise ValueError("the hash-grid kernel takes 3-d inputs, "
                         "align_corners=False and linear interpolation")
    _need("x01", x01, 2)
    _need("table", table, 2)
    if x01.shape[1] != 3 or tuple(table.shape) != (spec.table_rows,
                                                   spec.level_dim):
        raise ValueError(f"need x01 (N, 3) and table "
                         f"({spec.table_rows}, {spec.level_dim}), got "
                         f"{tuple(x01.shape)} and {tuple(table.shape)}")
    n = x01.shape[0]
    out = x01.new_empty((n, spec.output_dim))
    if n == 0:
        return out
    words = _level_table(spec, x01.device)
    _library.launch("mnerf_hash_encode", "hash-grid ENCODE", dev,
                    x01.data_ptr(), table.data_ptr(), words.data_ptr(),
                    spec.num_levels, spec.level_dim, n, out.data_ptr())
    launches_encode += 1
    return out


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


def hashgrid_encode(table: torch.Tensor, x01: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """(N, D) positions in [0,1] → (N, L·C). CPU tensors take the plain
    version, CUDA tensors the ENCODE kernel."""
    if x01.is_cuda or on_card("hash-grid encode", table, x01):
        return hashgrid_encode_cuda(table, x01, spec)
    return hashgrid_encode_reference(table, x01, spec)


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
