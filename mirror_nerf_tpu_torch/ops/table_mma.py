"""Encoder-shaped table products on the tensor cores (torch counterpart of
the TPU probe kernel `kernel`, `tools/exp_int8_probe.py:49`), as one
hand-written kernel (`csrc/table_mma.cu`, sm_90a, `wgmma` with the basis
built by producer warps into a ring of shared-memory stages while consumer
warpgroups multiply; see its source note) for two operand types:

  * `table_mma(x, t)`: x (nb, 1, L) fp32 rows and t (nt, r, g) tables, int8
    or bf16 → out (nb, r, L) fp32, out_b = Σ_j t_j @ basis_j with the basis
    built from x_b: basis_j[i, l] = cast(fl(fl(fl(i·1e-3) + x_b[l]) + j)).
    The cast to int8 clips to ±127 and truncates toward zero; the cast to
    bf16 rounds to nearest even. int8 products sum in int32 and each table's
    sum is converted to fp32 before the sum over tables.

It dispatches on the device of its inputs: CPU tensors take the plain
version `table_mma_reference`, CUDA tensors launch the kernel through
`table_mma_cuda` (on `_build.Library`) or raise (no fallback). Launches are counted per type in
`launches_int8` and `launches_bf16`.

The basis is three fp32 roundings, as the JAX body computes it (and as the
kernel's __fmul_rn / __fadd_rn do). The plain version sums each table's
products in float64, exact for int8 (every partial sum is an integer below
2²⁴) and rounded once for bf16 (products of two bf16 are exact in fp32), so
it takes no TF32 path on any device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Library, card_index, on_card

_LIB = "table_mma"
G_MAX = 16384  # the kernel keeps fl(i·1e-3) for every i in shared memory
_REFUSALS = {-1: "g is not a positive multiple of 64",
             -2: "the lane count is not a positive multiple of 128",
             -3: "no blocks, tables or rows (or over 2**31 - 1 tiles)",
             -4: "an unknown operand type",
             -5: f"g is above {G_MAX} (the kernel keeps fl(i*1e-3) for "
                 "every i in shared memory)",
             -6: "cuTensorMapEncodeTiled did not make the tables' tensor "
                 "map (or was not found)"}
KINDS = {torch.int8: 0, torch.bfloat16: 1}

# kernel launches since import (or since a caller last reset them to 0)
launches_int8 = 0
launches_bf16 = 0


def basis_reference(x: torch.Tensor, g: int, j: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """basis_j for every block: (nb, g, L) of `dtype` from x (nb, 1, L)."""
    iot = torch.arange(g, dtype=torch.float32, device=x.device) * \
        torch.tensor(1e-3, dtype=torch.float32, device=x.device)
    f = (iot[:, None] + x) + float(j)
    if dtype == torch.int8:
        return f.clamp(-127.0, 127.0).to(torch.int8)
    return f.to(dtype)


def table_mma_reference(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The plain version (any device): (nb, r, L) fp32."""
    _check_shapes(x, t)
    out = torch.zeros((x.shape[0], t.shape[1], x.shape[2]),
                      dtype=torch.float32, device=x.device)
    for j in range(t.shape[0]):
        b = basis_reference(x, t.shape[2], j, t.dtype)
        out = out + (t[j].double() @ b.double()).float()
    return out


def _check_shapes(x: torch.Tensor, t: torch.Tensor) -> None:
    if t.dtype not in KINDS or x.dtype != torch.float32:
        raise ValueError(f"need fp32 x and int8 or bf16 tables, got "
                         f"{x.dtype} and {t.dtype}")
    if x.dim() != 3 or x.shape[1] != 1 or t.dim() != 3 or 0 in t.shape \
            or x.shape[0] == 0:
        raise ValueError(f"need x (nb, 1, L) and t (nt, r, g), got "
                         f"{tuple(x.shape)} and {tuple(t.shape)}")


# ---- the CUDA kernel (csrc/table_mma.cu) ----

# the entry's arguments before the card and the stream (_build.Library):
# t, x, out, nb, nt, r, g, lanes, kind
_P, _I = ctypes.c_void_p, ctypes.c_int
_library = Library(_LIB, {"mnerf_table_mma": [_P, _P, _P, _I, _I, _I, _I,
                                               _I, _I]}, _REFUSALS)
_TABLES = tuple(KINDS)
_F32 = (torch.float32,)


def table_mma_cuda(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream (raises for anything it does
    not take: g a multiple of 64 up to G_MAX, L of 128, contiguous 16-B
    aligned inputs)."""
    global launches_int8, launches_bf16
    dev = card_index("table-mma", ("x", x, _F32, 16), ("t", t, _TABLES, 16))
    _check_shapes(x, t)
    nb, _, lanes = x.shape
    nt, r, g = t.shape
    out = x.new_empty((nb, r, lanes))
    _library.launch("mnerf_table_mma", "table-mma", dev, t.data_ptr(),
                    x.data_ptr(), out.data_ptr(), nb, nt, r, g, lanes,
                    KINDS[t.dtype])
    if t.dtype == torch.int8:
        launches_int8 += 1
    else:
        launches_bf16 += 1
    return out


def table_mma(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out_b = Σ_j t_j @ basis_j(x_b). CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if x.is_cuda or on_card("table mma", x, t):
        return table_mma_cuda(x, t)
    return table_mma_reference(x, t)
