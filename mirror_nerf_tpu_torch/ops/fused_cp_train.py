"""Fused CP-grid density + σ-gradient for training, with a hand-written
backward (torch counterpart of `mirror_nerf_tpu/ops/pallas/fused_cp_train.py`).

Same contract as the JAX wrappers:

  * `density_with_grad_fused(field, params, xyz)` → (σ (T,), geo (T, 15),
    ∇σ (T, 3)): the drop-in for the σ-gradient normal on the CP-grid
    field. ∇σ is a PRIMAL output of one `torch.autograd.Function`, so a loss
    on the normals is first-order for autograd; the backward kernel carries
    the second-order ∂/∂θ⟨n̄, ∇σ⟩ terms itself.
  * `density_fused(field, params, xyz, need_dx=True)` → (σ, geo), the
    density-only variant; `need_dx=False` returns a zero d_x (inputs that
    carry no gradient, as in the novel-ray regularization).

Dispatch: CPU tensors take the plain versions — `density_with_grad_reference`
(`field.density` + `torch.autograd.grad`, the counterpart of the JAX
package's `renderer._density_with_grad`) and `density_reference`
(`field.density`) — whose autograd backward is the plain version of the
backward kernel. CUDA tensors launch `csrc/fused_cp_train.cu` (see its
source note) or raise; `launches_fwd` / `launches_bwd` count the launches.

The kernels take each level's rank a multiple of 16 and 16-B aligned
tables: other levels run on zero-padded copies (`_kernel_operands`), whose
grads are cut back. `rho`, `sigma_order` and `c_order` are the kernels'
index maps (the fold's A columns, pb's C columns, a C fragment fed as the
next A fragment), mirrored here for the CPU emulation of their fragments.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._dtype import float32_field
from ._build import Library, card_index

_LIB = "fused_cp_train"
# the kernel entries' negative return codes (see mnerf_cp_train_fwd)
_REFUSALS = {-1: "the level count is outside [1, 8]",
             -3: "a level has G < 2 or R < 1",
             -5: "the nets exceed the kernel's shared memory (the levels' "
                 "ranks, each padded to a multiple of 16, may sum to 800 "
                 "in the forward and 768 in the backward)",
             -6: "no samples",
             -8: "a level's rank is not a multiple of 16"}
RANK_GROUP = 16  # ranks a lane's two 16-B loads a row cover, four a lane

# kernel launches since import (or since a caller last reset them to 0)
launches_fwd = 0
launches_bwd = 0


def density_reference(field, params: dict, xyz: torch.Tensor):
    """The plain version of the density-only kernel (any device)."""
    return field.density(params, xyz)


def density_with_grad_reference(field, params: dict, xyz: torch.Tensor):
    """The plain version of the tangent kernel (any device): σ, geo and
    ∇σ = d(Σσ)/dx by autograd, differentiable (grad-of-grad) when grad mode
    is on. Under no_grad it still computes ∇σ, and returns detached
    values."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = xyz if xyz.requires_grad else xyz.detach().requires_grad_(True)
        sigma, geo = field.density(params, x)
        (grad,) = torch.autograd.grad(sigma.sum(), x, create_graph=create)
    if not create:
        sigma, geo = sigma.detach(), geo.detach()
    return sigma, geo, grad


# the entries' arguments before the card and the stream (_build.Library):
# forward xyz, fold, s1, s2, tables, level_g, level_r, n_levels, n, bound,
# tangents, sigma, geo, grad; backward xyz, fold, s1, s2, tables, level_g,
# level_r, n_levels, n, bound, tangents, need_dx, dsig, dgeo, dgrad, dx,
# d_tables, d_fold, d_s1, d_s2, part, part_floats
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_F32 = (torch.float32,)
_library = Library(_LIB, {
    "mnerf_cp_train_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P,
                           _P, _P],
    "mnerf_cp_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           ctypes.c_longlong]}, _REFUSALS)
# the backward's warps a block at most, and the floats of a warp's running
# dense-grad sums besides d_fold's (d_s1 32 × 64, d_s2 64 × 16)
_BWD_WARPS = 8
_NET_GRADS = 32 * 64 + 64 * 16
_sms = {}  # card index -> its SM count


def _part_floats(dev: int, sum_r: int) -> int:
    """The backward's scratch: a running sum of the dense grads for each of
    8 warps an SM (the kernel's grid takes no more blocks than it holds)."""
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev] * _BWD_WARPS * (sum_r * 32 + _NET_GRADS)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _level_args(levels):
    n = len(levels)
    return ((ctypes.c_int * n)(*[g for g, _ in levels]),
            (ctypes.c_int * n)(*[r for _, r in levels]), n)


def _inputs(field, xyz, fold, s1, s2, tables):
    """Check what the kernels take: contiguous float32 on one CUDA device,
    xyz (T, 3), tables (G, R) per level and axis (level-major), fold
    (ΣR, 32), s1 (32, 64), s2 (64, 16). Returns the levels and the card's
    index."""
    want = {"xyz": (xyz, (xyz.shape[0], 3)), "fold": (fold, None),
            "s1": (s1, (32, 64)), "s2": (s2, (64, 16))}
    for k, t in enumerate(tables):
        want[f"axes/{k % 3}/{k // 3}"] = (t, None)
    dev = card_index("fused CP train", *((name, t, _F32, 4)
                                          for name, (t, _) in want.items()))
    if not field.supports_fused_train:
        raise ValueError("the fused CP train kernels need the 2-layer, "
                         "64-wide σ-net with 15 geo features "
                         "(TPUGridField.supports_fused_train)")
    levels = tuple(field.grid_levels)
    want["fold"] = (fold, (sum(r for _, r in levels), 32))
    for k, t in enumerate(tables):
        want[f"axes/{k % 3}/{k // 3}"] = (t, levels[k // 3])
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need a {tuple(shape)} tensor, got "
                             f"{tuple(t.shape)}")
    return levels, dev


def rho(k: int) -> int:
    """The rank of the fold's A column k (k-tile k // 8 = 2p + h, column
    c = k % 8): 16p + 4(c % 4) + 2h + c // 4, so that a lane's columns t,
    t + 4 of k-tiles 2p, 2p + 1 are the four adjacent ranks 16p + 4t …
    16p + 4t + 3 of one 16-B table load."""
    blk, c = divmod(k, 8)
    return 16 * (blk // 2) + 4 * (c % 4) + 2 * (blk % 2) + c // 4


def sigma_order(n: int) -> int:
    """The rank of pb's C column n (n-tile n // 8 = 2p + h, column c):
    16p + 4(c // 2) + 2h + c % 2, the rank a lane's A fragment holds at the
    same place (C columns 2t, 2t + 1 are A columns t, t + 4)."""
    blk, c = divmod(n, 8)
    return 16 * (blk // 2) + 4 * (c // 2) + 2 * (blk % 2) + c % 2


def c_order(k: int) -> int:
    """The feature of A column k when a C fragment feeds the next product:
    C column 2(c % 4) + c // 4 of the same tile."""
    blk, c = divmod(k, 8)
    return 8 * blk + 2 * (c % 4) + c // 4


def _padded_levels(levels) -> tuple:
    return tuple((g, -(-r // RANK_GROUP) * RANK_GROUP) for g, r in levels)


def _kernel_operands(levels, fold, tables):
    """(levels, fold, tables, spans) as the kernels take them: the inputs
    themselves when every rank is a multiple of 16 and every table 16-B
    aligned (the default levels), else zero-padded copies and `spans`, each
    level's (first row in the padded fold, rank), for cutting the grads
    back (`_unpad_fold`). Device ops only: a CUDA graph can capture it."""
    padded = _padded_levels(levels)
    if padded == tuple(levels) and all(t.data_ptr() % 16 == 0
                                       for t in tables):
        return levels, fold, list(tables), None
    pad = torch.nn.functional.pad
    spans, parts, src, off = [], [], 0, 0
    for (_, r), (_, rp) in zip(levels, padded):
        spans.append((off, r))
        parts.append(pad(fold[src:src + r], (0, 0, 0, rp - r)))
        src, off = src + r, off + rp
    # a fresh allocation each (a copy for a misaligned table of a full rank)
    tables_p = [pad(t, (0, w)) if (w := padded[k // 3][1] - t.shape[1])
                else t.clone() for k, t in enumerate(tables)]
    return padded, torch.cat(parts), tables_p, spans


def _unpad_fold(d_fold, spans):
    """The real ranks' rows of a padded fold's grad, in order."""
    return torch.cat([d_fold[off:off + r] for off, r in spans])


def _forward(field, tangents: bool, xyz, fold, s1, s2, tables):
    global launches_fwd
    levels, dev = _inputs(field, xyz, fold, s1, s2, tables)
    levels, fold, tables, _ = _kernel_operands(levels, fold, tables)
    t = xyz.shape[0]
    sigma = torch.empty((t,), dtype=torch.float32, device=xyz.device)
    geo = torch.empty((t, 15), dtype=torch.float32, device=xyz.device)
    grad = torch.empty((t, 3), dtype=torch.float32, device=xyz.device)
    if t == 0:
        return sigma, geo, grad
    g_arr, r_arr, nl = _level_args(levels)
    _library.launch("mnerf_cp_train_fwd", "fused CP train forward", dev,
                    xyz.data_ptr(), fold.data_ptr(),
                    s1.data_ptr(), s2.data_ptr(), _ptrs(tables), g_arr, r_arr,
                    nl, t, float(field.bound), int(tangents),
                    sigma.data_ptr(), geo.data_ptr(), grad.data_ptr())
    launches_fwd += 1
    return sigma, geo, grad


def _backward(field, tangents: bool, need_dx: bool, xyz, fold, s1, s2,
              tables, dsig, dgeo, dgrad):
    """Launch the backward kernel; returns (dx or None, d_fold, d_s1, d_s2,
    d_tables)."""
    global launches_bwd
    levels, dev = _inputs(field, xyz, fold, s1, s2, tables)
    shapes = [tb.shape for tb in tables]
    levels, fold_k, tables, spans = _kernel_operands(levels, fold, tables)
    t = xyz.shape[0]

    def cot(c, shape):
        if c is None:
            return torch.zeros(shape, dtype=torch.float32, device=xyz.device)
        return c.to(torch.float32).contiguous()

    dsig, dgeo = cot(dsig, (t,)), cot(dgeo, (t, 15))
    dgrad = cot(dgrad, (t, 3)) if tangents else None
    d_tables = [torch.zeros_like(tb) for tb in tables]
    d_fold, d_s1, d_s2 = (torch.zeros_like(fold_k), torch.zeros_like(s1),
                          torch.zeros_like(s2))
    dx = torch.zeros((t, 3), dtype=torch.float32, device=xyz.device) \
        if need_dx else None
    if t > 0:
        g_arr, r_arr, nl = _level_args(levels)
        n_part = _part_floats(dev, sum(r for _, r in levels))
        part = torch.empty((n_part,), dtype=torch.float32, device=xyz.device)
        _library.launch("mnerf_cp_train_bwd", "fused CP train backward", dev,
                        xyz.data_ptr(), fold_k.data_ptr(),
                        s1.data_ptr(), s2.data_ptr(), _ptrs(tables), g_arr,
                        r_arr, nl, t, float(field.bound), int(tangents),
                        int(need_dx), dsig.data_ptr(), dgeo.data_ptr(),
                        None if dgrad is None else dgrad.data_ptr(),
                        None if dx is None else dx.data_ptr(),
                        _ptrs(d_tables), d_fold.data_ptr(), d_s1.data_ptr(),
                        d_s2.data_ptr(), part.data_ptr(), n_part)
        launches_bwd += 1
    if spans is not None:
        d_fold = _unpad_fold(d_fold, spans)
        d_tables = [d[:, :s[1]] for d, s in zip(d_tables, shapes)]
    return dx, d_fold, d_s1, d_s2, d_tables


class DensityWithGradFn(torch.autograd.Function):
    """σ, geo, ∇σ: forward = the tangent forward kernel, backward = the
    tangent backward kernel (d_x only when xyz needs it)."""

    @staticmethod
    def forward(ctx, field, xyz, fold, s1, s2, *tables):
        ctx.field = field
        ctx.save_for_backward(xyz, fold, s1, s2, *tables)
        return _forward(field, True, xyz, fold, s1, s2, tables)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsig, dgeo, dgrad):
        xyz, fold, s1, s2, *tables = ctx.saved_tensors
        dx, d_fold, d_s1, d_s2, d_tables = _backward(
            ctx.field, True, ctx.needs_input_grad[1], xyz, fold, s1, s2,
            tables, dsig, dgeo, dgrad)
        return (None, dx, d_fold, d_s1, d_s2, *d_tables)


class DensityFn(torch.autograd.Function):
    """σ, geo: forward = the density-only forward kernel, backward = the
    density-only backward kernel (d_x = 0 unless need_dx and xyz needs
    it)."""

    @staticmethod
    def forward(ctx, field, need_dx, xyz, fold, s1, s2, *tables):
        ctx.field = field
        ctx.need_dx = need_dx
        ctx.save_for_backward(xyz, fold, s1, s2, *tables)
        sigma, geo, _ = _forward(field, False, xyz, fold, s1, s2, tables)
        return sigma, geo

    @staticmethod
    @once_differentiable
    def backward(ctx, dsig, dgeo):
        xyz, fold, s1, s2, *tables = ctx.saved_tensors
        need_dx = ctx.need_dx and ctx.needs_input_grad[2]
        dx, d_fold, d_s1, d_s2, d_tables = _backward(
            ctx.field, False, need_dx, xyz, fold, s1, s2, tables, dsig, dgeo,
            None)
        if dx is None and ctx.needs_input_grad[2]:
            dx = torch.zeros_like(xyz)
        return (None, None, dx, d_fold, d_s1, d_s2, *d_tables)


def _param_args(params: dict):
    """fold, s1, s2 and the tables (level-major, axis-minor) in the JAX
    (in, out) layout."""
    axes = params["grid"]["axes"]
    tables = [axes[a][li] for li in range(len(axes[0])) for a in range(3)]
    return (params["grid"]["fold"], params["sigma_net"][0]["w"],
            params["sigma_net"][1]["w"], *tables)


def _device_of(xyz: torch.Tensor) -> str:
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused CP train path for device {xyz.device}")
    return xyz.device.type


def density_with_grad_fused(field, params: dict, xyz_flat: torch.Tensor):
    """(T, 3) raw coords → (σ, geo, ∇σ). CPU tensors take the plain version,
    CUDA tensors the kernels."""
    if _device_of(xyz_flat) == "cpu":  # the kernels compute in fp32
        return density_with_grad_reference(float32_field(field), params,
                                           xyz_flat)
    return DensityWithGradFn.apply(field, xyz_flat.contiguous(),
                                   *_param_args(params))


def density_fused(field, params: dict, xyz_flat: torch.Tensor,
                  need_dx: bool = True):
    """(T, 3) raw coords → (σ, geo), differentiable w.r.t. params and, when
    need_dx, xyz. CPU tensors take the plain version, CUDA tensors the
    kernels."""
    if _device_of(xyz_flat) == "cpu":  # the kernels compute in fp32
        return density_reference(float32_field(field), params,
                                 xyz_flat if need_dx else xyz_flat.detach())
    return DensityFn.apply(field, need_dx, xyz_flat.contiguous(),
                           *_param_args(params))
