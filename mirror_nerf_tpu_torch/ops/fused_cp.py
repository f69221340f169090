"""Fused CP-grid field kernels: the eval composite, and the per-sample rows
and per-sample-input composite of the σ-noise passes.

Torch counterparts of three adapters in `mirror_nerf_tpu/ops/pallas/
fused_cp.py`, one hand-written kernel `csrc/fused_cp_composite.cu` (sm_90a;
see its source note) in three modes:

  * `fused_cp_rays_composite` (composite mode): per-ray inputs (o, d, view
    dir) and sorted depths z (N, S) in; `weights` (N, S) and, unless
    σ-only, per-ray `opacity`, `rgb` (N, 3), `normal` (N, 3), `mirror` and
    `depth` out. Eval semantics (no σ noise).
  * `fused_cp_rays_eval` (rows mode): the same inputs; per sample `sigma`
    (raw, (N, S)) and, unless σ-only, `rgb3`, `normal3` (N, S, 3, unit) and
    `mirror` (N, S), the JAX keys in the port's sample-major layout. No
    compositing: the renderer's σ-noise passes add noise to raw σ first.
  * `fused_cp_forward_composite` (per-sample-input mode): world positions
    and view dirs (N, S, 3), z and δ (N, S) per sample in (δ_inf = 1e10 on
    each ray's last sample is the caller's); what `fused_cp_rays_composite`
    returns out.

Each has its plain PyTorch version beside it (`cp_rays_composite_reference`,
`cp_rays_rows_reference`, `cp_samples_composite_reference`: the field
modules of models/ + the exclusive-prefix transmittance) and dispatches on
the device of its inputs: the plain version for CPU tensors, the kernel for
CUDA tensors, with no fallback (a kernel that fails to build or launch
raises). The kernel's launches are counted per mode in `launches`,
`launches_rows` and `launches_samples`, each launch through `_build.Library`
(one check, the raw current stream, the device guard in C). Forward-only.

The kernel runs its products on the tensor cores in 3×TF32 (`tf32_split`,
`mma3_reference` are its plain versions) and feeds each layer's output
fragments to the next in registers, so `_pack_nets` hands it every weight
with its K rows in the kernel's fragment order (`c_order`, `quad_order`),
padded to multiples of 8, each level's ranks padded to 16 (`padded_rank`,
the tables likewise in `_pack_tables`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.mathutil import l2_normalize
from ..render.renderer import sigma_activation
from ..train.checkpoints import tree_leaves
from ._build import Library, card_index
from .segment_scan import exp_plain

_LIB = "fused_cp_composite"
_ACTS = ("relu", "softplus")
# the kernel entry's negative return codes (see mnerf_fused_cp_composite)
_REFUSALS = {-1: "the level count is outside [1, 8]",
             -2: "S is outside [1, 256] samples per ray",
             -3: "a level has G < 2 or R < 1",
             -4: "the packed nets disagree with the kernel's layout",
             -5: "the nets exceed the kernel's shared memory",
             -6: "no rays",
             -7: "an unknown mode",
             -8: "a packed rank is not a multiple of 16, or the tables "
                 "exceed 2**31 floats"}
# the kernel's modes (`Mode` in the .cu)
COMPOSITE, ROWS, SAMPLES = 0, 1, 2

# kernel launches since import (or since a caller last reset them to 0), per
# mode: composite, rows, per-sample-input composite
launches = 0
launches_rows = 0
launches_samples = 0


def prefix_weights(sd: torch.Tensor) -> torch.Tensor:
    """(N, S) sd = δ·act(σ) -> compositing weights
    w_i = exp(−Σ_{j<i} sd_j)·(1 − exp(−sd_i)). The prefix is EXCLUSIVE by
    construction, never the inclusive sum minus sd_i: each ray's last sd
    carries δ_inf = 1e10, and fp32 (1e10 + prefix) − 1e10 cancels the
    whole prefix. The exponentials by `exp_plain` (torch.exp on the card;
    on the CPU no MKL, whose fp32 exp faults: F5)."""
    excl = torch.cat([torch.zeros_like(sd[:, :1]),
                      torch.cumsum(sd[:, :-1], dim=-1)], dim=-1)
    return exp_plain(-excl) * (1.0 - exp_plain(-sd))


def cp_rows_reference(field, params: dict, xyz, dirs,
                      sigma_only: bool = False, density=None) -> dict:
    """Per-sample field outputs from world positions xyz and view dirs
    (N, S, 3; dirs unread when σ-only): `sigma` (raw) and, unless σ-only,
    `rgb3`, `normal3` (unit) and `mirror` (any device). `density(params,
    xyz)` replaces `field.density` (ops/fused_hash.py: the plain encoder)."""
    n, s = xyz.shape[:2]
    sigma, geo = (density or field.density)(params, xyz.reshape(-1, 3))
    res = {"sigma": sigma.reshape(n, s)}
    if sigma_only:
        return res
    dirs = l2_normalize(dirs.reshape(-1, 3), eps=1e-12)
    res["rgb3"] = field.color(params, geo, dirs).reshape(n, s, 3)
    res["normal3"] = l2_normalize(field.normal_head(params, geo)
                                  ).reshape(n, s, 3)
    res["mirror"] = field.mirror_head(params, geo).reshape(n, s)
    return res


def _ray_samples(rays_o, rays_d, view_dirs, z_vals):
    """Per-ray inputs -> per-sample positions o + d·z and view dirs."""
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirs = None if view_dirs is None else view_dirs[:, None, :].expand(
        *z_vals.shape, 3)
    return xyz, dirs


def ray_sums(w, rows: dict, z_vals) -> dict:
    """Weights (N, S) and per-sample rows -> the composite's dict: w and
    the per-ray opacity, rgb, normal, mirror and depth."""
    return {"weights": w, "opacity": w.sum(-1),
            "rgb": (w[..., None] * rows["rgb3"]).sum(1),
            "normal": (w[..., None] * rows["normal3"]).sum(1),
            "mirror": (w * rows["mirror"]).sum(-1),
            "depth": (w * z_vals).sum(-1)}


def composite_rows(rows: dict, z_vals, deltas, sigma_only: bool,
                   sigma_act: str) -> dict:
    """Per-sample rows -> the composite's dict: weights from δ·act(σ) by
    the exclusive prefix and, unless σ-only, the per-ray sums."""
    w = prefix_weights(deltas * sigma_activation(rows["sigma"], sigma_act))
    return {"weights": w} if sigma_only else ray_sums(w, rows, z_vals)


def cp_rays_composite_reference(field, params: dict, rays_o, rays_d,
                                view_dirs, z_vals, sigma_only: bool = False,
                                sigma_act: str = "relu",
                                density=None) -> dict:
    """The plain PyTorch version of the composite mode (any device);
    `density` as in `cp_rows_reference`."""
    rows = cp_rows_reference(field, params,
                             *_ray_samples(rays_o, rays_d, view_dirs, z_vals),
                             sigma_only, density)
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                        torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    return composite_rows(rows, z_vals, deltas, sigma_only, sigma_act)


def cp_rays_rows_reference(field, params: dict, rays_o, rays_d, view_dirs,
                           z_vals, sigma_only: bool = False) -> dict:
    """The plain PyTorch version of the rows mode (any device)."""
    return cp_rows_reference(field, params,
                             *_ray_samples(rays_o, rays_d, view_dirs, z_vals),
                             sigma_only)


def cp_samples_composite_reference(field, params: dict, xyz, view_dirs,
                                   z_vals, deltas, sigma_only: bool = False,
                                   sigma_act: str = "relu") -> dict:
    """The plain PyTorch version of the per-sample-input mode (any
    device)."""
    rows = cp_rows_reference(field, params, xyz, view_dirs, sigma_only)
    return composite_rows(rows, z_vals, deltas, sigma_only, sigma_act)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero), as `cvt.rna.tf32.f32` rounds: the low 13 bits of the result are
    zero. Finite inputs."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """The kernel's split of an fp32 operand: hi = tf32_round(x) and
    lo = x − hi, exact in fp32 (hi + lo == x). The kernel hands the tensor
    cores hi and tf32_round(lo)."""
    hi = tf32_round(x)
    return hi, x.to(torch.float32) - hi


def mma3_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3×TF32 products give it, each product exact
    and summed in float64: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with
    a = a_hi + a_lo, b = b_hi + b_lo split by `tf32_split` and each lo
    rounded to TF32 (the dropped a_lo·b_lo is below 2⁻²² of |a||b|)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    a_lo, b_lo = tf32_round(a_lo), tf32_round(b_lo)
    d = torch.float64
    return (a_lo.to(d) @ b_hi.to(d) + a_hi.to(d) @ b_lo.to(d)
            + a_hi.to(d) @ b_hi.to(d))


# The kernel's nets after the fold (`S1` … `M2B` in the .cu), in order:
# name, K rows, N columns, each zero-padded to a multiple of 8 (the biases
# m1b and m2b as they are). σ and geo feed the heads as the σ-net's 16
# output columns, σ's row zero.
NET_LAYOUT = (("s1", 32, 64), ("s2", 64, 16), ("c1", 32, 64),
              ("c2", 64, 64), ("c3", 64, 8), ("n1", 16, 64), ("n2", 64, 8),
              ("m1", 16, 32), ("m2", 32, 8), ("m1b", 1, 32), ("m2b", 1, 1))
NETS = sum(k * n for _, k, n in NET_LAYOUT)  # floats after the fold


def padded_rank(r: int) -> int:
    """A level's rank as the kernel reads it: rounded up to 16 (its
    tables and fold rows zero-padded)."""
    return -(-r // 16) * 16


def c_order(k: int) -> list:
    """K order of a layer fed by the previous layer's C fragments: row
    8k' + p reads input column 8k' + 2(p mod 4) + p div 4 (a lane's C
    columns 2t, 2t+1 are its A columns t, t+4)."""
    return [r - r % 8 + 2 * (r % 4) + (r % 8) // 4 for r in range(k)]


def quad_order(k: int) -> list:
    """K order of the fold and of c1's SH rows: row 16p + 8h + q reads
    input 16p + 4(q mod 4) + 2h + q div 4, so that a lane's A columns t,
    t+4 of k-tiles 2p, 2p+1 are the four adjacent inputs 16p + 4t …
    16p + 4t + 3 (one 16-B table load)."""
    return [r - r % 16 + 4 * (r % 4) + 2 * ((r % 16) // 8) + (r % 8) // 4
            for r in range(k)]


def _plain_parts(params: dict, fold: bool = True) -> list:
    """The fold and the nets, each in its JAX (in, out) layout: fold, s1,
    s2, c1, c2, c3, n1, n2, m1 w, m1 b, m2 w, m2 b. Without the fold (the
    hash grid), an empty (0, 32) in its place."""
    s, c, nn_, m = (params["sigma_net"], params["color_net"],
                    params["normal"], params["is_mirror"])
    head = (params["grid"]["fold"] if fold
            else s[0]["w"].new_zeros((0, 32)))
    return [head, s[0]["w"], s[1]["w"], c[0]["w"],
            c[1]["w"], c[2]["w"], nn_[0]["w"], nn_[1]["w"], m[0]["w"],
            m[0]["b"], m[1]["w"], m[1]["b"]]


def net_index(levels, in_dim: int = 32) -> torch.Tensor:
    """Where each float of the kernel's packed nets comes from: an index
    into the plain parts concatenated (`_plain_parts`, flattened) with one
    zero appended, the zero for every padded row and column. `in_dim` is
    the σ-net's input width: the fold's 32, or the hash grid's 2·levels
    (≤ 32; s1's rows past it read zeros)."""
    sum_r = sum(r for _, r in levels)
    shapes = [(sum_r, 32), (in_dim, 64), (64, 16), (31, 64), (64, 64), (64, 3),
              (15, 64), (64, 3), (15, 32), (1, 32), (32, 1), (1, 1)]
    offs = [0]
    for k, n in shapes:
        offs.append(offs[-1] + k * n)
    zero = offs[-1]

    def rows(part, src_rows, n_pad):
        """(len(src_rows), n_pad) indices: row j reads row src_rows[j] of
        the part (None: zeros), columns past its width zeros."""
        n = shapes[part][1]
        idx = torch.full((len(src_rows), n_pad), zero, dtype=torch.long)
        for j, r in enumerate(src_rows):
            if r is not None:
                idx[j, :n] = offs[part] + r * n + torch.arange(n)
        return idx

    fold, r0 = [], 0
    for _, r in levels:
        fold += [r0 + q if q < r else None
                 for q in quad_order(padded_rank(r))]
        r0 += r
    geo = [None] + list(range(15))  # the σ column reads a zero row
    heads = [geo[j] for j in c_order(16)]
    c1 = quad_order(16) + [None if r is None else 16 + r for r in heads]
    # each kernel matrix: its plain part and the part's row for each K row
    s1 = [r if r < in_dim else None for r in c_order(32)]
    src = {"s1": (1, s1), "s2": (2, c_order(64)), "c1": (3, c1),
           "c2": (4, c_order(64)), "c3": (5, c_order(64)), "n1": (6, heads),
           "n2": (7, c_order(64)), "m1": (8, heads), "m2": (10, c_order(32)),
           "m1b": (9, [0]), "m2b": (11, [0])}
    parts = [rows(0, fold, 32)]
    for name, k, n in NET_LAYOUT:
        part, src_rows = src[name]
        assert len(src_rows) == k, name
        parts.append(rows(part, src_rows, n))
    return torch.cat([p.reshape(-1) for p in parts])


_net_index: dict = {}  # (levels, in_dim, device) -> net_index there


def _pack_nets(params: dict, levels) -> torch.Tensor:
    """The fold and the nets as the kernel reads them: the fold's rows in
    `quad_order` per level (ranks padded to 16), then `NET_LAYOUT`, each
    weight's K rows in `c_order` (c1's SH rows in `quad_order`), zero
    rows for σ, columns padded to 8. No levels (the hash grid's kernel):
    no fold, s1's K the encoder's width padded to 32."""
    parts = _plain_parts(params, fold=bool(levels))
    flat = torch.cat([p.reshape(-1) for p in parts]
                     + [parts[0].new_zeros(1)]).to(torch.float32)
    in_dim = parts[1].shape[0]
    key = (tuple(levels), in_dim, str(flat.device))
    if key not in _net_index:
        _net_index[key] = net_index(levels, in_dim).to(flat.device)
    return flat[_net_index[key]]


def table_offsets(levels) -> list:
    """The float offset of each (level, axis) table in `_pack_tables`'
    buffer, level-major: each (G, R) table takes G·padded_rank(R)."""
    offsets, off = [], 0
    for g, r in levels:
        for _ in range(3):
            offsets.append(off)
            off += g * padded_rank(r)
    return offsets


def _pack_tables(params: dict, levels):
    """All (level, axis) tables in one flat buffer, each (G, R) table
    zero-padded to (G, padded_rank(R)), + their float offsets."""
    axes = params["grid"]["axes"]
    parts = []
    for li, (_, r) in enumerate(levels):
        for a in range(3):
            t = axes[a][li]
            if padded_rank(r) != r:
                t = torch.nn.functional.pad(t, (0, padded_rank(r) - r))
            parts.append(t.reshape(-1))
    return torch.cat(parts).to(torch.float32), table_offsets(levels)


def check_inputs(dev, ins: dict) -> None:
    """A kernel's inputs: each name -> (tensor, wanted shape), a contiguous
    float32 tensor of that shape on `dev`."""
    for name, (t, want) in ins.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous float32 {want} tensor on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only: bool):
    """A kernel's ray inputs: contiguous float32 on z's device,
    rays_o/rays_d/view_dirs (N, 3) (view_dirs unread when σ-only), z (N, S).
    Returns the tensors the kernel reads."""
    n, s = z_vals.shape
    ins = {"rays_o": (rays_o, (n, 3)), "rays_d": (rays_d, (n, 3)),
           "z_vals": (z_vals, (n, s))}
    if not sigma_only:
        ins["view_dirs"] = (view_dirs, (n, 3))
    check_inputs(z_vals.device, ins)
    return [t for t, _ in ins.values()]


def on_cpu(dev, what: str) -> bool:
    """Dispatch of the fused adapters: True for the CPU (the plain
    version), False for CUDA (the kernel); any other device raises."""
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no {what} path for device {dev}")
    return False


def prep(t):
    """An adapter's input as the kernels take it (None stays None)."""
    return None if t is None else t.to(torch.float32).contiguous()


def split_per_ray(weights, per_ray) -> dict:
    """A composite kernel's outputs as the adapter's dict: weights, and
    per_ray's columns [opacity, rgb, normal, mirror, depth] unless None."""
    res = {"weights": weights}
    if per_ray is not None:
        res.update(opacity=per_ray[:, 0], rgb=per_ray[:, 1:4],
                   normal=per_ray[:, 4:7], mirror=per_ray[:, 7],
                   depth=per_ray[:, 8])
    return res


def _ptr(t):
    return None if t is None else t.data_ptr()


# the entry's arguments before the card and the stream (_build.Library):
# pos, rays_d, vdir, z, deltas, tables, nets, n_nets, level_g, level_r,
# table_off, n_levels, n_rays, S, bound, mode, sigma_only, softplus,
# weights, per_ray, rows
_P, _I = ctypes.c_void_p, ctypes.c_int
_library = Library(_LIB, {"mnerf_fused_cp_composite": [
    _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I,
    ctypes.c_float, _I, _I, _I, _P, _P, _P]}, _REFUSALS)
_F32 = (torch.float32,)
_level_args: dict = {}  # levels -> the entry's host arrays


def _levels_c(levels):
    """level_g, level_r (padded ranks) and table_off as ctypes arrays."""
    if levels not in _level_args:
        n = len(levels)
        offs = table_offsets(levels)
        _level_args[levels] = (
            (ctypes.c_int * n)(*[g for g, _ in levels]),
            (ctypes.c_int * n)(*[padded_rank(r) for _, r in levels]),
            (ctypes.c_longlong * len(offs))(*offs))
    return _level_args[levels]


def _launch(field, params: dict, mode: int, ins: dict, n: int, s: int,
            sigma_only: bool, sigma_act: str, outs: dict) -> None:
    """Checks shared by the three modes, then one launch on the current
    stream. `ins` maps the kernel's inputs (pos, rays_d, vdir, z, deltas;
    None where the mode does not read it) to checked tensors, `outs` its
    outputs (weights, per_ray, rows) to allocated ones."""
    global launches, launches_rows, launches_samples
    # the guard first, so that it holds whatever else is wrong with the call
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*ins.values(), *tree_leaves(params))):
        raise ValueError(
            "the fused CP kernels are forward-only, and an input or a "
            "parameter requires grad: run them under torch.no_grad(), or "
            "train through the differentiable kernels of "
            "ops/fused_cp_train.py")
    z = ins["z"]
    if not z.is_cuda:
        raise ValueError(f"the fused CP kernel needs CUDA tensors, got "
                         f"{z.device}")
    if sigma_act not in _ACTS:
        raise ValueError(f"sigma_act must be one of {_ACTS}")
    if not field.supports_fused_cp:
        raise ValueError("the fused CP kernel needs the default net dims "
                         "(TPUGridField.supports_fused_cp)")
    if n == 0:
        return
    levels = tuple(field.grid_levels)
    nets = _pack_nets(params, levels)
    tables, _ = _pack_tables(params, levels)
    dev = card_index("fused CP", ("z_vals", z, _F32, 4),
                     ("nets", nets, _F32, 16), ("tables", tables, _F32, 16))
    g_arr, r_arr, off_arr = _levels_c(levels)
    _library.launch(
        "mnerf_fused_cp_composite", "fused CP", dev, _ptr(ins["pos"]),
        _ptr(ins["rays_d"]), _ptr(ins["vdir"]), z.data_ptr(),
        _ptr(ins["deltas"]), tables.data_ptr(), nets.data_ptr(),
        nets.numel(), g_arr, r_arr, off_arr, len(levels), n, s,
        float(field.bound), mode, int(sigma_only),
        int(sigma_act == "softplus"), _ptr(outs.get("weights")),
        _ptr(outs.get("per_ray")), _ptr(outs.get("rows")))
    if mode == COMPOSITE:
        launches += 1
    elif mode == ROWS:
        launches_rows += 1
    else:
        launches_samples += 1


def _composite_outputs(n: int, s: int, sigma_only: bool, dev) -> dict:
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    per_ray = None if sigma_only else torch.empty(
        (n, 9), dtype=torch.float32, device=dev)
    return {"weights": weights, "per_ray": per_ray}


def fused_cp_composite_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool, sigma_act: str):
    """Launch the composite mode on the current stream. Inputs must be
    float32, contiguous, on one CUDA device: rays_o/rays_d/view_dirs (N, 3),
    z (N, S). Returns (weights (N, S), per_ray (N, 9) or None), per_ray's
    columns [opacity, rgb, normal, mirror, depth]."""
    n, s = z_vals.shape
    o, d, z, *v = check_ray_inputs(rays_o, rays_d, view_dirs, z_vals,
                                   sigma_only)
    outs = _composite_outputs(n, s, sigma_only, z.device)
    _launch(field, params, COMPOSITE,
            {"pos": o, "rays_d": d, "vdir": v[0] if v else None, "z": z,
             "deltas": None}, n, s, sigma_only, sigma_act, outs)
    return outs["weights"], outs["per_ray"]


def fused_cp_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                       z_vals, sigma_only: bool):
    """Launch the rows mode on the current stream (inputs as
    `fused_cp_composite_cuda`). Returns rows (N, S, 8) [raw σ, rgb, unit
    normal, mirror], or (N, S) raw σ when σ-only."""
    n, s = z_vals.shape
    o, d, z, *v = check_ray_inputs(rays_o, rays_d, view_dirs, z_vals,
                                   sigma_only)
    rows = torch.empty((n, s) if sigma_only else (n, s, 8),
                       dtype=torch.float32, device=z.device)
    _launch(field, params, ROWS,
            {"pos": o, "rays_d": d, "vdir": v[0] if v else None, "z": z,
             "deltas": None}, n, s, sigma_only, "relu", {"rows": rows})
    return rows


def fused_cp_samples_composite_cuda(field, params: dict, xyz, view_dirs,
                                    z_vals, deltas, sigma_only: bool,
                                    sigma_act: str):
    """Launch the per-sample-input mode on the current stream. Inputs:
    float32, contiguous, on one CUDA device; xyz/view_dirs (N, S, 3),
    z/δ (N, S). Returns (weights (N, S), per_ray (N, 9) or None)."""
    n, s = z_vals.shape
    ins = {"xyz": (xyz, (n, s, 3)), "z_vals": (z_vals, (n, s)),
           "deltas": (deltas, (n, s))}
    if not sigma_only:
        ins["view_dirs"] = (view_dirs, (n, s, 3))
    check_inputs(z_vals.device, ins)
    outs = _composite_outputs(n, s, sigma_only, z_vals.device)
    _launch(field, params, SAMPLES,
            {"pos": xyz, "rays_d": None,
             "vdir": None if sigma_only else view_dirs, "z": z_vals,
             "deltas": deltas}, n, s, sigma_only, sigma_act, outs)
    return outs["weights"], outs["per_ray"]


def fused_cp_rays_composite(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool = False,
                            sigma_act: str = "relu") -> dict:
    """Composite-mode adapter: weights (N, S) always; plus per-ray
    opacity/rgb/normal/mirror/depth unless sigma_only. CPU tensors take the
    plain version; CUDA tensors the kernel."""
    if on_cpu(z_vals.device, "fused CP"):
        return cp_rays_composite_reference(field, params, rays_o, rays_d,
                                           view_dirs, z_vals, sigma_only,
                                           sigma_act)
    return split_per_ray(*fused_cp_composite_cuda(
        field, params, prep(rays_o), prep(rays_d),
        None if sigma_only else prep(view_dirs), prep(z_vals), sigma_only,
        sigma_act))


def fused_cp_rays_eval(field, params: dict, rays_o, rays_d, view_dirs,
                       z_vals, sigma_only: bool = False) -> dict:
    """Rows-mode adapter: (N, 3) o/d/view dirs + (N, S) depths -> per
    sample `sigma` (N, S) raw, plus `rgb3`, `normal3` (N, S, 3) and `mirror`
    (N, S) unless sigma_only. CPU tensors take the plain version; CUDA
    tensors the kernel (the values are views of its (N, S, 8) rows)."""
    if on_cpu(z_vals.device, "fused CP"):
        return cp_rays_rows_reference(field, params, rays_o, rays_d,
                                      view_dirs, z_vals, sigma_only)
    rows = fused_cp_rows_cuda(field, params, prep(rays_o), prep(rays_d),
                              None if sigma_only else prep(view_dirs),
                              prep(z_vals), sigma_only)
    if sigma_only:
        return {"sigma": rows}
    return {"sigma": rows[..., 0], "rgb3": rows[..., 1:4],
            "normal3": rows[..., 4:7], "mirror": rows[..., 7]}


def fused_cp_forward_composite(field, params: dict, xyz, view_dirs, z_vals,
                               deltas, sigma_only: bool = False,
                               sigma_act: str = "relu") -> dict:
    """Per-sample-input composite: world positions xyz and view dirs
    (N, S, 3), depths z and intervals δ (N, S) (δ_inf = 1e10 on each ray's
    last sample) -> what `fused_cp_rays_composite` returns. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if on_cpu(z_vals.device, "fused CP"):
        return cp_samples_composite_reference(field, params, xyz, view_dirs,
                                              z_vals, deltas, sigma_only,
                                              sigma_act)
    return split_per_ray(*fused_cp_samples_composite_cuda(
        field, params, prep(xyz), None if sigma_only else prep(view_dirs),
        prep(z_vals), prep(deltas), sigma_only, sigma_act))
