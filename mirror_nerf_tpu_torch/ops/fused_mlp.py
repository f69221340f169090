"""Fused flagship PE-MLP field, per-sample rows (the σ-noise passes, the
passes with `fused_t` off or a trunk the composite kernel does not take,
and the point queries).

Torch counterpart of `mirror_nerf_tpu/ops/pallas/fused_mlp.py`: the trunk
and heads of `MirrorNeRFField` for any `FusedSpec` the JAX adapters build
(width a multiple of 128, any depth and skips, ≤ 20 posenc frequencies
each, either head), one row per sample out and no compositing, so that a
σ-noise pass can add its noise to raw σ first. A row is 8 float32 values:
lane 0 raw σ, 1:4 sigmoid rgb, 4:7 the unit predicted normal, 7 the sigmoid
mirror probability, 0 where the field lacks the head (as the JAX packing
gives); a σ-only row is raw σ alone.

  * `fused_rays_eval`: per-ray o, d, view dir (N, 3) and depths z (N, S) ->
    (N·S, 8) rows, ray-major (JAX `fused_rays_eval`).
  * `fused_packed_eval`: points xyz and view dirs (B, 3) -> (B, 8) rows
    (JAX `fused_packed_eval`); `fused_field_eval` splits them into
    (σ, rgb, normal | None, mirror | None), or (σ,) when σ-only.
  * `mlp_rows_reference` (points) and `mlp_rays_rows_reference` (rays) are
    the plain PyTorch version (the field modules of models/fields.py). CPU
    tensors take it; CUDA tensors launch a hand-written kernel (sm_90a; see
    each source note), one route a trunk, chosen by spec (`rows_route`):
    every trunk up to width `TC_MAX_WIDTH` (4096; `supports_fused_tc`, the
    default trunk included) the 3×TF32 `wgmma` kernel
    `csrc/fused_mlp_rows_tc.cu` (its cluster instance above 512), counted
    in `launches_general_rays` and `launches_general_points`; wider ones
    the fp32 kernel `csrc/fused_mlp_rows.cu`, counted in
    `launches_wide_rays` and `launches_wide_points`. There is no fallback:
    a kernel that fails to build or launch raises, and so does a trunk
    outside the range.

The view dirs go to the posenc as given (the color head of
`MirrorNeRFField` does not normalize them either). Forward-only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.mathutil import l2_normalize
from ._build import Library, card_index
from ._dtype import float32_field
from .fused_cp import check_ray_inputs, on_cpu, prep
from ..models.fields import FUSED_TC_MAX_WIDTH as TC_MAX_WIDTH
from .fused_mlp_t import _leaves, _pack, check_forward_call, stream_plan, \
    trunk_spec

ROW = 8  # σ, rgb (3), normal (3), mirror

# kernel launches since import (or since a caller last reset them to 0):
# rays (JAX `_kernel_rays`) and points (JAX `_kernel`), the trunks up to
# TC_MAX_WIDTH on csrc/fused_mlp_rows_tc.cu, the wider ones on
# csrc/fused_mlp_rows.cu
launches_general_rays = 0
launches_general_points = 0
launches_wide_rays = 0
launches_wide_points = 0


def mlp_rows_reference(field, params: dict, xyz, dirs=None,
                       sigma_only: bool = False) -> torch.Tensor:
    """The plain PyTorch version (any device): (B, 3) points and view dirs
    -> (B, 8) rows, or (B, 1) raw σ when σ-only."""
    sigma, geo = field.density(params, xyz)
    if sigma_only:
        return sigma[:, None]
    b = xyz.shape[0]
    nrm = (l2_normalize(field.normal_head(params, geo))
           if field.predict_normal else geo.new_zeros((b, 3)))
    mir = (field.mirror_head(params, geo)[:, None]
           if field.predict_mirror_mask else geo.new_zeros((b, 1)))
    return torch.cat([sigma[:, None], field.color(params, geo, dirs), nrm,
                      mir], dim=-1)


def mlp_rays_rows_reference(field, params: dict, rays_o, rays_d, view_dirs,
                            z_vals, sigma_only: bool = False) -> torch.Tensor:
    """The plain version in ray mode (any device): per-ray inputs ->
    (N·S, 8) rows, ray-major."""
    s = z_vals.shape[1]
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
           ).reshape(-1, 3)
    dirs = None if sigma_only else view_dirs.repeat_interleave(s, dim=0)
    return mlp_rows_reference(field, params, xyz, dirs, sigma_only)


# the two routes of `rows_route`: each names its library
ROUTES = ("fused_mlp_rows_tc", "fused_mlp_rows")


def rows_route(field) -> str:
    """The kernel a trunk's rows take on the card, by spec: every trunk of
    width ≤ TC_MAX_WIDTH `csrc/fused_mlp_rows_tc.cu`, a wider one
    `csrc/fused_mlp_rows.cu` (the library's name, `ROUTES`). Raises
    outside `supports_fused`."""
    if not field.supports_fused:
        raise ValueError(
            "the PE-MLP rows kernels take a width that is a positive "
            "multiple of 128, a depth ≥ 1 and at most 20 posenc frequencies "
            f"each (the JAX kernels' range); got width {field.width}, depth "
            f"{field.depth}, frequencies {field.N_emb_xyz}/"
            f"{field.N_emb_dir}")
    return ROUTES[0] if field.supports_fused_tc else ROUTES[1]


def fused_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                    sigma_only: bool) -> torch.Tensor:
    """Launch the rows kernel of the field's trunk (`rows_route`) on the
    current stream. Inputs must be float32, contiguous, on one CUDA device:
    rays_o/rays_d/view_dirs (N, 3), z (N, S). Returns (N·S, 8) rows, or
    (N·S, 1) raw σ when σ-only."""
    launch = (tc_rows_cuda if rows_route(field) == ROUTES[0]
              else general_rows_cuda)
    return launch(field, params, rays_o, rays_d, view_dirs, z_vals,
                  sigma_only)


def _count(field, mode: str) -> None:
    """One launch of the route's kernel in `mode` ("rays" or "points")."""
    name = {ROUTES[0]: f"launches_general_{mode}",
            ROUTES[1]: f"launches_wide_{mode}"}[rows_route(field)]
    globals()[name] += 1


# ---- the rows kernel on the tensor cores, width ≤ TC_MAX_WIDTH
# (csrc/fused_mlp_rows_tc.cu) ----

_TC_LIB = "fused_mlp_rows_tc"
TC_WIDTHS = (128, 256, 384, 512)  # the kernel's template instances
# the entry's negative return codes (see mnerf_mlp_rows_tc)
_TC_REFUSALS = {
    -2: "S < 1",
    -3: "a posenc frequency count is outside [0, 20]",
    -4: f"the width is not one of {TC_WIDTHS} or a multiple of 128 up to "
        f"the limit {TC_MAX_WIDTH}, or the depth < 1",
    -6: "no rays",
    -7: "no CTA, or cluster of CTAs, of the width's shared memory fits the "
        f"card (widths 640 … {TC_MAX_WIDTH} run clusters of 2·⌈width / "
        "512⌉ CTAs)"}
# the entry's arguments before the card and the stream (_build.Library):
# rays_o, rays_d, view_dirs, z_vals, nets, plan, width, depth, n_emb_xyz,
# n_emb_dir, has_normal, has_mirror, sigma_only, n_rays, n_samples, rows
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F32 = (torch.float32,)
_tc_library = Library(_TC_LIB, {
    "mnerf_mlp_rows_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _LL, _I, _P],
    "mnerf_mlp_rows_tc_shape": [_I]}, _TC_REFUSALS)
_plans: dict = {}  # (leaf shapes, device) -> stream_plan on the card


def _plan(params: dict, device) -> torch.Tensor:
    """`stream_plan` of these params as int64 on `device` (cached per
    layout)."""
    key = (tuple(tuple(t.shape) for t in _leaves(params)),
           str(device))
    if key not in _plans:
        _plans[key] = torch.tensor(stream_plan(params)[0],
                                   dtype=torch.int64, device=device)
    return _plans[key]


def tc_cluster_shape(width: int, device: int) -> dict:
    """The cluster instance at a width above 512 on card `device`: the
    CTAs that split a layer's columns (C), the most 64-column parts a CTA
    holds, the weight ring's stages and the clusters of 2C CTAs the card
    holds at once (0: none fits, the launch refuses)."""
    code = _tc_library.entry("mnerf_mlp_rows_tc_shape")(width, device, None)
    if code < 0:
        raise ValueError(f"no cluster instance at width {width}: "
                         f"{_TC_REFUSALS.get(code, code)}")
    out = {}
    for k in ("ctas", "parts", "stages"):
        code, out[k] = divmod(code, 16)
    out["clusters"] = code
    return out


def check_tc_spec(field, params: dict) -> None:
    """A trunk the kernel takes (`supports_fused_tc`), and params of that
    trunk (`trunk_spec`): the plan comes from the params, the instance and
    the posenc from the field."""
    if not field.supports_fused_tc:
        raise ValueError(
            "the PE-MLP rows kernel on the tensor cores takes a width that is "
            f"a multiple of 128 up to the limit {TC_MAX_WIDTH} "
            f"(supports_fused_tc); got width {field.width}, depth "
            f"{field.depth}, frequencies {field.N_emb_xyz}/{field.N_emb_dir}")
    spec = (field.width, field.depth,
            tuple(sorted({i for i in field.skips if 0 < i < field.depth})),
            field.in_xyz, field.in_dir, field.predict_normal,
            field.predict_mirror_mask)
    if trunk_spec(params) != spec:
        raise ValueError(
            f"the params' trunk {trunk_spec(params)} (width, depth, skips, "
            f"posenc rows x/v, normal, mirror) is not the field's {spec}")


def tc_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                 sigma_only: bool) -> torch.Tensor:
    """Launch `csrc/fused_mlp_rows_tc.cu` on the current stream, for any
    trunk of `supports_fused_tc`. Inputs as `fused_rows_cuda` takes
    them."""
    check_forward_call(params, (rays_o, rays_d, view_dirs, z_vals), "rows")
    check_tc_spec(field, params)
    n, s = z_vals.shape
    check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only)
    rows = torch.empty((n * s, 1 if sigma_only else ROW),
                       dtype=torch.float32, device=z_vals.device)
    if n == 0:
        return rows
    with torch.no_grad():
        nets = _pack(params)
    dev = card_index("PE-MLP rows (tensor cores)",
                     ("z_vals", z_vals, _F32, 4), ("nets", nets, _F32, 16))
    _tc_library.launch(
        "mnerf_mlp_rows_tc", "PE-MLP rows (tensor cores)", dev,
        rays_o.data_ptr(), rays_d.data_ptr(),
        None if sigma_only else view_dirs.data_ptr(), z_vals.data_ptr(),
        nets.data_ptr(), _plan(params, z_vals.device).data_ptr(),
        field.width, field.depth, field.N_emb_xyz, field.N_emb_dir,
        int(field.predict_normal), int(field.predict_mirror_mask),
        int(sigma_only), n, s, rows.data_ptr())
    return rows


# ---- the fp32 rows kernel for any trunk (csrc/fused_mlp_rows.cu): the
# route of widths above TC_MAX_WIDTH ----

_ROWS_LIB = "fused_mlp_rows"
MAX_FREQS = 20  # posenc frequencies, x or v (the JAX kernel's 128 lanes)
# the entry's negative return codes (see mnerf_mlp_rows)
_ROWS_REFUSALS = {
    -2: "S < 1",
    -3: f"a posenc frequency count is outside [0, {MAX_FREQS}]",
    -4: "the width is not a positive multiple of 128, or the depth < 1",
    -6: "no rays",
    -7: "the block's samples do not fit the card's shared memory"}
# the offsets table's head slots after the trunk's 3·depth (H_* in the .cu)
_HEADS = (("sigma",), ("xyz_final",), ("dir_enc",), ("rgb",),
          ("normal", 0), ("normal", 1), ("is_mirror", 0), ("is_mirror", 1))

# the entry's arguments before the card and the stream (_build.Library):
# rays_o, rays_d, view_dirs, z_vals, nets, offs, width, depth, n_emb_xyz,
# n_emb_dir, has_normal, has_mirror, sigma_only, n_rays, n_samples, T,
# rows; the tile query: width, n_emb_xyz, n_emb_dir
_rows_library = Library(_ROWS_LIB, {
    "mnerf_mlp_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _LL, _I, _I, _P],
    "mnerf_mlp_rows_tile": [_I, _I, _I]}, _ROWS_REFUSALS)


def rows_layout(field, params: dict) -> tuple:
    """The general rows kernel's view of the parameters: the leaf tensors
    in packing order (trunk (w, b) per layer, then σ,
    xyz_final, dir_enc, rgb, normal 0/1 and is_mirror 0/1 where present)
    and the offsets table (3·depth + 16 int64): per trunk layer i (w, b,
    skip) with skip 1 for i ≥ 1 in `field.skips`, then (w, b) of each head
    slot of `_HEADS`, −1 for a head the field lacks. Each leaf starts at a
    multiple of 4 floats."""
    leaves, table, at = [], [], 0

    def take(t) -> int:
        nonlocal at
        leaves.append(t)
        start = at
        at += -(-t.numel() // 4) * 4
        return start

    for i, lin in enumerate(params["trunk"]):
        table += [take(lin["w"]), take(lin["b"]),
                  int(i > 0 and i in field.skips)]
    for slot in _HEADS:
        lin = params.get(slot[0])
        if lin is not None and len(slot) == 2:
            lin = lin[slot[1]]
        table += [take(lin["w"]), take(lin["b"])] if lin is not None \
            else [-1, -1]
    return leaves, table


_rows_offsets: dict = {}  # (layout key, device) -> the offsets on the card
_rows_tiles: dict = {}  # (width, frequencies, card) -> samples a block


def _rows_nets(field, params: dict, device):
    """(nets, offs): every leaf flattened into one float32 buffer, each
    padded to 4 floats, and the offsets table on `device` (cached per
    layout)."""
    leaves, table = rows_layout(field, params)
    nets = torch.cat([F.pad(t.reshape(-1).to(torch.float32),
                            (0, -t.numel() % 4)) for t in leaves])
    key = (tuple(table), str(device))
    if key not in _rows_offsets:
        _rows_offsets[key] = torch.tensor(table, dtype=torch.int64,
                                          device=device)
    return nets.contiguous(), _rows_offsets[key]


def rows_tile(field, device: int) -> int:
    """Samples a block of the general rows kernel takes for this field on
    card `device`: the largest power of two ≤ 64 whose activations fit
    its shared memory (0: none fits, the launch refuses)."""
    key = (field.width, field.N_emb_xyz, field.N_emb_dir, device)
    if key not in _rows_tiles:
        _rows_tiles[key] = _rows_library.entry("mnerf_mlp_rows_tile")(
            field.width, field.N_emb_xyz, field.N_emb_dir, device, None)
    return _rows_tiles[key]


def general_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                      z_vals, sigma_only: bool) -> torch.Tensor:
    """Launch `csrc/fused_mlp_rows.cu` on the current stream, for any trunk
    of `supports_fused` (the route sends it the widths above TC_MAX_WIDTH;
    a caller may time it on any other). Inputs as `fused_rows_cuda` takes
    them."""
    check_forward_call(params, (rays_o, rays_d, view_dirs, z_vals), "rows")
    rows_route(field)  # raises outside supports_fused
    n, s = z_vals.shape
    check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only)
    rows = torch.empty((n * s, 1 if sigma_only else ROW),
                       dtype=torch.float32, device=z_vals.device)
    if n == 0:
        return rows
    with torch.no_grad():
        nets, offs = _rows_nets(field, params, z_vals.device)
    dev = card_index("PE-MLP rows", ("z_vals", z_vals, _F32, 4),
                     ("nets", nets, _F32, 16))
    _rows_library.launch(
        "mnerf_mlp_rows", "PE-MLP rows", dev, rays_o.data_ptr(),
        rays_d.data_ptr(), None if sigma_only else view_dirs.data_ptr(),
        z_vals.data_ptr(), nets.data_ptr(), offs.data_ptr(), field.width,
        field.depth, field.N_emb_xyz, field.N_emb_dir,
        int(field.predict_normal), int(field.predict_mirror_mask),
        int(sigma_only), n, s, rows_tile(field, dev), rows.data_ptr())
    return rows


def fused_rays_eval(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                    sigma_only: bool = False) -> torch.Tensor:
    """Ray mode: (N, 3) origins/dirs/view dirs + (N, S) depths -> (N·S, 8)
    rows, ray-major ((N·S, 1) raw σ when σ-only). CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if on_cpu(z_vals.device, "fused PE-MLP rows"):
        return mlp_rays_rows_reference(field, params, rays_o, rays_d,
                                       view_dirs, z_vals, sigma_only)
    rows = fused_rows_cuda(field, params, prep(rays_o), prep(rays_d),
                           None if sigma_only else prep(view_dirs),
                           prep(z_vals), sigma_only)
    if z_vals.shape[0]:
        _count(field, "rays")
    return rows


def fused_packed_eval(field, params: dict, xyz, dirs=None,
                      sigma_only: bool = False) -> torch.Tensor:
    """Point mode: (B, 3) raw coords [+ (B, 3) view dirs] -> (B, 8) rows
    ((B, 1) raw σ when σ-only). On the card each point is a one-sample ray
    o = x, d = 0, z = 0 (x + 0·0 is x exactly)."""
    if not sigma_only and dirs is None:
        raise ValueError("fused_packed_eval needs view dirs unless σ-only")
    if on_cpu(xyz.device, "fused PE-MLP rows"):  # fp32, as the kernel
        return mlp_rows_reference(float32_field(field), params, xyz, dirs,
                                  sigma_only)
    x = prep(xyz)
    zeros = torch.zeros_like(x)
    rows = fused_rows_cuda(field, params, x, zeros,
                           None if sigma_only else prep(dirs),
                           zeros[:, :1].contiguous(), sigma_only)
    if x.shape[0]:
        _count(field, "points")
    return rows


def fused_field_eval(field, params: dict, xyz, dirs=None,
                     sigma_only: bool = False) -> tuple:
    """`fused_packed_eval` split into separate tensors: (σ,) when σ-only,
    else (σ, rgb, unit normal | None, mirror | None), None for a head the
    field lacks."""
    rows = fused_packed_eval(field, params, xyz, dirs, sigma_only)
    if sigma_only:
        return (rows[:, 0],)
    return (rows[:, 0], rows[:, 1:4],
            rows[:, 4:7] if field.predict_normal else None,
            rows[:, 7] if field.predict_mirror_mask else None)
