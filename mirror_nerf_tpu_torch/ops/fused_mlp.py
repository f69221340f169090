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
    the layer-major 3×TF32 `wgmma` GEMMs of `csrc/fused_mlp_layers.cu`
    (`layers_rows_cuda`: the weights packed once a params, `pack_layers`;
    the samples in chunks under `WORKSPACE_CAP`, `layers_plan`), counted
    in `launches_wide_rays` and `launches_wide_points`. There is no
    fallback: a kernel that fails to build or launch raises, and so does a
    trunk outside the range.

The view dirs go to the posenc as given (the color head of
`MirrorNeRFField` does not normalize them either). Forward-only.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from collections import OrderedDict

import torch

from ..core.mathutil import l2_normalize
from ._build import Library, card_index
from ._dtype import float32_field
from .fused_cp import check_ray_inputs, on_cpu, prep, tf32_round
from ..models.fields import FUSED_TC_MAX_WIDTH as TC_MAX_WIDTH
from .fused_mlp_t import _leaves, _pack, _pad, check_forward_call, \
    stream_plan, trunk_spec

ROW = 8  # σ, rgb (3), normal (3), mirror

# kernel launches since import (or since a caller last reset them to 0):
# rays (JAX `_kernel_rays`) and points (JAX `_kernel`), the trunks up to
# TC_MAX_WIDTH on csrc/fused_mlp_rows_tc.cu, the wider ones on
# csrc/fused_mlp_layers.cu (one a call, however many chunks and layers)
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
ROUTES = ("fused_mlp_rows_tc", "fused_mlp_layers")


def rows_route(field) -> str:
    """The kernel a trunk's rows take on the card, by spec: every trunk of
    width ≤ TC_MAX_WIDTH `csrc/fused_mlp_rows_tc.cu`, a wider one
    `csrc/fused_mlp_layers.cu` (the library's name, `ROUTES`). Raises
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
              else layers_rows_cuda)
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
    trunk (`check_params_spec`)."""
    if not field.supports_fused_tc:
        raise ValueError(
            "the PE-MLP rows kernel on the tensor cores takes a width that is "
            f"a multiple of 128 up to the limit {TC_MAX_WIDTH} "
            f"(supports_fused_tc); got width {field.width}, depth "
            f"{field.depth}, frequencies {field.N_emb_xyz}/{field.N_emb_dir}")
    check_params_spec(field, params)


def check_params_spec(field, params: dict) -> None:
    """Params of the field's trunk (`trunk_spec`): a rows kernel's plan
    comes from the params, its width and posenc from the field."""
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


# ---- the layer-major rows kernel, the route of widths above TC_MAX_WIDTH
# (csrc/fused_mlp_layers.cu) ----

_LAYERS_LIB = "fused_mlp_layers"
MAX_FREQS = 20  # posenc frequencies, x or v (the JAX kernel's 128 lanes)
TILE_M = TILE_N = 128  # samples and columns of an output tile (BM, BN)
TILE_K = 16  # K values of a tile of an operand (two k-steps of 8)
TILE = 4 * TILE_M * 8  # floats of an operand tile: [hi, lo] × two k-steps
# bytes of workspace (a chunk's activations) one call may take: the chunk
# is the largest multiple of TILE_M samples whose buffers fit
WORKSPACE_CAP = 2 << 30
PLAN_HEADER, PLAN_REC = 24, 40  # the plan's header, a GEMM's record
PLAN_WS = 18  # the header's entry of the workspace's floats
_ACTS = {"none": 0, "relu": 1, "leaky": 2}
# the fp32 leaves of the final dots, in the plan's header order
FINISH_LEAVES = ("sigma.w", "sigma.b", "rgb.w", "rgb.b", "normal1.w",
                 "normal1.b", "mirror1.w", "mirror1.b")
# the entry's negative return codes (see mnerf_mlp_layers)
_LAYERS_REFUSALS = {
    -2: "S < 1",
    -3: f"a posenc frequency count is outside [0, {MAX_FREQS}]",
    -4: "the width is not a positive multiple of 128",
    -6: "no rays",
    -7: "the layer plan is malformed",
    -8: f"not one tile of {TILE_M} samples fits the workspace cap of "
        f"{WORKSPACE_CAP >> 30} GiB at this width",
    -9: "the workspace is smaller than the plan takes"}
# the entry's arguments before the card and the stream (_build.Library):
# rays_o, rays_d, view_dirs, z_vals, nets, plan (host), workspace, its
# floats, width, n_emb_xyz, n_emb_dir, sigma_only, n_rays, n_samples, rows
_layers_library = Library(_LAYERS_LIB, {
    "mnerf_mlp_layers": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                         _LL, _I, _P]}, _LAYERS_REFUSALS)


def layer_gemms(width: int, depth: int, skips: tuple, pe: int, dpe: int,
                has_n: bool, has_m: bool, sigma_only: bool = False) -> list:
    """The GEMMs of a chunk in launch order, each (segments, ranges): the K
    segments [(A buffer, the weight's first row, rows)], posenc rows first
    in a skip layer, and the column ranges [(leaf, columns, activation,
    split destination | None, fp32 destination | None)]. Buffers: "pe_x",
    "pe_v" (the posencs), "h0", "h1" (hidden layers as the next GEMM's A),
    "h" (the last trunk layer), "normal", "mirror", "color" (fp32 rows, the
    final dots' inputs). σ-only: the trunk alone, its last layer fp32
    only."""
    hs = ("h0", "h1")
    gemms = []
    for i in range(depth):
        segs = [("pe_x", 0, pe)] if i == 0 or i in skips else []
        if i:
            segs.append((hs[(i - 1) % 2], pe if i in skips else 0, width))
        last = i == depth - 1
        gemms.append((segs, [(f"trunk{i}", width, "relu",
                              None if last and sigma_only else hs[i % 2],
                              "h" if last else None)]))
    if sigma_only:
        return gemms
    h, xf = hs[(depth - 1) % 2], hs[depth % 2]
    ranges = [("xyz_final", width, "none", xf, None)]
    if has_n:
        ranges.append(("normal0", width // 2, "none", None, "normal"))
    if has_m:
        ranges.append(("mirror0", width // 2, "leaky", None, "mirror"))
    gemms.append(([(h, 0, width)], ranges))
    gemms.append(([(xf, 0, width), ("pe_v", width, dpe)],
                  [("dir_enc", width // 2, "relu", None, "color")]))
    return gemms


def buffer_floats(width: int, pe: int, dpe: int) -> dict:
    """Floats a sample of each buffer takes: a split one 2 × its K (padded
    to TILE_K), an fp32 one its columns."""
    k = {"pe_x": _pad(pe, TILE_K), "pe_v": _pad(dpe, TILE_K), "h0": width,
         "h1": width}
    return {**{b: 2 * v for b, v in k.items()}, "h": width,
            "normal": width // 2, "mirror": width // 2, "color": width // 2}


def _k_tiles(buffer: str, floats: dict) -> int:
    return floats[buffer] // (2 * TILE_K)


def _gemm_tiles(segs: list, ranges: list, floats: dict) -> tuple:
    """(N tiles, K tiles) of a GEMM's B."""
    return (sum(_pad(r[1], TILE_N) for r in ranges) // TILE_N,
            sum(_k_tiles(b, floats) for b, _, _ in segs))


def _buffers(gemms: list, sigma_only: bool) -> list:
    """The buffers a chunk's GEMMs and final dots use, in first use."""
    used = ["pe_x"] + ([] if sigma_only else ["pe_v"])
    for segs, ranges in gemms:
        for name in [b for b, _, _ in segs] + [
                d for r in ranges for d in r[3:] if d]:
            if name not in used:
                used.append(name)
    return used


def _fp32_leaves(spec: tuple) -> list:
    """(name, floats) of each fp32 leaf of the packed buffer: the ranges'
    biases, then the final dots' leaves."""
    width, depth, _, _, _, has_n, has_m = spec
    wh = width // 2
    out = [(f"trunk{i}.b", width) for i in range(depth)]
    out += [("xyz_final.b", width)] + [("normal0.b", wh)] * has_n
    out += [("mirror0.b", wh)] * has_m + [("dir_enc.b", wh)]
    out += [("sigma.w", width), ("sigma.b", 1), ("rgb.w", 3 * wh),
            ("rgb.b", 3)]
    out += [("normal1.w", 3 * wh), ("normal1.b", 3)] * has_n
    out += [("mirror1.w", wh), ("mirror1.b", 1)] * has_m
    return out


@functools.lru_cache(maxsize=None)
def layers_layout(spec: tuple) -> dict:
    """The packed buffer of a trunk (`trunk_spec`): "b", the float offset of
    each GEMM's B tiles (`layer_gemms`, full), "leaves", each fp32 leaf's
    offset (a multiple of 4 floats), and "floats", its length."""
    floats = buffer_floats(spec[0], spec[3], spec[4])
    b, at = [], 0
    for segs, ranges in layer_gemms(*spec):
        b.append(at)
        nt, kt = _gemm_tiles(segs, ranges, floats)
        at += nt * kt * TILE
    leaves = {}
    for name, size in _fp32_leaves(spec):
        leaves[name] = at
        at += _pad(size, 4)
    return {"b": b, "leaves": leaves, "floats": at}


def tile_planes(t: torch.Tensor) -> torch.Tensor:
    """An fp32 (R, K) operand, R a multiple of 128 and K of TILE_K, as the
    kernel's tiles: tile (R/128, K/TILE_K) after tile, row tiles outer, each
    [hi, lo] × two k-steps of 128 rows × 8 K values (K-major; hi =
    tf32_round(x), lo = tf32_round(x − hi)), in the 32-byte swizzle: the
    16-B half h of row r holds the k-step's values 4(h ^ (r/4 mod 2)) …"""
    hi = tf32_round(t)
    lo = tf32_round(t - hi)
    r, k = t.shape
    x = torch.stack([hi, lo]).reshape(2, r // 128, 128, k // TILE_K, 2, 2, 4)
    odd = (torch.arange(128, device=t.device) // 4 % 2).bool()
    x = torch.where(odd.view(1, 1, -1, 1, 1, 1, 1), x.flip(5), x)
    return x.permute(1, 3, 0, 4, 2, 5, 6).reshape(-1)


def _named(params: dict) -> dict:
    """The field's linears by the names `layer_gemms` and FINISH_LEAVES
    use."""
    named = {f"trunk{i}": lin for i, lin in enumerate(params["trunk"])}
    for k in ("xyz_final", "dir_enc", "sigma", "rgb"):
        named[k] = params[k]
    for k, head in (("normal", "normal"), ("mirror", "is_mirror")):
        if head in params:
            named[f"{k}0"], named[f"{k}1"] = params[head]
    return named


def gemm_weights(named: dict, segs: list, ranges: list,
                 floats: dict) -> torch.Tensor:
    """A GEMM's B as an fp32 (N, K) matrix before `tile_planes`: each range
    its columns, padded to TILE_N, the transposed weight's rows of each K
    segment at the segment's K, padded to TILE_K; zeros elsewhere."""
    w0 = named[ranges[0][0]]["w"]
    nt, kt = _gemm_tiles(segs, ranges, floats)
    bt = w0.new_zeros((nt * TILE_N, kt * TILE_K), dtype=torch.float32)
    n0 = 0
    for leaf, n, *_ in ranges:
        w = named[leaf]["w"]
        k0 = 0
        for buf, row0, rows in segs:
            bt[n0:n0 + n, k0:k0 + rows] = w[row0:row0 + rows].t()
            k0 += _k_tiles(buf, floats) * TILE_K
        n0 += _pad(n, TILE_N)
    return bt


def pack_layers(params: dict) -> torch.Tensor:
    """All weights as the kernel reads them (`layers_layout`): each GEMM's
    B in `tile_planes`, then the fp32 leaves."""
    spec = trunk_spec(params)
    lay = layers_layout(spec)
    named = _named(params)
    floats = buffer_floats(spec[0], spec[3], spec[4])
    out = params["trunk"][0]["w"].new_zeros(lay["floats"],
                                            dtype=torch.float32)
    for (segs, ranges), off in zip(layer_gemms(*spec), lay["b"]):
        t = tile_planes(gemm_weights(named, segs, ranges, floats))
        out[off:off + t.numel()] = t
    for name, off in lay["leaves"].items():
        leaf, part = name.split(".")
        v = named[leaf][part].reshape(-1)
        out[off:off + v.numel()] = v
    return out


NETS_CACHE = 4  # packed buffers kept (each ~370 MB at width 4224)
_nets_cache: OrderedDict = OrderedDict()


def _layers_nets(params: dict) -> torch.Tensor:
    """`pack_layers` of these params, packed once and kept while every
    leaf is the same tensor at the same version (an in-place update
    repacks); the last NETS_CACHE buffers are kept."""
    leaves = _leaves(params)
    key = tuple((id(t), t._version) for t in leaves)
    hit = _nets_cache.get(key)
    if hit is not None and all(ref() is t for ref, t in zip(hit[0], leaves)):
        _nets_cache.move_to_end(key)
        return hit[1]
    nets = pack_layers(params)
    _nets_cache[key] = ([weakref.ref(t) for t in leaves], nets)
    if len(_nets_cache) > NETS_CACHE:
        _nets_cache.popitem(last=False)
    return nets


def chunk_rows(spec: tuple, sigma_only: bool, m: int,
               cap: int = WORKSPACE_CAP) -> int:
    """Samples a chunk of m takes: the largest multiple of TILE_M whose
    buffers fit `cap` bytes, at most m padded to TILE_M (0: not one tile
    fits, and the entry refuses)."""
    floats = buffer_floats(spec[0], spec[3], spec[4])
    row = 4 * sum(floats[b] for b in _buffers(layer_gemms(*spec, sigma_only),
                                              sigma_only))
    return min(cap // row // TILE_M * TILE_M, _pad(m, TILE_M))


def layers_plan(spec: tuple, sigma_only: bool, m: int,
                cap: int = WORKSPACE_CAP) -> list:
    """The plan `csrc/fused_mlp_layers.cu` runs for m samples of a trunk
    (`trunk_spec`), int64: the header (chunk samples, GEMMs, the posencs'
    K tiles and workspace offsets, the final dots' fp32 inputs and leaves,
    workspace floats; zeros to PLAN_HEADER), then a record a GEMM (B
    offset, N tiles, K tiles, K segments, (A offset, K tiles) × 2, ranges,
    (first column, columns, activation, split K tiles, split offset, fp32
    offset, fp32 row stride, bias offset) × 3; unused −1 / 0, zeros to
    PLAN_REC). The workspace holds each buffer the plan uses for one
    chunk."""
    width, pe, dpe = spec[0], spec[3], spec[4]
    gemms = layer_gemms(*spec, sigma_only)
    rows = chunk_rows(spec, sigma_only, m, cap)
    floats = buffer_floats(width, pe, dpe)
    off, at = {}, 0
    for b in _buffers(gemms, sigma_only):
        off[b] = at
        at += rows * floats[b]
    lay = layers_layout(spec)
    plan = [rows, len(gemms), _k_tiles("pe_x", floats), off["pe_x"],
            0 if sigma_only else _k_tiles("pe_v", floats), off.get("pe_v", -1)]
    plan += [off.get(b, -1) for b in ("h", "color", "normal", "mirror")]
    plan += [lay["leaves"].get(k, -1) for k in FINISH_LEAVES] + [at]
    plan += [0] * (PLAN_HEADER - len(plan))
    for (segs, ranges), b in zip(gemms, lay["b"]):
        rec = [b, *_gemm_tiles(segs, ranges, floats), len(segs)]
        for i in range(2):
            rec += ([off[segs[i][0]], _k_tiles(segs[i][0], floats)]
                    if i < len(segs) else [-1, 0])
        rec.append(len(ranges))
        n0 = 0
        for leaf, n, act, split, f32 in ranges:
            rec += [n0, n, _ACTS[act],
                    _k_tiles(split, floats) if split else 0,
                    off[split] if split else -1, off[f32] if f32 else -1,
                    floats[f32] if f32 else 0, lay["leaves"][f"{leaf}.b"]]
            n0 += _pad(n, TILE_N)
        plan += rec + [0] * (PLAN_REC - len(rec))
    return plan


def layers_rows_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                     z_vals, sigma_only: bool) -> torch.Tensor:
    """Launch `csrc/fused_mlp_layers.cu` on the current stream, for any
    trunk of `supports_fused` (the route sends it the widths above
    TC_MAX_WIDTH; a caller may time it on any other). Inputs as
    `fused_rows_cuda` takes them."""
    check_forward_call(params, (rays_o, rays_d, view_dirs, z_vals), "rows")
    rows_route(field)  # raises outside supports_fused
    check_params_spec(field, params)
    n, s = z_vals.shape
    check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only)
    rows = torch.empty((n * s, 1 if sigma_only else ROW),
                       dtype=torch.float32, device=z_vals.device)
    if n == 0:
        return rows
    with torch.no_grad():
        nets = _layers_nets(params)
    plan = torch.tensor(layers_plan(trunk_spec(params), sigma_only, n * s),
                        dtype=torch.int64)
    ws = torch.empty(int(plan[PLAN_WS]), dtype=torch.float32,
                     device=z_vals.device)
    dev = card_index("PE-MLP rows (layer-major)",
                     ("z_vals", z_vals, _F32, 4), ("nets", nets, _F32, 16))
    _layers_library.launch(
        "mnerf_mlp_layers", "PE-MLP rows (layer-major)", dev,
        rays_o.data_ptr(), rays_d.data_ptr(),
        None if sigma_only else view_dirs.data_ptr(), z_vals.data_ptr(),
        nets.data_ptr(), plan.data_ptr(), ws.data_ptr(), ws.numel(),
        field.width, field.N_emb_xyz, field.N_emb_dir, int(sigma_only), n, s,
        rows.data_ptr())
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
