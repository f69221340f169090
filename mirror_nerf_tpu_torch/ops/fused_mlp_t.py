"""Fused flagship PE-MLP field + per-ray compositing (the flagship's eval
kernel).

Torch counterpart of `fused_t_rays_eval` in
`mirror_nerf_tpu/ops/pallas/fused_mlp_t.py`, same contract: per-ray inputs
(o, d, view dir) and sorted depths z (N, S) in; a dict out with `weights`
(N, S) and, unless σ-only, per-ray `opacity`, `rgb` (N, 3), `depth`, and
`normal` (N, 3) and `mirror` for a field with those heads. The view dirs go
to the posenc as given (the color head of `MirrorNeRFField` does not
normalize them either).

  * `mlp_rays_composite_reference` is the plain PyTorch version: the field
    modules of models/fields.py + the exclusive-prefix transmittance.
  * `fused_t_composite_cuda` launches the hand-written kernel
    `csrc/fused_mlp_t.cu` (sm_90a; see its source note) through
    `_build.Library` and counts its launches in the module-level
    `launches`.
  * `fused_t_rays_composite` dispatches on the device of the inputs: the
    plain version for CPU tensors, the kernel for CUDA tensors. There is no
    fallback: a kernel that fails to build or launch raises.

Forward-only, eval semantics (no σ noise).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.mathutil import l2_normalize
from ..render.renderer import sigma_activation
from ..train.checkpoints import tree_leaves
from ._build import Library, card_index
from .fused_cp import (c_order, check_ray_inputs, on_cpu, prefix_weights,
                       prep, split_per_ray, tf32_round)

_LIB = "fused_mlp_t"
_ACTS = ("relu", "softplus")
MAX_SAMPLES = 256
# the kernel entry's negative return codes (see mnerf_fused_mlp_t)
_REFUSALS = {-2: f"S is outside [1, {MAX_SAMPLES}] samples per ray",
             -3: "a posenc frequency count is outside [0, 20]",
             -4: "the packed weights disagree with the kernel's layout",
             -6: "no rays"}

# kernel launches since import (or since a caller last reset it to 0)
launches = 0


def mlp_rays_composite_reference(field, params: dict, rays_o, rays_d,
                                 view_dirs, z_vals, sigma_only: bool = False,
                                 sigma_act: str = "relu") -> dict:
    """The plain PyTorch version of the kernel (any device)."""
    n, s = z_vals.shape
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    sigma, geo = field.density(params, xyz.reshape(-1, 3))
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                        torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    w = prefix_weights(
        deltas * sigma_activation(sigma.reshape(n, s), sigma_act))
    if sigma_only:
        return {"weights": w}
    rgb = field.color(params, geo,
                      view_dirs.repeat_interleave(s, dim=0)).reshape(n, s, 3)
    res = {"weights": w, "opacity": w.sum(-1),
           "rgb": (w[..., None] * rgb).sum(1), "depth": (w * z_vals).sum(-1)}
    if field.predict_normal:
        nrm = l2_normalize(field.normal_head(params, geo)).reshape(n, s, 3)
        res["normal"] = (w[..., None] * nrm).sum(1)
    if field.predict_mirror_mask:
        mir = field.mirror_head(params, geo).reshape(n, s)
        res["mirror"] = (w * mir).sum(-1)
    return res


W, DEPTH, SKIP = 256, 8, 4  # the default trunk, csrc/fused_mlp_t.cu's


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _leaves(params: dict) -> list:
    """The field's leaves in the packed index's order: trunk (w, b) per
    layer, σ, xyz_final, dir_enc, rgb, then normal (2) and is_mirror (2)
    where the field has them, each as (w, b)."""
    leaves = []
    for layer in params["trunk"]:
        leaves += [layer["w"], layer["b"]]
    for lin in (params["sigma"], params["xyz_final"], params["dir_enc"],
                params["rgb"], *params.get("normal", ()),
                *params.get("is_mirror", ())):
        leaves += [lin["w"], lin["b"]]
    return leaves


def trunk_spec(params: dict) -> tuple:
    """(width, depth, skips, pe, dpe, has_n, has_m) of the field these
    params are: a trunk layer past the first with more input rows than the
    width is a skip layer ([pe, h])."""
    trunk = params["trunk"]
    pe, width = trunk[0]["w"].shape
    skips = tuple(i for i in range(1, len(trunk))
                  if trunk[i]["w"].shape[0] != width)
    return (width, len(trunk), skips, pe,
            params["dir_enc"]["w"].shape[0] - width, "normal" in params,
            "is_mirror" in params)


def stream_layout(pe: int, dpe: int, has_n: bool, has_m: bool,
                  width: int = W, depth: int = DEPTH,
                  skips: tuple = (SKIP,)) -> list:
    """The kernels' weight stream, in the order they run the products:
    (name, leaf, K rows, N) per layer, the leaf an index into `_leaves` and
    K rows the leaf's row each packed row reads (None: a zero row). Rows
    fed by a hidden layer's accumulators are in `c_order`; posenc rows in
    their own order, padded to 8. The default trunk's is the one
    `csrc/fused_mlp_t.cu` takes (its `net_offsets`); every trunk's is
    `csrc/fused_mlp_rows_tc.cu`'s (through `stream_plan`)."""
    h = c_order(width)
    pe_rows = list(range(pe)) + [None] * (_pad(pe, 8) - pe)
    layers = []
    for i in range(depth):
        rows = pe_rows if i == 0 else (
            pe_rows + [pe + r for r in h] if i in skips else h)
        layers.append((f"trunk{i}", 2 * i, rows, width))
    heads = 2 * depth + 8  # the first head leaf, after σ, xf, dir, rgb
    if has_n:
        layers.append(("normal0", heads, h, width // 2))
    if has_m:
        layers.append(("mirror0", heads + 4 * has_n, h, width // 2))
    layers.append(("xyz_final", 2 * depth + 2, h, width))
    layers.append(("dir_enc", 2 * depth + 4,
                   h + [width + j for j in range(dpe)]
                   + [None] * (_pad(dpe, 8) - dpe), width // 2))
    return layers


CTA_PARTS = 8  # 64-column parts a CTA of csrc/fused_mlp_rows_tc.cu holds


def cluster_ctas(width: int) -> int:
    """C, the CTAs of `csrc/fused_mlp_rows_tc.cu`'s cluster instance that
    split a layer's columns at this width (its `wide_shape`): 1 up to 512
    (one CTA holds every column); above, the fewest of 2, 4 and 8 that
    hold at most 6 of its 64-column parts each, else 8 (at most
    `CTA_PARTS` each up to width 4096)."""
    parts = width // 64
    if width <= 512:
        return 1
    return 2 if parts <= 12 else (4 if parts <= 24 else 8)


def cta_parts(n: int, ctas: int) -> list:
    """The 64-column parts of a layer of n columns that each of `ctas` CTAs
    holds, CTA c the parts q ≡ c (mod ctas), in order."""
    return [list(range(c, n // 64, ctas)) for c in range(ctas)]


def stage_order(n: int, ctas: int) -> np.ndarray:
    """The order of a k-step's 16·n floats in the packed buffer: for one
    CTA the hi plane's n rows then the lo plane's (8 floats a row); split
    across `ctas` CTAs, CTA after CTA, each its parts' rows of the hi
    plane, then of the lo plane (a part 64 rows), so that each CTA's share
    of a stage is one run."""
    if ctas == 1:
        return np.arange(16 * n)
    return np.concatenate([8 * n * plane + 512 * q + np.arange(512)
                           for parts in cta_parts(n, ctas)
                           for plane in (0, 1) for q in parts])


def _raw_leaves(has_n: bool, has_m: bool, depth: int = DEPTH) -> list:
    """The fp32 leaves after the stream, in order, as indices into
    `_leaves`: the trunk's biases, σ (w, b), xf b, dir b, rgb (w, b), then
    normal (b0, w1, b1) and mirror (b0, w1, b1) where present."""
    raw = [2 * i + 1 for i in range(depth)]
    s = 2 * depth
    raw += [s, s + 1, s + 3, s + 5, s + 6, s + 7]
    at = s + 8
    for present in (has_n, has_m):
        if present:
            raw += [at + 1, at + 2, at + 3]
            at += 4
    return raw


def pack_index(shapes: list, pe: int, dpe: int, has_n: bool,
               has_m: bool, width: int = W, depth: int = DEPTH,
               skips: tuple = (SKIP,)):
    """(index, kind) of every float of the packed buffer: the index into
    the leaves (`shapes`, in `_leaves` order) flattened and concatenated
    with one zero appended, and the kind 0 (TF32 hi), 1 (TF32 lo) or 2
    (fp32 as it is). A streamed layer of K rows and N columns is K/8
    k-steps of [hi plane, lo plane], a plane N rows of 8 K values, K-major,
    in the 32-byte swizzle: the 16-B half h of row n holds K values
    4(h ^ (n/4 mod 2)) … + 3 of the k-step. Wider than 512 each k-step's
    rows are in `stage_order`, each CTA's [hi, lo] parts one run."""
    offs = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
    zero = int(offs[-1])
    ctas = cluster_ctas(width)
    idx, kind = [], []
    for _, leaf, rows, n in stream_layout(pe, dpe, has_n, has_m, width,
                                          depth, skips):
        pos = np.arange(8 * n)
        col, q = pos // 8, pos % 8
        k = ((q // 4) ^ ((col // 4) & 1)) * 4 + q % 4
        src = np.array([-1 if r is None else r for r in rows]).reshape(
            -1, 8)[:, k]
        plane = np.where(src >= 0, offs[leaf] + src * n + col, zero)
        order = stage_order(n, ctas)
        idx.append(np.stack([plane, plane], 1).reshape(
            len(rows) // 8, -1)[:, order].reshape(-1))
        kind.append(np.tile(np.repeat([0, 1], 8 * n)[order], len(rows) // 8))
    for leaf in _raw_leaves(has_n, has_m, depth):
        size = int(np.prod(shapes[leaf]))
        idx.append(np.concatenate([offs[leaf] + np.arange(size),
                                   [zero] * (_pad(size, 4) - size)]))
        kind.append(np.full(_pad(size, 4), 2))
    return (torch.from_numpy(np.concatenate(idx).astype(np.int64)),
            torch.from_numpy(np.concatenate(kind).astype(np.int8)))


def stream_plan(params: dict) -> tuple:
    """(plan, floats) of the packed buffer (`_pack`) of these params, as
    `csrc/fused_mlp_rows_tc.cu` reads it: per streamed layer of
    `stream_layout` (float offset, k-steps, N, its bias's float offset),
    then the float offsets of σ's w and b, rgb's w and b, the normal's
    second w and b and the mirror's (−1 for a head the field lacks);
    `floats` is the buffer's length. Wider than 512 the kernel's CTA c of
    C = `cluster_ctas(width)` reads its parts (`cta_parts(N, C)[c]`) of
    each k-step, a run after those of the CTAs before it (`stage_order`)."""
    width, depth, skips, pe, dpe, has_n, has_m = trunk_spec(params)
    shapes = [tuple(leaf.shape) for leaf in _leaves(params)]
    plan, at, streamed = [], 0, []
    for _, leaf, rows, n in stream_layout(pe, dpe, has_n, has_m, width,
                                          depth, skips):
        streamed.append((at, len(rows) // 8, n, leaf))
        at += 2 * len(rows) * n
    raw = {}
    for leaf in _raw_leaves(has_n, has_m, depth):
        raw[leaf] = at
        at += _pad(int(np.prod(shapes[leaf])), 4)
    for off, ks, n, leaf in streamed:
        plan += [off, ks, n, raw[leaf + 1]]  # a layer's bias is its next leaf
    s = 2 * depth
    n1 = s + 10 if has_n else None
    m1 = s + 8 + 4 * has_n + 2 if has_m else None
    plan += [raw[s], raw[s + 1], raw[s + 6], raw[s + 7]]
    plan += [raw[n1], raw[n1 + 1]] if has_n else [-1, -1]
    plan += [raw[m1], raw[m1 + 1]] if has_m else [-1, -1]
    return plan, at


_pack_index: dict = {}  # (shapes, device) -> pack_index there


def _pack(params: dict) -> torch.Tensor:
    """All weights as the kernels read them (`pack_index`, for the field's
    own trunk: `trunk_spec`): the streamed layers split into TF32 hi and lo
    planes, the rest fp32. The layout is cached per leaf shapes and device;
    the values are packed on every call."""
    leaves = _leaves(params)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves]
                     + [leaves[0].new_zeros(1)]).to(torch.float32)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    key = (shapes, str(flat.device))
    if key not in _pack_index:
        width, depth, skips, pe, dpe, has_n, has_m = trunk_spec(params)
        _pack_index[key] = tuple(
            t.to(flat.device) for t in pack_index(
                list(shapes), pe, dpe, has_n, has_m, width, depth, skips))
    index, kind = _pack_index[key]
    g = flat[index]
    hi = tf32_round(g)
    lo = tf32_round(g - hi)
    return torch.where(kind == 0, hi, torch.where(kind == 1, lo, g))


# the entry's arguments before the card and the stream (_build.Library):
# rays_o, rays_d, view_dirs, z_vals, nets, n_nets, n_rays, n_samples,
# n_emb_xyz, n_emb_dir, has_normal, has_mirror, sigma_only, softplus,
# weights, per_ray
_P, _I = ctypes.c_void_p, ctypes.c_int
_F32 = (torch.float32,)
_library = Library(_LIB, {"mnerf_fused_mlp_t": [
    _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I, _I,
    _P, _P]}, _REFUSALS)


def check_forward_call(params: dict, inputs, what: str) -> None:
    """The checks every launch of the PE-MLP kernels makes first, the
    gradient guard before the rest (so that it holds whatever else is wrong
    with the call): forward-only, CUDA tensors."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*inputs, *tree_leaves(params))):
        raise ValueError(
            f"the fused PE-MLP {what} kernel is forward-only, and an input "
            "or a parameter requires grad: run it under torch.no_grad(), or "
            "render through the plain field modules (fused_field off)")
    if not inputs[-1].is_cuda:
        raise ValueError(f"the fused PE-MLP {what} kernel needs CUDA "
                         f"tensors, got {inputs[-1].device}")


def check_kernel_call(field, params: dict, inputs, sigma_act: str,
                      what: str) -> None:
    """The checks every launch of `csrc/fused_mlp_t.cu` makes:
    `check_forward_call`, a known activation, a trunk the kernel takes."""
    check_forward_call(params, inputs, what)
    if sigma_act not in _ACTS:
        raise ValueError(f"sigma_act must be one of {_ACTS}")
    if not field.supports_fused_t:
        raise ValueError(
            f"the fused PE-MLP {what} kernel of csrc/fused_mlp_t.cu takes "
            "the default trunk (width 256, depth 8, the skip at layer 4; "
            "MirrorNeRFField.supports_fused_t)")


def launch_kernel(field, params: dict, rays_o, rays_d, view_dirs, z_vals,
                  sigma_only: bool, softplus: bool, weights,
                  per_ray=None) -> None:
    """One launch of `csrc/fused_mlp_t.cu` on the current stream, on checked
    inputs and allocated outputs: weights and, unless σ-only, per_ray.
    Raises on a refusal or a failed launch."""
    n, s = z_vals.shape
    nets = _pack(params)
    dev = card_index("fused PE-MLP", ("z_vals", z_vals, _F32, 4),
                     ("nets", nets, _F32, 16))

    def ptr(t):
        return None if t is None else t.data_ptr()

    _library.launch(
        "mnerf_fused_mlp_t", "fused PE-MLP", dev,
        rays_o.data_ptr(), rays_d.data_ptr(), ptr(view_dirs),
        z_vals.data_ptr(), nets.data_ptr(), nets.numel(), n, s,
        field.N_emb_xyz, field.N_emb_dir, int(field.predict_normal),
        int(field.predict_mirror_mask), int(sigma_only), int(softplus),
        ptr(weights), ptr(per_ray))


def fused_t_composite_cuda(field, params: dict, rays_o, rays_d, view_dirs,
                           z_vals, sigma_only: bool, sigma_act: str):
    """Launch the CUDA kernel on the current stream. Inputs must be float32,
    contiguous, on one CUDA device: rays_o/rays_d/view_dirs (N, 3), z (N, S).
    Returns (weights (N, S), per_ray (N, 9) or None), per_ray's columns
    [opacity, rgb, normal, mirror, depth] (0 for a head the field lacks)."""
    global launches
    check_kernel_call(field, params, (rays_o, rays_d, view_dirs, z_vals),
                      sigma_act, "composite")
    dev = z_vals.device
    n, s = z_vals.shape
    check_ray_inputs(rays_o, rays_d, view_dirs, z_vals, sigma_only)
    weights = torch.empty((n, s), dtype=torch.float32, device=dev)
    per_ray = None if sigma_only else torch.empty(
        (n, 9), dtype=torch.float32, device=dev)
    if n == 0:
        return weights, per_ray
    launch_kernel(field, params, rays_o, rays_d, view_dirs, z_vals,
                  sigma_only, sigma_act == "softplus", weights, per_ray)
    launches += 1
    return weights, per_ray


def fused_t_rays_composite(field, params: dict, rays_o, rays_d, view_dirs,
                           z_vals, sigma_only: bool = False,
                           sigma_act: str = "relu") -> dict:
    """Composite-mode adapter: weights (N, S) always; plus per-ray
    opacity/rgb/depth, and normal/mirror for the heads the field has, unless
    sigma_only. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if on_cpu(z_vals.device, "fused PE-MLP"):
        return mlp_rays_composite_reference(field, params, rays_o, rays_d,
                                            view_dirs, z_vals, sigma_only,
                                            sigma_act)
    res = split_per_ray(*fused_t_composite_cuda(
        field, params, prep(rays_o), prep(rays_d),
        None if sigma_only else prep(view_dirs), prep(z_vals), sigma_only,
        sigma_act))
    if not field.predict_normal:
        res.pop("normal", None)
    if not field.predict_mirror_mask:
        res.pop("mirror", None)
    return res
