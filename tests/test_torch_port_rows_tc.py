"""Port parity, the PE-MLP rows kernel on the tensor cores for every trunk
up to width 4096 (`csrc/fused_mlp_rows_tc.cu`, 3×TF32 `wgmma`, depth and
skips at run time; wider than 512 its cluster instance, C CTAs (2, 4 or
8) splitting each layer's columns):

  * the packed buffer (`fused_mlp_t._pack`, generalised to the field's own
    trunk) and its plan (`fused_mlp_t.stream_plan`): every streamed layer
    at the plan's offset as K/8 k-steps of TF32 hi and lo planes in the
    32-byte swizzle, hi exactly TF32, hi + lo the fp32 weight in the packed
    row order (`c_order` for rows fed by a hidden layer, posenc rows first
    in a skip layer), zero pad rows, every fp32 leaf at its offset; wider
    than 512 each k-step read back as the cluster's CTAs read it, one run
    of [hi, lo] planes of its parts a CTA (`cta_parts`, `stage_order`),
    every column owned by exactly one CTA;
  * those planes multiplied in the kernel's order (a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi, the tensor cores' sums two k-steps long and added in fp32,
    A in the K order the kernel feeds; in a cluster each CTA its parts'
    columns, A gathered from the CTAs' parks) reproduce the plain version
    and the JAX field modules at 1e-5, on seeded and on saturating σ;
  * the route each trunk takes (`fused_mlp.rows_route`), and the refusal
    outside the range;

and, on a machine with a card only: each trunk (widths 128, 256, 384, 512,
640, 1408; the skip sets of the spec-range tests) in rays mode, full and
σ-only, and in points mode against the plain version at 1e-4 scaled above
1, a trunk wider than 4096 on the layer-major kernel likewise, HGMMA in every
instance's SASS, raw σ's signed mean error against a float64 plain
version within 1e-7 of its scale on phase 23's weights, and within 2⁻²⁴ a
layer on He-scaled ones."""

import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu_torch.models.embedding import posenc
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_mlp, fused_mlp_t
from mirror_nerf_tpu_torch.tools import exp_rows_tc_diag
from mirror_nerf_tpu_torch.train.checkpoints import _map, params_from_numpy
from test_torch_port_spec_range import (TRUNKS, _close, _field_rows, _rays,
                                        _t, _trunk_params)

# the trunks of this file: the spec-range tests', a width-512 one and two
# of the cluster instance (C = 2, and C = 4 with parts split 6/6/5/5)
TC_TRUNKS = {**TRUNKS,
             "w512_d3_s2": dict(width=512, depth=3, skips=(2,)),
             "w640_d2": dict(width=640, depth=2, skips=()),
             "w1408_d1": dict(width=1408, depth=1, skips=())}
# the emulation sums each chunk in float64 and rounds it to fp32, the plain
# version runs fp32: summation order through a few layers only
ATOL = 1e-5


def _params(kw: dict, sigma_scale: float, seed: int = 0) -> dict:
    """The spec-range tests' seeded trunk params (He-scaled trunk, σ column
    positive ×5), the σ column then ×(sigma_scale / 5)."""
    p = _trunk_params(kw, seed)
    p["sigma"]["w"] *= np.float32(sigma_scale / 5.0)
    return p


# ------------------------------------------ the packed buffer and its plan


def _unswizzle(c: torch.Tensor, n: int):
    """(k-steps, 2, n, 8) stages -> the hi and lo planes as (K, n), the
    32-byte swizzle undone."""
    ks = c.shape[0]
    q = torch.arange(8)[None, :]
    col = torch.arange(n)[:, None]
    k = ((q // 4) ^ ((col // 4) & 1)) * 4 + q % 4  # K value at (n, q)
    planes = torch.empty_like(c)
    planes[:, :, col, k] = c
    return tuple(planes[:, i].permute(0, 2, 1).reshape(ks * 8, n)
                 for i in (0, 1))


def cta_runs(step: torch.Tensor, n: int, ctas: int) -> list:
    """A k-step's 16·n packed floats as the kernel's CTAs read them: CTA
    c's run, (hi, lo) planes of its parts' rows, (64·parts, 8) each."""
    runs, at = [], 0
    for parts in fused_mlp_t.cta_parts(n, ctas):
        size = 512 * len(parts)
        runs.append((step[at:at + size].reshape(-1, 8),
                     step[at + size:at + 2 * size].reshape(-1, 8)))
        at += 2 * size
    assert at == step.numel() == 16 * n
    return runs


def reassemble(step: torch.Tensor, n: int, ctas: int) -> torch.Tensor:
    """A k-step's (2, n, 8) [hi, lo] planes from the CTAs' runs and their
    part lists: each part's 64 rows back at rows 64q …; every column owned
    by exactly one CTA."""
    planes = step.new_zeros((2, n, 8))
    owned = [0] * (n // 64)
    for (hi, lo), parts in zip(cta_runs(step, n, ctas),
                               fused_mlp_t.cta_parts(n, ctas)):
        for i, q in enumerate(parts):
            planes[0, 64 * q:64 * q + 64] = hi[64 * i:64 * i + 64]
            planes[1, 64 * q:64 * q + 64] = lo[64 * i:64 * i + 64]
            owned[q] += 1
    assert owned == [1] * (n // 64), owned
    return planes


def read_plan(params: dict, nets: torch.Tensor):
    """The packed buffer read as the kernel reads it through the plan:
    [(hi, lo, bias)] per streamed layer in stream order (each k-step
    reassembled from its CTAs' runs), and the heads' fp32 leaves by name
    (None for a head the field lacks)."""
    plan, _ = fused_mlp_t.stream_plan(params)
    width, depth, _, _, _, has_n, has_m = fused_mlp_t.trunk_spec(params)
    ctas = fused_mlp_t.cluster_ctas(width)
    nl = depth + has_n + has_m + 2
    layers = []
    for i in range(nl):
        off, ks, n, bias = plan[4 * i:4 * i + 4]
        steps = nets[off:off + ks * 16 * n].reshape(ks, 16 * n)
        hi, lo = _unswizzle(torch.stack([reassemble(st, n, ctas)
                                         for st in steps]), n)
        layers.append((hi, lo, nets[bias:bias + n]))
    sizes = {"sw": (width, 1), "sb": (1,), "rw": (width // 2, 3),
             "rb": (3,), "n1w": (width // 2, 3), "n1b": (3,),
             "m1w": (width // 2, 1), "m1b": (1,)}
    heads = {}
    for (name, shape), off in zip(sizes.items(), plan[4 * nl:]):
        heads[name] = None if off < 0 else nets[
            off:off + int(np.prod(shape))].reshape(shape)
    return layers, heads


@pytest.mark.parametrize("width", [640, 1408, 4096])
def test_cluster_packs_reassemble_each_layer(width):
    """Wider than 512, C CTAs (2, 4 or 8: clusters of 4, 8 or 16) split
    each layer's 64-column parts, CTA c the parts q ≡ c (mod C), at most
    6 a CTA where 8 CTAs allow it and 8 at the limit (640: 5/5; 1408:
    6/6/5/5; 4096: 8 × 8); a k-step of the trunk's width and of the heads'
    half width, packed in `stage_order`, comes back whole from the C
    per-CTA runs and the part lists, every column owned once (at the
    limit on a k-step of indices: the whole trunk's buffer is ~10⁸
    floats)."""
    ctas = fused_mlp_t.cluster_ctas(width)
    counts = [len(p) for p in fused_mlp_t.cta_parts(width, ctas)]
    assert sum(counts) == width // 64
    assert counts == {640: [5, 5], 1408: [6, 6, 5, 5],
                      4096: [8] * 8}[width]
    assert max(counts) <= fused_mlp_t.CTA_PARTS
    for n in (width, width // 2):
        want = torch.arange(16 * n, dtype=torch.float64)
        order = torch.from_numpy(fused_mlp_t.stage_order(n, ctas))
        got = reassemble(want[order], n, ctas)
        assert torch.equal(got.reshape(-1), want), n


@pytest.mark.parametrize("trunk", sorted(TC_TRUNKS))
def test_packed_planes_and_plan_give_the_weights_back(trunk):
    """Every streamed layer of the field's own trunk at the plan's offset:
    hi and lo TF32 (low 13 bits zero), hi + lo the weight in the packed
    row order to 2⁻²¹ of it, zero pad rows; the biases and the heads' fp32
    leaves at the plan's offsets; the buffer's length the plan's."""
    kw = TC_TRUNKS[trunk]
    tf = TorchField(**kw)
    p = params_from_numpy(_params(kw, 5.0, seed=1))
    nets = fused_mlp_t._pack(p)
    plan, floats = fused_mlp_t.stream_plan(p)
    assert nets.numel() == floats
    assert fused_mlp_t.trunk_spec(p) == (
        tf.width, tf.depth, tuple(tf.skips), tf.in_xyz, tf.in_dir,
        tf.predict_normal, tf.predict_mirror_mask)
    layers, heads = read_plan(p, nets)
    leaves = fused_mlp_t._leaves(p)
    layout = fused_mlp_t.stream_layout(
        tf.in_xyz, tf.in_dir, tf.predict_normal, tf.predict_mirror_mask,
        tf.width, tf.depth, tuple(tf.skips))
    assert len(layout) == len(layers)
    for (name, leaf, rows, n), (hi, lo, bias) in zip(layout, layers):
        assert hi.shape == (len(rows), n) and len(rows) % 8 == 0, name
        for t in (hi, lo):
            assert not (t.view(torch.int32) & 0x1FFF).any(), name
        w = leaves[leaf]
        want = torch.stack([w[r] if r is not None else w.new_zeros(n)
                            for r in rows])
        err = (hi.double() + lo.double() - want.double()).abs()
        assert bool((err <= want.double().abs() * 2.0 ** -21).all()), name
        assert torch.equal(bias, leaves[leaf + 1]), name
    skip_rows = [len(rows) for _, _, rows, _ in layout[1:tf.depth]]
    pe8 = -(-tf.in_xyz // 8) * 8
    assert skip_rows == [pe8 + tf.width if i in tf.skips else tf.width
                         for i in range(1, tf.depth)]
    assert torch.equal(heads["sw"], p["sigma"]["w"])
    assert torch.equal(heads["sb"], p["sigma"]["b"])
    assert torch.equal(heads["rw"], p["rgb"]["w"])
    assert torch.equal(heads["rb"], p["rgb"]["b"])
    for name, key in (("n1", "normal"), ("m1", "is_mirror")):
        if key in p:
            assert torch.equal(heads[f"{name}w"], p[key][1]["w"])
            assert torch.equal(heads[f"{name}b"], p[key][1]["b"])
        else:
            assert heads[f"{name}w"] is None and heads[f"{name}b"] is None


# --------------------------- the kernel's order, emulated on the CPU


def _split(a: torch.Tensor):
    hi = fused_cp.tf32_round(a)
    return hi, fused_cp.tf32_round(a - hi)


def _mm3_chunks(a: torch.Tensor, layer) -> torch.Tensor:
    """a (B, K) in packed row order times a streamed layer as the kernel
    takes it: each chunk of two k-steps (16 K rows; the last one 8 when
    the k-steps are odd) a_lo·b_hi + a_hi·b_lo + a_hi·b_hi exact (float64)
    and rounded to fp32, the chunks added in fp32 in K order."""
    b_hi, b_lo, _ = (m.double() for m in layer)
    a_hi, a_lo = (x.double() for x in _split(a.float()))
    out = a.new_zeros((a.shape[0], b_hi.shape[1]), dtype=torch.float32)
    for c in range(0, a.shape[1], 16):
        k = slice(c, c + 16)
        out = out + (a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k]
                     + a_hi[:, k] @ b_hi[k]).float()
    return out


def _pad_cols(a: torch.Tensor) -> torch.Tensor:
    pad = -a.shape[1] % 8
    return torch.cat([a, a.new_zeros(a.shape[0], pad)], 1) if pad else a


def _cluster_mm3(a: torch.Tensor, layer, ctas: int) -> torch.Tensor:
    """`_mm3_chunks` as a cluster runs it: each CTA its parts' columns, the
    CTAs' outputs placed at their columns."""
    hi, lo, bias = layer
    out = a.new_zeros((a.shape[0], hi.shape[1]), dtype=torch.float32)
    for parts in fused_mlp_t.cta_parts(hi.shape[1], ctas):
        cols = torch.tensor([64 * q + j for q in parts for j in range(64)],
                            dtype=torch.long)
        out[:, cols] = _mm3_chunks(a, (hi[:, cols], lo[:, cols], bias))
    return out


def _from_parks(h: torch.Tensor, ctas: int) -> torch.Tensor:
    """A layer's activations (B, W), already in `c_order`, as the next
    layer's A: each CTA parks its parts (part slot l = its l-th), and
    k-tile kt comes from the park of CTA (kt/8) mod C at slot (kt/8) / C."""
    parts = fused_mlp_t.cta_parts(h.shape[1], ctas)
    parks = [torch.cat([h[:, 64 * q:64 * q + 64] for q in p], 1)
             for p in parts]
    tiles = []
    for kt in range(h.shape[1] // 8):
        q = kt // 8
        at = 64 * (q // ctas) + 8 * (kt % 8)
        tiles.append(parks[q % ctas][:, at:at + 8])
    return torch.cat(tiles, 1)


def kernel_order_rows_tc(field, params: dict, xyz, dirs) -> torch.Tensor:
    """The (B, 8) rows from the buffer and plan the wrapper hands the
    kernel, in the kernel's order: the trunk through the plan's layers
    (a skip layer is one with more K rows than the width: posenc rows
    first), each layer's columns split across the cluster's CTAs and its
    A gathered from their parks (one CTA up to width 512), the heads'
    dots in fp32, 0 for a head the field lacks."""
    layers, heads = read_plan(params, fused_mlp_t._pack(params))
    w, depth = field.width, field.depth
    ctas = fused_mlp_t.cluster_ctas(w)
    order = fused_cp.c_order(w)

    def mm3(a, layer):
        return _cluster_mm3(a, layer, ctas)

    def park(x):
        return _from_parks(x[:, order], ctas)

    pe = _pad_cols(posenc(xyz, field.N_emb_xyz))
    h = torch.relu(mm3(pe, layers[0]) + layers[0][2])
    for i in range(1, depth):
        a = park(h)
        if layers[i][0].shape[0] != w:
            a = torch.cat([pe, a], 1)
        h = torch.relu(mm3(a, layers[i]) + layers[i][2])
    b = xyz.shape[0]
    out = torch.zeros((b, 8))
    out[:, :1] = h @ heads["sw"] + heads["sb"]
    hc, l = park(h), depth
    if field.predict_normal:
        n = (mm3(hc, layers[l]) + layers[l][2]) @ heads["n1w"] \
            + heads["n1b"]
        out[:, 4:7] = n * torch.rsqrt(
            (n * n).sum(-1, keepdim=True).clamp_min(1.1920929e-07))
        l += 1
    if field.predict_mirror_mask:
        m = mm3(hc, layers[l]) + layers[l][2]
        m = torch.where(m >= 0, m, 0.01 * m)
        out[:, 7:] = torch.sigmoid(m @ heads["m1w"] + heads["m1b"])
        l += 1
    xf = mm3(hc, layers[l]) + layers[l][2]
    a = torch.cat([park(xf), _pad_cols(posenc(dirs, field.N_emb_dir))], 1)
    y = torch.relu(mm3(a, layers[l + 1]) + layers[l + 1][2])
    out[:, 1:4] = torch.sigmoid(y @ heads["rw"] + heads["rb"])
    return out


@pytest.mark.parametrize("sigma_scale", [5.0, 2000.0],
                         ids=["seeded", "saturating"])
@pytest.mark.parametrize("trunk", sorted(TC_TRUNKS))
def test_kernel_order_reproduces_rows(trunk, sigma_scale):
    """The packed planes multiplied in the kernel's order give the plain
    version's rows and the JAX field modules' (fp32) at 1e-5 (scaled above
    1), at sample positions of rays and at scattered points."""
    kw = TC_TRUNKS[trunk]
    tf = TorchField(**kw)
    p = _params(kw, sigma_scale, seed=2)
    pt = params_from_numpy(p)
    o, d, z = _rays(4, 8, seed=3)
    rng = np.random.default_rng(4)
    xyz = np.concatenate([
        (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3),
        rng.normal(size=(16, 3)).astype(np.float32) * 2.0])
    dirs = np.concatenate([np.repeat(d, 8, 0),
                           rng.normal(size=(16, 3)).astype(np.float32)])
    got = kernel_order_rows_tc(tf, pt, *_t(xyz, dirs)).numpy()
    want = fused_mlp.mlp_rows_reference(tf, pt, *_t(xyz, dirs)).numpy()
    assert float(np.abs(want[:, 0]).max()) > (
        50.0 if sigma_scale > 5 else 0.5)  # not vacuous
    _close(got, want, ATOL, f"{trunk} plain")
    _close(got, _field_rows(JaxField(**kw), p, xyz, dirs, False), ATOL,
           f"{trunk} jax")


def test_rows_route_by_spec():
    """One route a trunk, by spec: every trunk up to the limit (4096), the
    default one included, the tensor-core kernel, wider ones the
    layer-major kernel; outside `supports_fused` a refusal naming the
    range."""
    limit = fused_mlp.TC_MAX_WIDTH
    assert limit == 4096
    want = {**{k: "fused_mlp_rows_tc" for k in TC_TRUNKS},
            "default": "fused_mlp_rows_tc",
            "w256_d4": "fused_mlp_rows_tc",
            "w256_d8_s3": "fused_mlp_rows_tc",
            "w1024_d1": "fused_mlp_rows_tc",
            "w4096_d1": "fused_mlp_rows_tc",
            "w4224_d1": "fused_mlp_layers"}
    kws = {**TC_TRUNKS, "default": {}, "w256_d4": dict(depth=4),
           "w256_d8_s3": dict(skips=(3,)),
           "w1024_d1": dict(width=1024, depth=1, skips=()),
           "w4096_d1": dict(width=4096, depth=1, skips=()),
           "w4224_d1": dict(width=4224, depth=1, skips=())}
    for name, kw in kws.items():
        tf = TorchField(**kw)
        assert fused_mlp.rows_route(tf) == want[name], name
        assert tf.supports_fused_tc == (tf.width <= limit), name
    for kw in (dict(width=200), dict(width=256, depth=0),
               dict(N_emb_xyz=21), dict(N_emb_dir=21)):
        tf = TorchField(**kw)
        assert not tf.supports_fused and not tf.supports_fused_tc
        with pytest.raises(ValueError, match="multiple of 128"):
            fused_mlp.rows_route(tf)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU every route's entry points run the plain version, and no
    counter moves."""
    kw = TC_TRUNKS["w512_d3_s2"]
    tf = TorchField(**kw)
    pt = params_from_numpy(_params(kw, 5.0))
    o, d, z = _t(*_rays(3, 4, seed=5))
    before = (fused_mlp.launches_general_rays,
              fused_mlp.launches_general_points)
    rows = fused_mlp.fused_rays_eval(tf, pt, o, d, d, z)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    want = fused_mlp.mlp_rows_reference(tf, pt, xyz, d.repeat_interleave(4,
                                                                       0))
    assert torch.equal(rows, want)
    pts = fused_mlp.fused_packed_eval(tf, pt, xyz, xyz, sigma_only=True)
    assert pts.shape == (12, 1)
    assert (fused_mlp.launches_general_rays,
            fused_mlp.launches_general_points) == before


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_TRUNKS = {**TC_TRUNKS, "w256_d4_s1": dict(depth=4, skips=(1,)),
               "w512_d8_s4": dict(width=512, depth=8, skips=(4,))}


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", sorted(CARD_TRUNKS))
def test_cuda_tc_rows_match_plain(trunk):
    """Rays (301 × 37, full and σ-only) and points (1001, full) against
    the plain version at 1e-4 scaled above 1; the tensor-core kernel's
    counters move once a launch."""
    _needs_card()
    kw = CARD_TRUNKS[trunk]
    tf = TorchField(**kw)
    assert fused_mlp.rows_route(tf) == "fused_mlp_rows_tc"
    pt = params_from_numpy(_params(kw, 5.0, seed=6), device="cuda")
    o, d, z = (t.cuda() for t in _t(*_rays(301, 37, seed=7)))
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d.repeat_interleave(37, 0)
    n0 = (fused_mlp.launches_general_rays, fused_mlp.launches_general_points)
    with torch.no_grad():
        for so in (False, True):
            got = fused_mlp.fused_rays_eval(tf, pt, o, d, d, z, so)
            ref = fused_mlp.mlp_rows_reference(tf, pt, xyz, dirs, so)
            assert bool(torch.isfinite(got).all())
            _close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4,
                   f"{trunk} rays so={so}")
        got = fused_mlp.fused_packed_eval(tf, pt, xyz[:1001], dirs[:1001])
        ref = fused_mlp.mlp_rows_reference(tf, pt, xyz[:1001], dirs[:1001])
        _close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4, f"{trunk} points")
    assert (fused_mlp.launches_general_rays,
            fused_mlp.launches_general_points) == (n0[0] + 2, n0[1] + 1)


@pytest.mark.gpu
def test_cuda_wide_trunk_takes_the_layers_kernel():
    """A trunk wider than the tensor-core kernel's limit (4096) takes the
    layer-major kernel (its own counters), within 1e-4 of the plain
    version."""
    _needs_card()
    kw = dict(width=4224, depth=1, skips=())
    tf = TorchField(**kw)
    pt = params_from_numpy(_params(kw, 5.0, seed=8), device="cuda")
    o, d, z = (t.cuda() for t in _t(*_rays(37, 17, seed=9)))
    n0 = (fused_mlp.launches_wide_rays, fused_mlp.launches_general_rays)
    with torch.no_grad():
        got = fused_mlp.fused_rays_eval(tf, pt, o, d, d, z)
        ref = fused_mlp.mlp_rays_rows_reference(tf, pt, o, d, d, z)
    _close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4, "w4224")
    assert (fused_mlp.launches_wide_rays,
            fused_mlp.launches_general_rays) == (n0[0] + 1, n0[1])


@pytest.mark.gpu
def test_cuda_tc_kernel_runs_on_wgmma():
    """Every instance of the kernel, the four widths' and the cluster
    instance's two, holds HGMMA (wgmma) in its SASS (cuobjdump of the
    library the wrapper loaded)."""
    _needs_card()
    fused_mlp._tc_library()
    sass = _build.sass_counts(_build.library_path(fused_mlp._TC_LIB),
                              "mlp_rows_",
                              opcodes=("HGMMA", "FFMA", "LDL", "STL"))
    assert len(sass) == len(fused_mlp.TC_WIDTHS) + 2, list(sass)
    for name, counts in sass.items():
        assert counts["HGMMA"] > 0, name


def _sigma_lean(tf, pt, o, d, z, fn) -> tuple:
    """(mean signed, max abs) error of raw σ from `fn` (σ-only rays)
    against a float64 plain version, over max(1, max |σ|)."""
    with torch.no_grad():
        got = fn(tf, pt, o, d, z)[:, 0]
        exact = fused_mlp.mlp_rays_rows_reference(
            tf, _map(pt, lambda _, t: t.double()), o.double(), d.double(),
            d.double(), z.double(), True)[:, 0]
    scale = max(1.0, float(exact.abs().max()))
    err = got.double() - exact
    return float(err.mean()) / scale, float(err.abs().max()) / scale


def _tc_sigma(tf, pt, o, d, z):
    return fused_mlp.tc_rows_cuda(tf, pt, o, d, None, z, True)


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", ["w128_d6_s24", "w512_d8_s4", "w640_d2",
                                   "w1408_d1"])
def test_cuda_tc_sigma_lean_within_1e7(trunk):
    """chip_smoke.py phase 23's weights (the init, the σ column |w|·5, the
    mirror bias +5): raw σ's mean signed error against a float64 plain
    version within 1e-7 of its scale, as phases 11 and 23 hold it, on
    2048 rays × 64."""
    _needs_card()
    tf = TorchField(**CARD_TRUNKS[trunk])
    pt = tf.init(torch.Generator().manual_seed(0), "cuda")
    pt["sigma"] = {"w": pt["sigma"]["w"].abs() * 5.0,
                   "b": pt["sigma"]["b"]}
    pt["is_mirror"][1] = {"w": pt["is_mirror"][1]["w"],
                          "b": pt["is_mirror"][1]["b"] + 5.0}
    o, d, z = (t.cuda() for t in _t(*_rays(2048, 64, seed=11)))
    mean, worst = _sigma_lean(tf, pt, o, d, z, _tc_sigma)
    print(f"{trunk}: σ mean signed error {mean:+.3e}, max {worst:.3e}")
    assert abs(mean) <= 1e-7 and worst <= 1e-4, (mean, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", ["w128_d6_s24", "w384_d6_s3",
                                   "w512_d8_s4"])
def test_cuda_tc_sigma_lean_per_layer(trunk):
    """He-scaled weights (the trunk keeps its features, σ far above 1):
    each k-step's tensor-core sum truncates once, shrinking a layer's
    output by about half an ulp of itself, so raw σ leans by that times
    the depth, in the tuned kernel as here (~2e-8 a layer). Held within
    2⁻²⁴ a layer: a sum left running over a whole layer leans an order
    more."""
    _needs_card()
    kw = CARD_TRUNKS[trunk]
    tf = TorchField(**kw)
    pt = params_from_numpy(_params(kw, 5.0, seed=10), device="cuda")
    o, d, z = (t.cuda() for t in _t(*_rays(2048, 64, seed=11)))
    mean, worst = _sigma_lean(tf, pt, o, d, z, _tc_sigma)
    print(f"{trunk}: σ mean signed error {mean:+.3e} "
          f"({mean / tf.depth:+.3e} a layer), max {worst:.3e}")
    assert abs(mean) / tf.depth <= 2.0 ** -24 and worst <= 1e-4, (mean,
                                                                  worst)


@pytest.mark.parametrize("variant", sorted(exp_rows_tc_diag.PATCHES))
def test_diagnosis_patches_match_the_source(variant):
    """Each variant of the diagnosis tool applies to the kernel's source
    (each patch found exactly once), and the tool refuses a source where
    a patch is missing or found twice."""
    patches = exp_rows_tc_diag.PATCHES[variant]
    got = exp_rows_tc_diag.patched_source(variant)
    for old, new in patches:
        assert new in got
    src = "".join(f"// piece {i}\n{old}\n" for i, (old, _) in
                  enumerate(patches))
    with pytest.raises(ValueError, match=variant):
        exp_rows_tc_diag.patched_source(variant,
                                        src.replace(patches[-1][0], ""))
    with pytest.raises(ValueError, match=variant):
        exp_rows_tc_diag.patched_source(variant, src + patches[0][0])


def test_tc_wrapper_refuses_params_of_another_trunk():
    """Before a launch the wrapper holds the params' trunk (`trunk_spec`)
    to the field's: another width, depth, skip set, posenc or head set
    raises (the kernel would read the plan past the field's instance); a
    width above the limit (4096) is refused by name."""
    kw = TC_TRUNKS["w128_d6_s24"]
    tf = TorchField(**kw)
    fused_mlp.check_tc_spec(tf, params_from_numpy(_params(kw, 5.0)))
    for other in (dict(kw, depth=5), dict(kw, skips=(3,)),
                  dict(kw, width=256), dict(kw, predict_normal=False),
                  dict(kw, N_emb_xyz=6)):
        pt = params_from_numpy(_params(other, 5.0))
        with pytest.raises(ValueError, match="not the field's"):
            fused_mlp.check_tc_spec(tf, pt)
    wide = TorchField(width=4224, depth=1, skips=())
    with pytest.raises(ValueError, match="limit 4096"):
        fused_mlp.check_tc_spec(wide, None)  # refused before its params
