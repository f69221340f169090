"""Port parity, the tensor-core design of the flagship PE-MLP kernel
(`csrc/fused_mlp_t.cu`):

  * the packed buffer the wrapper hands the kernel (`fused_mlp_t._pack`):
    each streamed layer's K rows padded to 8 (63 → 64, 319 → 320,
    283 → 288 at the default posenc; 123 → 128, 379 → 384 at 20
    frequencies), rows fed by a hidden layer in `c_order`, every k-step a
    TF32 hi plane and a lo plane in the 32-byte swizzle, then the fp32
    leaves; hi + lo gives the weight back to 2⁻²¹ and the pads are zero;
  * those planes, multiplied in the kernel's order (A in `c_order`, posenc
    rows as computed, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi) in a plain-torch
    emulation, reproduce the rows' plain versions and
    `mlp_rays_composite_reference`, and through them the JAX kernels in
    interpret mode: seeded and saturating (σ ×2000), relu and softplus,
    full and σ-only, and the no-normal / no-mirror / no-heads / posenc 6/2
    fields;
  * the diagnosis tool (`tools/exp_mlp_diag.py`) applies a variant's
    patches to a source that holds each once, and refuses one that does
    not (the kernel's own text is not pinned here);

and, on a machine with a card only: every instance and mode against its
plain version at S ∈ {1, 16, 17, 64, 80, 128, 192, 256} and 1, 37 and
16384 rays (the rows through their route, csrc/fused_mlp_rows_tc.cu,
which took over the rows of this trunk), HGMMA in every instance's SASS,
a build with one TF32 product in place of three outside the 1e-4 bar that
the kernel meets, and a build of the rows kernel that sums whole layers
on the tensor cores outside the 1e-7 σ-bias bar that the fp32 chunk sums
of both kernels meet."""

import jax
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.ops.pallas.fused_mlp import \
    fused_rays_eval as jax_rows
from mirror_nerf_tpu.ops.pallas.fused_mlp_t import fused_t_rays_eval
from mirror_nerf_tpu_torch.models.embedding import posenc
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.ops import _build, fused_cp, fused_mlp, fused_mlp_t
from mirror_nerf_tpu_torch.tools import exp_mlp_diag, exp_rows_tc_diag
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

# the emulation sums each product in float64 and rounds each layer to fp32,
# the plain version runs fp32: summation order through 8 layers only
ATOL = 1e-5
# head and posenc variants the kernel takes (one instance each)
VARIANTS = {"both_heads": {},
            "no_normal": dict(predict_normal=False),
            "no_mirror": dict(predict_mirror_mask=False),
            "no_heads": dict(predict_normal=False, predict_mirror_mask=False),
            "emb6_2": dict(N_emb_xyz=6, N_emb_dir=2)}


def _close(got, want, atol=ATOL, err_msg=""):
    """|got − want| ≤ atol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    bar = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=bar,
                               rtol=0, err_msg=err_msg)


def _params(jf, sigma_scale: float, seed: int = 0):
    """JAX-initialized params with the σ column made positive and scaled."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    p["sigma"]["w"][:, 0] = np.abs(p["sigma"]["w"][:, 0]) * sigma_scale
    return p


def _rays(n: int, s: int, seed: int):
    """Rays from |o| ~ 2 through the field; positions reach |x| ≈ 8."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 6.0, (n, s)), -1).astype(np.float32)
    return o, d, z


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------ the packed buffer, read back


def _layout(field):
    return fused_mlp_t.stream_layout(
        3 * (1 + 2 * field.N_emb_xyz), 3 * (1 + 2 * field.N_emb_dir),
        field.predict_normal, field.predict_mirror_mask)


def unpack(field, nets: torch.Tensor):
    """The packed buffer read as the kernel reads it: name -> (hi, lo),
    each (K, N) in packed row order (the swizzle undone), and the fp32
    leaves after the stream, in `_raw_leaves` order."""
    mats, off = {}, 0
    for name, _, rows, n in _layout(field):
        ks = len(rows) // 8
        c = nets[off:off + ks * 16 * n].reshape(ks, 2, n, 8)
        q = torch.arange(8)[None, :]
        col = torch.arange(n)[:, None]
        k = ((q // 4) ^ ((col // 4) & 1)) * 4 + q % 4  # K value at (n, q)
        planes = torch.empty_like(c)
        planes[:, :, col, k] = c
        hi, lo = (planes[:, i].permute(0, 2, 1).reshape(ks * 8, n)
                  for i in (0, 1))
        mats[name] = (hi, lo)
        off += ks * 16 * n
    return mats, nets[off:]


def _raw(field, params, rest: torch.Tensor) -> dict:
    """The fp32 leaves after the stream, by name, each at its packed
    offset (4-float aligned)."""
    names = [f"b{i}" for i in range(8)] + ["sw", "sb", "xb", "db", "rw",
                                            "rb"]
    if field.predict_normal:
        names += ["n0b", "n1w", "n1b"]
    if field.predict_mirror_mask:
        names += ["m0b", "m1w", "m1b"]
    leaves = fused_mlp_t._leaves(params)
    raw = fused_mlp_t._raw_leaves(field.predict_normal,
                                  field.predict_mirror_mask)
    out, at = {}, 0
    for name, leaf in zip(names, raw):
        shape = leaves[leaf].shape
        size = int(np.prod(shape))
        out[name] = rest[at:at + size].reshape(shape)
        at += -(-size // 4) * 4
    assert at == rest.numel()
    return out


@pytest.mark.parametrize("emb", [(10, 4), (20, 20), (6, 2)],
                         ids=["emb10_4", "emb20_20", "emb6_2"])
def test_packed_layout_pads_k_to_8(emb):
    """K rows of each streamed layer, padded to 8; the buffer's size is the
    stream (2·K·N a layer) and the fp32 leaves, 4-float aligned."""
    field = TorchField(N_emb_xyz=emb[0], N_emb_dir=emb[1])
    pe, dpe = 3 * (1 + 2 * emb[0]), 3 * (1 + 2 * emb[1])
    layout = {name: (len(rows), n) for name, _, rows, n in _layout(field)}
    pad = lambda k: -(-k // 8) * 8  # noqa: E731
    assert layout["trunk0"] == (pad(pe), 256)
    assert layout["trunk4"] == (pad(pe) + 256, 256)
    assert layout["dir_enc"] == (256 + pad(dpe), 128)
    assert layout["normal0"] == layout["mirror0"] == (256, 128)
    assert list(layout) == [f"trunk{i}" for i in range(8)] + [
        "normal0", "mirror0", "xyz_final", "dir_enc"]
    if emb == (10, 4):
        assert (layout["trunk0"][0], layout["trunk4"][0],
                layout["dir_enc"][0]) == (64, 320, 288)
    if emb == (20, 20):
        assert (layout["trunk0"][0], layout["trunk4"][0],
                layout["dir_enc"][0]) == (128, 384, 384)
    params = field.init(torch.Generator().manual_seed(0))
    nets = fused_mlp_t._pack(params)
    stream = sum(2 * k * n for k, n in layout.values())
    raw = 8 * 256 + 256 + 4 + 256 + 128 + 384 + 4 + 2 * (128 + 384 + 4)
    raw -= 384 - 128  # the mirror's second layer is 128 → 1
    assert nets.numel() == stream + raw


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_packed_planes_give_the_weights_back(variant):
    """Every streamed layer: hi and lo are TF32 values (low 13 bits zero),
    hi + lo is the weight in the packed row order to 2⁻²¹ of it, zero rows
    where the order has none; the fp32 leaves are the field's own."""
    field = TorchField(**VARIANTS[variant])
    params = field.init(torch.Generator().manual_seed(1))
    nets = fused_mlp_t._pack(params)
    mats, rest = unpack(field, nets)
    leaves = fused_mlp_t._leaves(params)
    for name, leaf, rows, n in _layout(field):
        hi, lo = mats[name]
        for t in (hi, lo):
            assert not (t.view(torch.int32) & 0x1FFF).any(), name
        w = leaves[leaf]
        want = torch.stack([w[r] if r is not None else w.new_zeros(n)
                            for r in rows])
        err = (hi.double() + lo.double() - want.double()).abs()
        assert bool((err <= want.double().abs() * 2.0 ** -21).all()), name
    raw = _raw(field, params, rest)
    assert torch.equal(raw["sw"], params["sigma"]["w"])
    assert torch.equal(raw["b3"], params["trunk"][3]["b"])
    assert torch.equal(raw["rw"], params["rgb"]["w"])


# --------------------------- the kernel's order, emulated on the CPU


def _split(a: torch.Tensor):
    hi = fused_cp.tf32_round(a)
    return hi, fused_cp.tf32_round(a - hi)


def _mm3(a: torch.Tensor, mat) -> torch.Tensor:
    """a (B, K) in packed row order times a streamed layer, as the tensor
    cores take it: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each product exact
    (float64), the sum rounded to fp32."""
    b_hi, b_lo = (m.double() for m in mat)
    a_hi, a_lo = (x.double() for x in _split(a.float()))
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).float()


def _pad_cols(a: torch.Tensor) -> torch.Tensor:
    pad = -a.shape[1] % 8
    return torch.cat([a, a.new_zeros(a.shape[0], pad)], 1) if pad else a


def kernel_order_rows(field, params, xyz, dirs) -> dict:
    """The field's per-sample outputs from the buffer the wrapper hands the
    kernel, in the kernel's order: `sigma`, and `rgb3`, `normal3`,
    `mirror` (zeros for a head the field lacks)."""
    mats, rest = unpack(field, fused_mlp_t._pack(params))
    raw = _raw(field, params, rest)
    order = fused_cp.c_order(256)
    pe = _pad_cols(posenc(xyz, field.N_emb_xyz))
    h = torch.relu(_mm3(pe, mats["trunk0"]) + raw["b0"])
    for i in range(1, 8):
        a = torch.cat([pe, h[:, order]], 1) if i == 4 else h[:, order]
        h = torch.relu(_mm3(a, mats[f"trunk{i}"]) + raw[f"b{i}"])
    b = xyz.shape[0]
    out = {"sigma": (h @ raw["sw"] + raw["sb"])[:, 0],
           "normal3": h.new_zeros(b, 3), "mirror": h.new_zeros(b)}
    hc = h[:, order]
    if field.predict_normal:
        n = (_mm3(hc, mats["normal0"]) + raw["n0b"]) @ raw["n1w"] + raw["n1b"]
        out["normal3"] = n * torch.rsqrt(
            (n * n).sum(-1, keepdim=True).clamp_min(1.1920929e-07))
    if field.predict_mirror_mask:
        m = _mm3(hc, mats["mirror0"]) + raw["m0b"]
        m = torch.where(m >= 0, m, 0.01 * m)
        out["mirror"] = torch.sigmoid(m @ raw["m1w"] + raw["m1b"])[:, 0]
    xf = _mm3(hc, mats["xyz_final"]) + raw["xb"]
    a = torch.cat([xf[:, order], _pad_cols(posenc(dirs, field.N_emb_dir))],
                  1)
    y = torch.relu(_mm3(a, mats["dir_enc"]) + raw["db"])
    out["rgb3"] = torch.sigmoid(y @ raw["rw"] + raw["rb"])
    return out


def _rows_of(field, out: dict) -> torch.Tensor:
    """The emulation as the rows mode's (B, 8) rows."""
    return torch.cat([out["sigma"][:, None], out["rgb3"], out["normal3"],
                      out["mirror"][:, None]], -1)


# the JAX rows kernel runs bf16 products: its own test's bars
# (tests/test_torch_port_rows.py RAY_BARS), on the JAX init as it is
JAX_ROW_BARS = {"sigma": 3e-2, "rgb": 1e-2, "normal": 3e-2, "mirror": 1e-2}


@pytest.mark.parametrize("sigma_scale", [5.0, 2000.0],
                         ids=["seeded", "saturating"])
def test_kernel_order_reproduces_rows(sigma_scale):
    """Rows mode: the packed planes multiplied in the kernel's order give
    the plain version's rows and the JAX field modules' (fp32) at 1e-5,
    and on the JAX init the JAX rows kernel's (interpret mode) at its
    bars."""
    jf, tf = JaxField(), TorchField()
    o, d, z = _rays(3, 8, seed=11)
    ot, dt, zt = _torch(o, d, z)
    xyz = (ot[:, None, :] + dt[:, None, :] * zt[..., None]).reshape(-1, 3)
    dirs = dt.repeat_interleave(8, dim=0)
    for p, bars in ((_params(jf, sigma_scale), None),
                    (jax.tree_util.tree_map(
                        np.array, jf.init(jax.random.PRNGKey(0))),
                     JAX_ROW_BARS)):
        pt = params_from_numpy(p)
        got = _rows_of(tf, kernel_order_rows(tf, pt, xyz, dirs)).numpy()
        if bars is None:
            want = fused_mlp.mlp_rays_rows_reference(tf, pt, ot, dt, dt, zt)
            _close(got, want.numpy(), err_msg="plain rows")
            sigma, geo = jf.density(p, xyz.numpy())
            _close(got[:, 0], np.asarray(sigma), err_msg="jax sigma")
            _close(got[:, 1:4], np.asarray(jf.color(p, geo, dirs.numpy())),
                   err_msg="jax rgb")
            continue
        kern = np.asarray(jax_rows(jf, p, o, d, d, z, interpret=True))
        for k, sl in (("sigma", 0), ("rgb", slice(1, 4)),
                      ("normal", slice(4, 7)), ("mirror", 7)):
            np.testing.assert_allclose(got[:, sl], kern[:, sl],
                                       atol=bars[k], err_msg=k)


def _composite(field, params, o, d, z, sigma_only, act):
    """The emulated rows composited as the kernel composites them."""
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    out = kernel_order_rows(field, params, xyz,
                            d.repeat_interleave(z.shape[1], dim=0))
    rows = {k: v.reshape(*z.shape, *v.shape[1:]) for k, v in out.items()}
    deltas = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full_like(z[:, :1], 1e10)], -1)
    return fused_cp.composite_rows(rows, z, deltas, sigma_only, act)


@pytest.mark.parametrize("sigma_scale", [5.0, 2000.0],
                         ids=["seeded", "saturating"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_kernel_order_reproduces_composite(act, sigma_only, sigma_scale):
    """Composite mode: the kernel-order rows, composited, give the plain
    version's weights and per-ray sums, and the JAX kernel's (interpret
    mode)."""
    jf, tf = JaxField(), TorchField()
    o, d, z = _rays(3, 16, seed=12)
    p = _params(jf, sigma_scale)
    pt = params_from_numpy(p)
    ot, dt, zt = _torch(o, d, z)
    got = _composite(tf, pt, ot, dt, zt, sigma_only, act)
    want = fused_mlp_t.mlp_rays_composite_reference(tf, pt, ot, dt, dt, zt,
                                                    sigma_only, act)
    jax_want = fused_t_rays_eval(jf, p, o, d, d, z, sigma_only=sigma_only,
                                 interpret=True, sigma_act=act)
    assert set(want) == set(jax_want) <= set(got)
    assert float(want["weights"].max()) > 0.1  # not vacuous
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), err_msg=k)
        _close(got[k].numpy(), np.asarray(jax_want[k]), err_msg=f"jax {k}")
    assert float(got["weights"].sum(-1).max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("variant", sorted(set(VARIANTS) - {"both_heads"}))
def test_kernel_order_reproduces_variants(variant):
    """A field without one or both heads, or with posenc 6/2: the kernel
    order against the plain version and the JAX kernel."""
    kw = VARIANTS[variant]
    jf, tf = JaxField(**kw), TorchField(**kw)
    o, d, z = _rays(3, 16, seed=13)
    p = _params(jf, 5.0, seed=2)
    pt = params_from_numpy(p)
    ot, dt, zt = _torch(o, d, z)
    got = _composite(tf, pt, ot, dt, zt, False, "relu")
    want = fused_mlp_t.fused_t_rays_composite(tf, pt, ot, dt, dt, zt)
    jax_want = fused_t_rays_eval(jf, p, o, d, d, z, interpret=True)
    assert ("normal" in want) == tf.predict_normal
    assert ("mirror" in want) == tf.predict_mirror_mask
    assert set(want) <= set(jax_want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), err_msg=k)
        _close(got[k].numpy(), np.asarray(jax_want[k]), err_msg=f"jax {k}")


@pytest.mark.parametrize("variant", list(exp_mlp_diag.PATCHES))
def test_diagnosis_patches_match_the_source(variant):
    """A variant's patches apply to a source that holds each old text
    once, and the tool refuses a source where one is missing or twice."""
    patches = exp_mlp_diag.PATCHES[variant]
    src = "".join(f"// piece {i}\n{old}\n" for i, (old, _) in
                  enumerate(patches))
    got = exp_mlp_diag.patched_source(variant, src)
    for old, new in patches:
        assert new in got and (old in new or old not in got)
    with pytest.raises(ValueError, match=variant):
        exp_mlp_diag.patched_source(variant, src.replace(patches[-1][0], ""))
    with pytest.raises(ValueError, match=variant):
        exp_mlp_diag.patched_source(variant, src + patches[0][0])


# --------------------------------------------------- on a card only

SAMPLES_PER_RAY = [1, 16, 17, 64, 80, 128, 192, 256]
RAY_COUNTS = [1, 37, 16384]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_rays(n: int, s: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g) * 2.0
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    z = torch.sort(torch.rand((n, s), generator=g) * 5.9 + 0.1, -1).values
    return o.cuda(), d.cuda(), z.cuda()


def _field_params(field, scale: float, seed: int = 0):
    p = field.init(torch.Generator().manual_seed(seed), "cuda")
    w = p["sigma"]["w"].clone()
    w[:, 0] = w[:, 0].abs() * scale
    p["sigma"] = {"w": w, "b": p["sigma"]["b"]}
    return p


def _every_mode(field, params, o, d, z, modes=("composite", "rows")):
    """Each mode and variant of the kernel against its plain version: the
    scaled error ≤ 1e-4, Σw ≤ 1 + 1e-5, the counters move once a launch."""
    cases = []
    if "composite" in modes:
        for so in (False, True):
            for act in ("relu", "softplus"):
                cases.append((f"composite {act} so={so}", fused_mlp_t,
                              "launches",
                              lambda so=so, act=act: fused_mlp_t.
                              fused_t_rays_composite(field, params, o, d, d,
                                                     z, so, act),
                              lambda so=so, act=act: fused_mlp_t.
                              mlp_rays_composite_reference(
                                  field, params, o, d, d, z, so, act)))
    if "rows" in modes:
        for so in (False, True):
            cases.append((f"rows so={so}", fused_mlp,
                          "launches_general_rays",
                          lambda so=so: {"rows": fused_mlp.fused_rays_eval(
                              field, params, o, d, d, z, so)},
                          lambda so=so: {"rows": fused_mlp.
                                         mlp_rays_rows_reference(
                                             field, params, o, d, d, z,
                                             so)}))
    for tag, mod, counter, kern, plain in cases:
        before = getattr(mod, counter)
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
        assert getattr(mod, counter) == before + 1, tag
        assert set(got) == set(ref), tag
        for k in ref:
            assert bool(torch.isfinite(got[k]).all()), (tag, k)
            _close(got[k].cpu().numpy(), ref[k].cpu().numpy(), atol=1e-4,
                   err_msg=f"{tag} {k}")
        if "weights" in got:
            assert float(got["weights"].sum(-1).max()) <= 1.0 + 1e-5, tag


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", RAY_COUNTS)
@pytest.mark.parametrize("n_samples", SAMPLES_PER_RAY)
def test_cuda_every_mode_matches_plain(n_samples, n_rays):
    """The default field with both heads, seeded and saturating (σ ×2000):
    composite σ-only and full, relu and softplus, rows σ-only and full, at
    1e-4 scaled above 1."""
    _needs_card()
    field = TorchField()
    o, d, z = _cuda_rays(n_rays, n_samples, seed=n_samples)
    for scale in (5.0, 2000.0):
        _every_mode(field, _field_params(field, scale), o, d, z)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(set(VARIANTS) - {"both_heads"}))
@pytest.mark.parametrize("n_samples", [17, 128, 192])
def test_cuda_variants_match_plain(variant, n_samples):
    """The other head sets and posenc 6/2 (their own instances), 37 rays."""
    _needs_card()
    field = TorchField(**VARIANTS[variant])
    o, d, z = _cuda_rays(37, n_samples, seed=7)
    _every_mode(field, _field_params(field, 5.0, seed=2), o, d, z)


@pytest.mark.gpu
def test_cuda_posenc_20_matches_plain():
    """The largest posenc the kernel takes, 20 frequencies for x and v."""
    _needs_card()
    field = TorchField(N_emb_xyz=20, N_emb_dir=20)
    o, d, z = _cuda_rays(37, 80, seed=9)
    _every_mode(field, _field_params(field, 5.0, seed=3), o, d, z)


@pytest.mark.gpu
def test_cuda_kernel_runs_on_wgmma():
    """Every instance of the kernel holds HGMMA (wgmma) in its SASS
    (cuobjdump of the library the wrapper loaded)."""
    _needs_card()
    fused_mlp_t._library()
    sass = _build.sass_counts(_build.library_path(fused_mlp_t._LIB),
                              "mlp_field_kernel",
                              opcodes=("HGMMA", "FFMA", "LDS", "LDL", "STL"))
    assert len(sass) == 10, list(sass)
    for name, counts in sass.items():
        assert counts["HGMMA"] > 0, name


@pytest.mark.gpu
def test_cuda_single_pass_tf32_misses_the_bar():
    """The kernel with one TF32 product in place of three (the diagnosis
    tool's `one_tf32` build) differs from the plain version by more than
    1e-4 on chip_smoke.py phase 9's inputs, where the kernel stays within
    it: the bar tells the 3×TF32 kernel from a single-pass one."""
    _needs_card()
    fns = {k: v[0] for k, v in exp_mlp_diag.builds(["one_tf32"]).items()}
    diff = exp_mlp_diag.worst(exp_mlp_diag.plain_differences(fns))
    print(f"max |build - plain|: {diff}")
    assert diff["real"] <= exp_mlp_diag.KERNEL_ATOL < diff["one_tf32"], diff


@pytest.mark.gpu
def test_cuda_fp32_chunk_sums_remove_the_truncation_bias():
    """The tensor cores' fp32 sums truncate toward zero: summed over whole
    layers (the rows diagnosis tool's `layer_sums` build, the default
    trunk's rows route) raw σ comes out biased by more than 1e-7 of its
    scale against a float64 plain version, where the kernel's fp32 chunk
    sums stay within 1e-7 (chip_smoke.py phase 11 asserts the same bar),
    on phase 23's weights (seeded, the σ column |w|·5)."""
    _needs_card()
    fns = {k: v[0] for k, v in
           exp_rows_tc_diag.builds(["layer_sums"]).items()}
    bias = exp_rows_tc_diag.sigma_lean(fns, ["default"])[
        "phase 23", "default"]
    print(f"mean signed, max abs error of raw σ: {bias}")
    assert abs(bias["real"][0]) <= 1e-7 < abs(bias["layer_sums"][0]), bias
