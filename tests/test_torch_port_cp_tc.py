"""Port parity, the tensor-core design of the CP composite kernel
(`csrc/fused_cp_composite.cu`):

  * the plain TF32 split beside the kernel (`fused_cp.tf32_split`) is
    exact, hi + lo == x with hi's low 13 mantissa bits zero, and a 3×TF32
    product (`fused_cp.mma3_reference`) stays within 2⁻²⁰ of float64 at
    the composite's widths, where one TF32 pass does not;
  * the packed weights the wrapper hands the kernel (`_pack_nets`: every K
    in the kernel's fragment order, padded ranks, zero rows for σ) and the
    padded tables reproduce `cp_rows_reference` and the three modes' plain
    versions when multiplied in the kernel's order, emulated here fragment
    column by fragment column — and the JAX kernels through them;
  * the diagnosis tool (`tools/exp_cp_diag.py`) applies a variant's
    patches to a source that holds each once, and refuses one that does
    not (the kernel's own text is not pinned here);

and, on a machine with a card only: every mode and variant against its
plain version at S ∈ {1, 17, 31, 64, 80, 128, 192, 256} and 1, 37 and
16384 rays on the default field, seeded and saturating, a field whose ranks
are padded, HMMA in every instance's SASS, and a build with one TF32
product in place of three outside the 1e-4 bar that the kernel meets."""

import jax
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.ops.pallas.fused_cp import \
    fused_cp_rays_composite as jax_composite
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.ops import _build, fused_cp
from mirror_nerf_tpu_torch.ops.sh import sh_encode
from mirror_nerf_tpu_torch.tools import exp_cp_diag
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy

# a rank that fills its 16 (16), one padded to 16 (8) and one to 32 (20)
LEVELS = ((16, 16), (24, 8), (8, 20))
# the composite's products: (K, N) of the fold at the default 3 × 64
# ranks, the σ-net, color, normal and mirror layers
WIDTHS = [(192, 32), (32, 64), (64, 16), (64, 64), (64, 8), (16, 64),
          (16, 32), (32, 8)]
# the emulation sums in float64, the plain version in fp32: order only
ATOL = 1e-5


def _close(got, want, atol=ATOL, err_msg=""):
    """|got − want| ≤ atol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    bar = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=bar,
                               rtol=0, err_msg=err_msg)


# ------------------------------------------------------------ the split


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e4, 1e30])
def test_tf32_split_is_exact(scale):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32)) * scale
    hi, lo = fused_cp.tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    # round to nearest: |lo| at most half of hi's last place
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())
    assert torch.equal(fused_cp.tf32_round(hi), hi)


def test_tf32_round_ties_away_from_zero():
    """cvt.rna: a value half-way between two TF32 values goes away from 0."""
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12], dtype=torch.float32)
    got = fused_cp.tf32_round(one)
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("k,n", WIDTHS, ids=[f"{k}x{n}" for k, n in WIDTHS])
def test_mma3_error_against_float64(k, n):
    """3×TF32 at the composite's widths: within 2⁻²⁰ of float64, scaled by
    Σ|a||b|; one TF32 pass is ~2⁻¹¹ off, which misses the 1e-4 bar."""
    rng = np.random.default_rng(k * 100 + n)
    a = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.abs().double() @ b.abs().double()).max()
    err3 = float((fused_cp.mma3_reference(a, b) - exact).abs().max() / scale)
    one = (fused_cp.tf32_round(a).double()
           @ fused_cp.tf32_round(b).double())
    err1 = float((one - exact).abs().max() / scale)
    assert err3 <= 2.0 ** -20, err3
    assert err1 > 2.0 ** -14, err1


# ------------------------------------- the packed weights, in kernel order


def _frag_mm(c, wp):
    """A layer fed by the previous layer's C fragments: in k-tile kt a
    lane's A columns t and t+4 are C columns 8kt + 2t and 8kt + 2t + 1,
    against packed rows 8kt + t and 8kt + t + 4 (its B fragment)."""
    out = torch.zeros((c.shape[0], wp.shape[1]), dtype=c.dtype)
    for kt in range(wp.shape[0] // 8):
        for t in range(4):
            out += c[:, 8 * kt + 2 * t, None] * wp[8 * kt + t]
            out += c[:, 8 * kt + 2 * t + 1, None] * wp[8 * kt + t + 4]
    return out


def _quad_mm(f, wp):
    """Inputs fed in quad order (the fold's ranks, c1's SH): in k-tile
    2p + h a lane's A columns t and t+4 are inputs 16p + 4t + 2h and
    16p + 4t + 2h + 1 (one 16-B load holds 16p + 4t … 16p + 4t + 3)."""
    out = torch.zeros((f.shape[0], wp.shape[1]), dtype=f.dtype)
    for kt in range(wp.shape[0] // 8):
        p, h = divmod(kt, 2)
        for t in range(4):
            i = 16 * p + 4 * t + 2 * h
            out += f[:, i, None] * wp[8 * kt + t]
            out += f[:, i + 1, None] * wp[8 * kt + t + 4]
    return out


def kernel_order_rows(field, params, xyz, dirs) -> dict:
    """The field's per-sample outputs computed from the buffers the wrapper
    hands the kernel, in the kernel's order (float64 sums): the padded
    tables read as the kernel reads them, then the fold and every layer
    through `_quad_mm` / `_frag_mm`."""
    levels = tuple(field.grid_levels)
    nets = fused_cp._pack_nets(params, levels).double()
    tables, offs = fused_cp._pack_tables(params, levels)
    tables = tables.double()
    b = float(field.bound)
    x01 = ((xyz + b) / (2.0 * b)).double()
    sum_rp = sum(fused_cp.padded_rank(r) for _, r in levels)
    fold = nets[:sum_rp * 32].reshape(sum_rp, 32)
    feat = torch.zeros((xyz.shape[0], 32), dtype=torch.float64)
    r0 = 0
    for li, (g, r) in enumerate(levels):
        rp = fused_cp.padded_rank(r)
        f = 1.0
        for a in range(3):
            off = offs[3 * li + a]
            tab = tables[off:off + g * rp].reshape(g, rp)
            xf = x01[:, a].clamp(0.0, 1.0) * (g - 1)
            xi = torch.clamp_max(torch.floor(xf).long(), g - 2)
            w = (xf - xi.double())[:, None]
            f = f * (tab[xi] * (1.0 - w) + tab[xi + 1] * w)
        feat += _quad_mm(f, fold[r0:r0 + rp])
        r0 += rp
    mats, at = {}, sum_rp * 32
    for name, k, n in fused_cp.NET_LAYOUT:
        mats[name] = nets[at:at + k * n].reshape(k, n)
        at += k * n
    sg = _frag_mm(torch.relu(_frag_mm(feat, mats["s1"])), mats["s2"])
    d = dirs.double()
    d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    sh = sh_encode(d)
    hc = torch.relu(_quad_mm(sh, mats["c1"][:16])
                    + _frag_mm(sg, mats["c1"][16:]))
    hc = torch.relu(_frag_mm(hc, mats["c2"]))
    rgb = torch.sigmoid(_frag_mm(hc, mats["c3"])[:, :3])
    nrm = _frag_mm(torch.relu(_frag_mm(sg, mats["n1"])), mats["n2"])[:, :3]
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    hm = _frag_mm(sg, mats["m1"]) + mats["m1b"][0]
    hm = torch.where(hm >= 0, hm, 0.01 * hm)
    mir = torch.sigmoid(_frag_mm(hm, mats["m2"])[:, 0] + mats["m2b"][0, 0])
    return {"sigma": sg[:, 0], "rgb3": rgb, "normal3": nrm, "mirror": mir}


@pytest.fixture(scope="module")
def cp():
    jf = JaxField(bound=2.0, grid_levels=LEVELS)
    tf = TorchField(bound=2.0, grid_levels=LEVELS)
    rng = np.random.default_rng(3)
    n, s = 9, 24
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 2.5, (n, s)), -1).astype(np.float32)
    return jf, tf, o, d, z


def _params(jf, sigma_scale: float):
    """σ column made positive and scaled (random-init σ is mostly
    negative); the tables spread ×3 around 1 so that every rank matters."""
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(1)))
    p["sigma_net"][1]["w"][:, 0] = (np.abs(p["sigma_net"][1]["w"][:, 0])
                                    * sigma_scale)
    for axis in p["grid"]["axes"]:
        for li, t in enumerate(axis):
            axis[li] = (1.0 + 3.0 * (t - 1.0)).astype(np.float32)
    return p


@pytest.mark.parametrize("sigma_scale", [5.0, 2000.0],
                         ids=["seeded", "saturating"])
def test_packed_nets_in_kernel_order_reproduce_rows(cp, sigma_scale):
    """Rows mode: the packed weights multiplied in the kernel's order give
    the plain version's σ, rgb, unit normal and mirror."""
    jf, tf, o, d, z = cp
    pt = params_from_numpy(_params(jf, sigma_scale))
    ot, dt, zt = (torch.from_numpy(a) for a in (o, d, z))
    xyz, dirs = fused_cp._ray_samples(ot, dt, dt, zt)
    got = kernel_order_rows(tf, pt, xyz.reshape(-1, 3), dirs.reshape(-1, 3))
    want = fused_cp.cp_rays_rows_reference(tf, pt, ot, dt, dt, zt)
    for k, v in want.items():
        _close(got[k].reshape(v.shape).numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_packed_nets_in_kernel_order_reproduce_composite(cp, act,
                                                         sigma_only):
    """Composite mode: the kernel-order rows, composited, give the plain
    version's weights and per-ray sums — and the JAX kernel's (interpret
    mode)."""
    jf, tf, o, d, z = cp
    p = _params(jf, 5.0)
    pt = params_from_numpy(p)
    ot, dt, zt = (torch.from_numpy(a) for a in (o, d, z))
    xyz, dirs = fused_cp._ray_samples(ot, dt, dt, zt)
    rows = {k: v.reshape(*zt.shape, *v.shape[1:]).float() for k, v in
            kernel_order_rows(tf, pt, xyz.reshape(-1, 3),
                              dirs.reshape(-1, 3)).items()}
    deltas = torch.cat([zt[:, 1:] - zt[:, :-1],
                        torch.full_like(zt[:, :1], 1e10)], -1)
    got = fused_cp.composite_rows(rows, zt, deltas, sigma_only, act)
    want = fused_cp.cp_rays_composite_reference(tf, pt, ot, dt, dt, zt,
                                                sigma_only, act)
    jax_want = jax_composite(jf, p, o, d, d, z, sigma_only=sigma_only,
                             interpret=True, sigma_act=act)
    assert set(got) == set(want) == set(jax_want)
    assert float(want["weights"].max()) > 0.1  # not vacuous
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), err_msg=k)
        _close(got[k].numpy(), np.asarray(jax_want[k]), err_msg=f"jax {k}")


def test_packed_nets_in_kernel_order_reproduce_samples(cp):
    """Per-sample-input mode: view dirs that change along the ray (the SH
    columns per sample) through the kernel order."""
    jf, tf, o, d, z = cp
    pt = params_from_numpy(_params(jf, 5.0))
    rng = np.random.default_rng(4)
    ot, dt, zt = (torch.from_numpy(a) for a in (o, d, z))
    xyz, _ = fused_cp._ray_samples(ot, dt, dt, zt)
    v = torch.from_numpy(rng.normal(size=xyz.shape).astype(np.float32))
    got = kernel_order_rows(tf, pt, xyz.reshape(-1, 3), v.reshape(-1, 3))
    want = fused_cp.cp_rows_reference(tf, pt, xyz, v)
    for k, w in want.items():
        _close(got[k].reshape(w.shape).numpy(), w.numpy(), err_msg=k)


@pytest.mark.parametrize("variant", list(exp_cp_diag.PATCHES))
def test_diagnosis_patches_match_the_source(variant):
    """A variant's patches apply to a source that holds each old text
    once, and the tool refuses a source where one is missing or twice."""
    patches = exp_cp_diag.PATCHES[variant]
    src = "".join(f"// piece {i}\n{old}\n" for i, (old, _) in
                  enumerate(patches))
    got = exp_cp_diag.patched_source(variant, src)
    for old, new in patches:
        assert new in got and (old in new or old not in got)
    with pytest.raises(ValueError, match=variant):
        exp_cp_diag.patched_source(variant, src.replace(patches[-1][0], ""))
    with pytest.raises(ValueError, match=variant):
        exp_cp_diag.patched_source(variant, src + patches[0][0])


# --------------------------------------------------- on a card only

SAMPLES_PER_RAY = [1, 17, 31, 64, 80, 128, 192, 256]
RAY_COUNTS = [1, 37, 16384]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_rays(n: int, s: int, seed: int, bound: float):
    g = torch.Generator().manual_seed(seed)
    o = (torch.randn((n, 3), generator=g) * 0.1 * bound)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    z = torch.sort(torch.rand((n, s), generator=g) * 1.6 * bound
                   + 0.05, -1).values
    return o.cuda(), d.cuda(), z.cuda()


def _field_params(field, scale: float):
    p = field.init(torch.Generator().manual_seed(0), "cuda")
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * scale
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    return p


def _every_mode(field, params, o, d, z):
    """Each mode and variant, kernel against plain: max scaled error and
    the composites' largest Σw; the counters move once a launch."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1],
                        torch.full_like(z[:, :1], 1e10)], -1)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    v = d[:, None, :].expand_as(xyz).contiguous()
    cases = []
    for so in (False, True):
        for act in ("relu", "softplus"):
            cases.append((f"composite {act} so={so}", "launches",
                          lambda so=so, act=act: fused_cp.
                          fused_cp_rays_composite(field, params, o, d, d, z,
                                                  so, act),
                          lambda so=so, act=act: fused_cp.
                          cp_rays_composite_reference(field, params, o, d,
                                                      d, z, so, act)))
            cases.append((f"samples {act} so={so}", "launches_samples",
                          lambda so=so, act=act: fused_cp.
                          fused_cp_forward_composite(field, params, xyz, v,
                                                     z, deltas, so, act),
                          lambda so=so, act=act: fused_cp.
                          cp_samples_composite_reference(
                              field, params, xyz, v, z, deltas, so, act)))
        cases.append((f"rows so={so}", "launches_rows",
                      lambda so=so: fused_cp.fused_cp_rays_eval(
                          field, params, o, d, d, z, so),
                      lambda so=so: fused_cp.cp_rays_rows_reference(
                          field, params, o, d, d, z, so)))
    for tag, counter, kern, plain in cases:
        before = getattr(fused_cp, counter)
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
        assert getattr(fused_cp, counter) == before + 1, tag
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
    """The default field (levels 64:64, 256:64, 512:64, bound 6), seeded
    and saturating (σ ≳ 1e3): COMPOSITE and SAMPLES σ-only and full, relu
    and softplus, ROWS σ-only and full, at 1e-4 scaled above 1."""
    _needs_card()
    field = TorchField(bound=6.0)
    o, d, z = _cuda_rays(n_rays, n_samples, seed=n_samples, bound=6.0)
    for scale in (5.0, 2000.0):
        _every_mode(field, _field_params(field, scale), o, d, z)


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [17, 80, 192])
def test_cuda_padded_ranks_match_plain(n_samples):
    """Ranks 16, 8 and 20 (padded to 16, 16, 32), bound 2, 37 rays."""
    _needs_card()
    field = TorchField(bound=2.0, grid_levels=LEVELS)
    o, d, z = _cuda_rays(37, n_samples, seed=7, bound=2.0)
    _every_mode(field, _field_params(field, 5.0), o, d, z)


@pytest.mark.gpu
def test_cuda_composite_runs_on_the_tensor_cores():
    """Every instance of the composite kernel holds HMMA in its SASS
    (cuobjdump of the library the wrapper loaded)."""
    _needs_card()
    fused_cp._library()
    sass = _build.sass_counts(_build.library_path(fused_cp._LIB),
                              "cp_field_kernel")
    assert len(sass) == 10, list(sass)
    for name, counts in sass.items():
        assert counts["HMMA"] > 0, name


@pytest.mark.gpu
def test_cuda_single_pass_tf32_misses_the_bar():
    """The composite with one TF32 product in place of three (the
    diagnosis tool's `one_tf32` build) differs from the plain version by
    more than 1e-4 on chip_smoke.py phase 3's inputs, where the kernel
    stays within it: the bar tells the 3×TF32 kernel from a single-pass
    one."""
    _needs_card()
    fns = {k: v[0] for k, v in exp_cp_diag.builds(["one_tf32"]).items()}
    diff = exp_cp_diag.worst(exp_cp_diag.plain_differences(fns))
    assert diff["real"] <= exp_cp_diag.KERNEL_ATOL < diff["one_tf32"], diff
