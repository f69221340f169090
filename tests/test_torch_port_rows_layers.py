"""Port parity, the layer-major PE-MLP rows kernel of trunks wider than 4096
(`csrc/fused_mlp_layers.cu`: each layer one 3×TF32 `wgmma` GEMM over a
chunk of samples, the activations in global memory between layers):

  * the packed buffer (`fused_mlp.pack_layers`) and the plan
    (`fused_mlp.layers_plan`) read back: each GEMM's B tiles give the
    field's weights as TF32 hi = rna(w), lo = rna(w − hi) in the GEMM's K
    order (posenc rows first in a skip layer, zeros in the padding), and
    every record's offsets, K segments, N, bias and epilogue are the
    layer's;
  * the plan run in float64 from those planes (A and B split into hi and
    lo, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each layer's output rounded to
    fp32, in chunks) against the plain version, full and σ-only;
  * the chunk plan: chunks that cover the samples exactly, each a multiple
    of the 128-sample tile, the workspace under its cap;
  * the packed buffer kept per params and repacked after an in-place
    update;

and, on a machine with a card only: the kernel on the small trunks, rays
(full and σ-only) and points, and a width-4224 trunk through the route,
against the plain version at 1e-4 scaled above 1."""

import numpy as np
import pytest
import torch

from mirror_nerf_tpu_torch.models.embedding import posenc
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField as TorchField
from mirror_nerf_tpu_torch.ops import fused_mlp as fm
from mirror_nerf_tpu_torch.ops.fused_cp import tf32_round
from mirror_nerf_tpu_torch.train.checkpoints import params_from_numpy
from test_torch_port_spec_range import TRUNKS, _close, _rays, _t, _trunk_params

# the spec-range tests' trunks and the default one
LAYER_TRUNKS = {**TRUNKS, "default": {}}
# the emulation sums each layer in float64 and rounds it to fp32, the plain
# version runs fp32: summation order through a few layers only
ATOL = 1e-5


def _case(trunk: str, seed: int = 0):
    kw = LAYER_TRUNKS[trunk]
    tf = TorchField(**kw)
    return tf, params_from_numpy(_trunk_params(kw, seed))


def untile_planes(flat: torch.Tensor, r: int, k: int) -> tuple:
    """`fm.tile_planes` undone: (hi, lo), each (r, k)."""
    x = flat.reshape(r // 128, k // 16, 2, 2, 128, 2, 4).permute(
        2, 0, 4, 1, 3, 5, 6)
    odd = (torch.arange(128) // 4 % 2).bool()
    x = torch.where(odd.view(1, 1, -1, 1, 1, 1, 1), x.flip(5), x)
    x = x.reshape(2, r, k)
    return x[0], x[1]


def chunks(m: int, rows: int) -> list:
    """(first sample, samples) of each chunk, as the entry walks them."""
    return [(s, min(rows, m - s)) for s in range(0, m, rows)]


def _record(plan: list, i: int) -> list:
    at = fm.PLAN_HEADER + fm.PLAN_REC * i
    return plan[at:at + fm.PLAN_REC]


def _ranges(rec: list) -> list:
    """A record's ranges: (first column, columns, activation, split K
    tiles, split offset, fp32 offset, fp32 row stride, bias offset)."""
    return [rec[9 + 8 * r:17 + 8 * r] for r in range(rec[8])]


# ------------------------------------------ the packed buffer and its plan


@pytest.mark.parametrize("trunk", sorted(LAYER_TRUNKS))
def test_layers_pack_and_plan_read_back(trunk):
    """Every GEMM of the full plan: its B tiles read back (`untile_planes`)
    are hi = rna(w), lo = rna(w − hi) of the field's weights at the GEMM's
    columns and K rows, zero elsewhere; the record's K segments, N, bias
    and epilogue are the layer's; the final dots' leaves are the field's."""
    tf, p = _case(trunk)
    spec = fm.trunk_spec(p)
    width, depth, skips, pe, dpe = spec[:5]
    nets = fm.pack_layers(p)
    plan = fm.layers_plan(spec, False, 1000)
    named = fm._named(p)
    floats = fm.buffer_floats(width, pe, dpe)
    gemms = fm.layer_gemms(*spec)
    assert plan[1] == len(gemms) == depth + 2
    assert plan[2] == -(-pe // 16) and plan[4] == -(-dpe // 16)
    acts = {v: k for k, v in fm._ACTS.items()}
    for i, (segs, ranges) in enumerate(gemms):
        rec = _record(plan, i)
        b_off, nt, kt, nseg = rec[:4]
        assert b_off == fm.layers_layout(spec)["b"][i]
        assert nseg == len(segs) == (2 if i in skips or i == depth + 1
                                     else 1)
        assert kt == sum(rec[5 + 2 * s] for s in range(nseg))
        hi, lo = untile_planes(nets[b_off:b_off + nt * kt * fm.TILE],
                               nt * 128, kt * 16)
        want = fm.gemm_weights(named, segs, ranges, floats)
        assert torch.equal(hi, tf32_round(want))
        assert torch.equal(lo, tf32_round(want - tf32_round(want)))
        # the weights at their columns and K rows, posenc rows first
        for (leaf, n, act, split, f32), r in zip(ranges, _ranges(rec)):
            n0, rn, ract, skt, _, f32_off, ld, bias = r
            assert (rn, acts[ract]) == (n, act)
            assert (skt > 0) == (split is not None)
            assert (f32_off >= 0) == (f32 is not None)
            assert ld == (n if f32 else 0)
            torch.testing.assert_close(nets[bias:bias + n],
                                       named[leaf]["b"], rtol=0, atol=0)
            w = named[leaf]["w"]
            k0 = 0
            for s, (buf, row0, rows) in enumerate(segs):
                kp = rec[5 + 2 * s] * 16
                got = (hi + lo)[n0:n0 + n, k0:k0 + kp]
                torch.testing.assert_close(got[:, :rows],
                                           w[row0:row0 + rows].t(),
                                           rtol=2e-7, atol=0)
                assert not got[:, rows:].any()
                k0 += kp
            assert not (hi[n0 + n:n0 + -(-n // 128) * 128]).any()
        if i < depth:
            assert ranges[0][0] == f"trunk{i}" and ranges[0][2] == "relu"
            if i:  # the previous layer's split output, after the posenc
                assert rec[4 + 2 * (nseg - 1)] == _record(plan, i - 1)[13]
    assert [r[0] for r in gemms[depth][1]] == (
        ["xyz_final"] + ["normal0"] * tf.predict_normal
        + ["mirror0"] * tf.predict_mirror_mask)
    for name, off in zip(fm.FINISH_LEAVES, plan[10:18]):
        leaf, part = name.split(".")
        if leaf not in named:
            assert off == -1
            continue
        v = named[leaf][part].reshape(-1)
        assert torch.equal(nets[off:off + v.numel()], v)


def emulate_layers(field, params: dict, xyz, dirs, sigma_only: bool,
                   cap: int = fm.WORKSPACE_CAP) -> torch.Tensor:
    """The kernel's sequence in float64 from the packed buffer and the plan
    for these samples: chunk by chunk, the posencs padded to the plan's K
    tiles, each GEMM's A and B split into TF32 hi and lo and multiplied as
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, its ranges' bias and activation,
    the output rounded to fp32 into the workspace buffers the record
    names; then the final dots."""
    nets = fm.pack_layers(params).double()
    plan = fm.layers_plan(fm.trunk_spec(params), sigma_only, xyz.shape[0],
                          cap)
    w = field.width
    acts = {0: lambda y: y, 1: torch.relu,
            2: lambda y: torch.nn.functional.leaky_relu(y, 0.01)}
    out = []
    for start, n in chunks(xyz.shape[0], plan[0]):
        m = -(-n // 128) * 128

        def rows_of(t, k):  # (m, k) fp32: the chunk's rows, zeros past them
            z = torch.zeros((m, k), dtype=torch.float32)
            z[:n, :t.shape[1]] = t[start:start + n]
            return z

        bufs = {plan[3]: rows_of(posenc(xyz, field.N_emb_xyz), 16 * plan[2])}
        if not sigma_only:
            bufs[plan[5]] = rows_of(posenc(dirs, field.N_emb_dir),
                                    16 * plan[4])
        for i in range(plan[1]):
            b_off, nt, kt, nseg = (rec := _record(plan, i))[:4]
            a = torch.cat([bufs[rec[4 + 2 * s]] for s in range(nseg)], 1)
            assert a.shape[1] == 16 * kt
            a_hi = tf32_round(a)
            a_lo = tf32_round(a - a_hi)
            b_hi, b_lo = untile_planes(
                nets[b_off:b_off + nt * kt * fm.TILE].float(), nt * 128,
                kt * 16)
            y = (a_lo.double() @ b_hi.double().t()
                 + a_hi.double() @ b_lo.double().t()
                 + a_hi.double() @ b_hi.double().t())
            for n0, rn, act, skt, split, f32, ld, bias in _ranges(rec):
                v = acts[act](y[:, n0:n0 + rn] + nets[bias:bias + rn]).float()
                if skt:
                    assert 16 * skt == rn
                    bufs[split] = v
                if f32 >= 0:
                    assert ld == rn
                    bufs[f32] = v
        h = bufs[plan[6]][:n].double()

        def leaf(k, shape):
            off = plan[10 + fm.FINISH_LEAVES.index(k)]
            return nets[off:off + int(np.prod(shape))].reshape(shape)

        sigma = h @ leaf("sigma.w", (w, 1)) + leaf("sigma.b", (1,))
        if sigma_only:
            out.append(sigma)
            continue
        row = torch.zeros((n, 8), dtype=torch.float64)
        row[:, :1] = sigma
        c = bufs[plan[7]][:n].double()
        row[:, 1:4] = torch.sigmoid(c @ leaf("rgb.w", (w // 2, 3))
                                    + leaf("rgb.b", (3,)))
        if plan[8] >= 0:
            nv = (bufs[plan[8]][:n].double() @ leaf("normal1.w", (w // 2, 3))
                  + leaf("normal1.b", (3,)))
            row[:, 4:7] = nv * torch.rsqrt(torch.clamp_min(
                (nv * nv).sum(-1, keepdim=True), 1.1920929e-07))
        if plan[9] >= 0:
            row[:, 7:] = torch.sigmoid(
                bufs[plan[9]][:n].double() @ leaf("mirror1.w", (w // 2, 1))
                + leaf("mirror1.b", (1,)))
        out.append(row)
    return torch.cat(out)


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("trunk", sorted(LAYER_TRUNKS))
def test_layers_emulation_matches_plain(trunk, sigma_only):
    """The plan run in float64 from the packed planes, in chunks of 128
    samples (a cap that fits one tile), gives the plain version's rows at
    1e-5 scaled above 1; the plain version matches the JAX field modules
    (`test_rows_match_jax_field_modules`)."""
    tf, p = _case(trunk, seed=2)
    o, d, z = _rays(4, 70, seed=3)
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    xyz, dirs = _t(xyz, np.repeat(d, 70, 0))
    spec = fm.trunk_spec(p)
    cap = fm.chunk_rows(spec, sigma_only, 128) * 4 * sum(
        fm.buffer_floats(tf.width, spec[3], spec[4])[b] for b in fm._buffers(
            fm.layer_gemms(*spec, sigma_only), sigma_only))
    assert fm.chunk_rows(spec, sigma_only, xyz.shape[0], cap) == 128
    got = emulate_layers(tf, p, xyz, dirs, sigma_only, cap)
    want = fm.mlp_rows_reference(tf, p, xyz, dirs, sigma_only)
    assert got.shape == want.shape == (280, 1 if sigma_only else 8)
    assert float(want[:, 0].std()) > 0.1  # not vacuous
    _close(got.numpy(), want.numpy(), ATOL, trunk)


@pytest.mark.parametrize("m", [1, 1000, 8192, 2_097_152])
@pytest.mark.parametrize("width", [128, 384, 4224, 8192])
def test_chunk_plan_covers_the_samples(width, m):
    """The chunks cover the m samples exactly and in order, each within a
    chunk that is a multiple of the 128-sample tile; the plan's workspace
    stays under the cap, full and σ-only."""
    kw = dict(width=width, depth=2, skips=(1,))
    tf = TorchField(**kw)
    spec = (width, 2, (1,), tf.in_xyz, tf.in_dir, True, True)
    for sigma_only in (False, True):
        rows = fm.chunk_rows(spec, sigma_only, m)
        assert rows >= 128 and rows % 128 == 0
        assert rows <= -(-m // 128) * 128
        parts = chunks(m, rows)
        assert parts[0][0] == 0 and sum(n for _, n in parts) == m
        assert all(s + n == s2 for (s, n), (s2, _) in zip(parts, parts[1:]))
        assert all(0 < n <= rows for _, n in parts)
        plan = fm.layers_plan(spec, sigma_only, m)
        assert plan[0] == rows
        assert 0 < 4 * plan[fm.PLAN_WS] <= fm.WORKSPACE_CAP


def test_chunk_plan_refuses_a_width_past_the_cap():
    """Where not one 128-sample tile's buffers fit the cap, the plan's
    chunk is 0 and the entry's refusal names the cap."""
    spec = (1 << 20, 1, (), 63, 27, True, True)
    assert fm.chunk_rows(spec, False, 4096) == 0
    assert "workspace cap of 2 GiB" in fm._LAYERS_REFUSALS[-8]


def test_packed_weights_kept_per_params():
    """The packed buffer is kept while the params are the same tensors at
    the same version, and repacked after an in-place update."""
    tf, p = _case("w128_d6_s24")
    first = fm._layers_nets(p)
    assert fm._layers_nets(p) is first
    with torch.no_grad():
        p["sigma"]["b"].add_(1.0)
    second = fm._layers_nets(p)
    assert second is not first and not torch.equal(second, first)
    sb = fm.layers_layout(fm.trunk_spec(p))["leaves"]["sigma.b"]
    assert float(second[sb]) == float(p["sigma"]["b"][0])


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", sorted(LAYER_TRUNKS))
def test_cuda_layers_rows_match_plain(trunk):
    """The kernel's entry on a small trunk: rays (301 × 37, full and
    σ-only; more than one chunk under a small cap is the CPU emulation's)
    and points (1001, full) against the plain version at 1e-4 scaled above
    1."""
    _needs_card()
    kw = LAYER_TRUNKS[trunk]
    tf = TorchField(**kw)
    pt = params_from_numpy(_trunk_params(kw, 6), device="cuda")
    o, d, z = (t.cuda() for t in _t(*_rays(301, 37, seed=7)))
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = d.repeat_interleave(37, 0)
    with torch.no_grad():
        for so in (False, True):
            got = fm.layers_rows_cuda(tf, pt, o, d, None if so else d, z, so)
            ref = fm.mlp_rows_reference(tf, pt, xyz, dirs, so)
            assert bool(torch.isfinite(got).all())
            _close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4,
                   f"{trunk} rays so={so}")
        x, v = xyz[:1001].contiguous(), dirs[:1001].contiguous()
        zeros = torch.zeros_like(x)
        got = fm.layers_rows_cuda(tf, pt, x, zeros, v,
                                  zeros[:, :1].contiguous(), False)
        ref = fm.mlp_rows_reference(tf, pt, x, v)
        _close(got.cpu().numpy(), ref.cpu().numpy(), 1e-4, f"{trunk} points")
