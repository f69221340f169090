"""Port parity, the hash-grid encoder and the in-kernel hash probe: the
port's plain versions (what CPU tensors run) against the JAX package —

  * the level layout of `HashGridSpec` field by field, the uint32 corner
    hash bit for bit, and `hashgrid_encode` (values and, on the CPU,
    autograd gradients) against `mirror_nerf_tpu.ops.hashgrid`;
  * `gather_rows` and `dense_level_lookup` against the probe's two Pallas
    kernels (`tools/exp_hash_inkernel.py` `scalar_loop_gather`,
    `dense_matmul_lookup`) in interpret mode, as its `check_parity` runs
    them;

the CPU/CUDA dispatch contract — and, on a machine with a card only, each
mode of `csrc/hashgrid.cu` against its plain version and the encoder's
graph through the backward kernel. Tables are the ±1e-4 init ×1e4 (O(1) values), or errors
would hide."""

import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
from mirror_nerf_tpu.ops import hashgrid as jhg
from mirror_nerf_tpu_torch.models.ngp import NGPField as TorchNGP
from mirror_nerf_tpu_torch.ops import hashgrid as thg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 against fp32: the same single-rounded pos = x·scale + 0.5 on both
# sides, so only the order of the eight weighted corner sums differs
ENC_ATOL = 1e-6
SMALL = dict(num_levels=6, level_dim=2, base_resolution=4,
             log2_hashmap_size=8, per_level_scale=1.7)  # tests/test_ops.py:51


def _specs(kind):
    if kind == "small":
        return jhg.HashGridSpec(**SMALL), thg.HashGridSpec(**SMALL)
    bound = float(kind.split("_")[1])
    return JaxNGP(bound=bound).grid_spec, TorchNGP(bound=bound).grid_spec


def _table(spec, seed):
    """The ±1e-4 init ×1e4: U(±1) rows, as float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1e-4, 1e-4, (spec.table_rows, spec.level_dim))
            * 1e4).astype(np.float32)


def _points(spec, n, seed):
    """n points: ~2 % outside [0,1]³, the corners 0 and 1, points on the
    ±0 faces, and points where x·scale + 0.5 is an integer at some level
    (grid nodes)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.007, 1.007, (n, 3)).astype(np.float32)
    x[0], x[1], x[2], x[3] = 0.0, 1.0, [0.0, 1.0, 0.5], [1.0, 0.0, 0.25]
    lv = spec.levels()
    for i in range(4, 4 + 16):
        li = lv[i % len(lv)]
        node = rng.integers(1, li.resolution, 3)
        x[i] = ((node - 0.5) / np.float32(li.scale)).astype(np.float32)
    return x


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("kind", ["small", "ngp_1", "ngp_6", "ngp_8"])
def test_levels_match_jax(kind):
    js, ts = _specs(kind)
    assert js.table_rows == ts.table_rows
    assert js.output_dim == ts.output_dim
    for a, b in zip(js.levels(), ts.levels(), strict=True):
        for f in ("resolution", "scale", "offset", "size", "use_hash",
                  "dense_strides"):
            assert getattr(a, f) == getattr(b, f), (kind, f)


def test_ngp_bound6_layout():
    """The model's full-width spec: 16 levels, 6,616,280 rows (52.9 MB of
    fp32), levels 0–3 dense (sides 17, 26, 40, 62), 4–15 hashed."""
    spec = TorchNGP(bound=6.0).grid_spec
    lv = spec.levels()
    assert spec.table_rows == 6_616_280 and spec.output_dim == 32
    assert [l.resolution + 1 for l in lv[:4]] == [17, 26, 40, 62]
    assert [l.use_hash for l in lv] == [False] * 4 + [True] * 12
    assert lv[15].resolution == 12288 and lv[15].size == 2 ** 19
    # the CP model keeps its own encoder width
    from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField

    assert TPUGridField(bound=6.0).in_dim == 32


@pytest.mark.parametrize("level", [0, 3, 4, 9, 15])
def test_corner_indices_bit_exact(level):
    """Coordinates up to 12289 (past level 15's resolution, where the
    products overflow 32 bits) and a few negative ones (the wrapped corners
    of an out-of-bound point): the uint32 wrap-around and the modulo."""
    js, ts = _specs("ngp_6")
    rng = np.random.default_rng(level)
    pos = rng.integers(0, 12290, (4096, 3)).astype(np.int32)
    pos[:8] = [[12289, 12289, 12289], [0, 0, 0], [-1, 0, 0], [0, -1, 5],
               [7, 3, -2], [12288, 1, 0], [65535, 65536, 3], [1, 1, 1]]
    want = np.asarray(jhg._corner_indices(js, js.levels()[level],
                                          jnp.asarray(pos)))
    got = thg._corner_indices(ts, ts.levels()[level],
                              torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# ---------------------------------------------------------------- encode


@pytest.mark.parametrize("kind,n", [("small", 512), ("ngp_6", 2000)])
def test_encode_matches_jax(kind, n):
    js, ts = _specs(kind)
    table = _table(ts, seed=1)
    x = _points(ts, n, seed=2)
    want = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                          jnp.asarray(x), js))
    got = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x),
                              ts).numpy()
    oob = ((x < 0) | (x > 1)).any(-1)
    assert 0.005 < oob.mean() < 0.05  # some out of bound, most in
    assert np.all(got[oob] == 0) and np.abs(got[~oob]).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)


def test_encode_gradients_match_jax():
    """On the CPU the plain encoder is differentiable by autograd: the
    table gradient (a scatter-add) and the input gradient (through the
    interpolation weights) against jax.grad."""
    js, ts = _specs("small")
    table = _table(ts, seed=3)
    x = np.random.default_rng(4).uniform(0.02, 0.98, (256, 3)).astype(
        np.float32)
    cot = np.random.default_rng(5).standard_normal(
        (256, ts.output_dim)).astype(np.float32)

    def jloss(t, xx):
        return jnp.sum(jhg.hashgrid_encode(t, xx, js) * cot)

    gt_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                 jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (thg.hashgrid_encode(tt, xt, ts) * torch.from_numpy(cot)).sum().backward()
    # sums of up to a few hundred O(1) terms in another order
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), atol=1e-5,
                               rtol=0)
    # ∂/∂x carries the level scale (≤ 22 here) times table differences
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-4,
                               rtol=1e-5)


def test_init_hashgrid():
    spec = thg.HashGridSpec(**SMALL)
    t = thg.init_hashgrid(torch.Generator().manual_seed(0), spec)
    assert t.shape == (spec.table_rows, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5


# ------------------------------------------------- the probe's kernels


@pytest.fixture(scope="module")
def probe():
    """tools/exp_hash_inkernel.py, loaded from its file (tools/ is not a
    package)."""
    path = os.path.join(REPO, "tools", "exp_hash_inkernel.py")
    spec = importlib.util.spec_from_file_location("jax_exp_hash_inkernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_probe_kernel(probe, dtype):
    """gather_rows_reference == the Pallas scalar-loop gather (interpret
    mode), bit for bit: rows are copied, not computed."""
    rng = np.random.default_rng(6)
    r = 4096
    tt = torch.from_numpy(rng.standard_normal((r, 2)).astype(np.float32))
    tt = tt.to(getattr(torch, dtype))
    idx = rng.integers(0, r, (2, probe.CORNERS * probe.LANES)).astype(
        np.int32)
    tj = jnp.asarray(tt.float().numpy()).astype(getattr(jnp, dtype))
    want = probe.scalar_loop_gather(tj, jnp.asarray(idx), interpret=True)
    got = thg.gather_rows(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_dense_matches_probe_kernel(probe):
    """dense_level_lookup_reference on level 3 at bound 6 (side 62) against
    the Pallas hat-basis matmul kernel (interpret mode) on the
    `reorder_level_table` of that level, at the probe's own bar (atol 2e-6,
    rtol 1e-5), and against the JAX encoder's level-3 slice."""
    js, ts = _specs("ngp_6")
    lv = ts.levels()[3]
    side = lv.resolution + 1
    table = _table(ts, seed=7)
    rows = table[lv.offset:lv.offset + lv.size]
    x = np.random.default_rng(8).random((probe.LANES, 3), dtype=np.float32)
    t2 = jnp.asarray(probe.reorder_level_table(rows, side))
    want = np.asarray(probe.dense_matmul_lookup(
        t2, jnp.asarray(x).T[None], float(lv.scale), interpret=True)[0])
    got = thg.dense_level_lookup(torch.from_numpy(rows), torch.from_numpy(x),
                                 lv.scale, side).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    enc = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x),
                                         js))[:, 6:8]
    np.testing.assert_allclose(got, enc, atol=ENC_ATOL, rtol=0)


def _edge_indices(r, n, seed):
    """n int32 indices uniform in [−2R, 2R), then the edges −1, −R, −R − 1,
    0, R − 1, R and ±2³¹."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2 * r, 2 * r, n).astype(np.int32)
    edges = [-1, -r, -r - 1, 0, r - 1, r, -2 ** 31, 2 ** 31 - 1]
    idx[:len(edges)] = edges
    return idx


@pytest.mark.parametrize("r", [1, 10, 4096])
def test_gather_out_of_range_matches_jax(r):
    """Every int32 index reads JAX's row: `jnp` `table[idx]` counts a
    negative index from the end and clamps the rest into [0, R)."""
    rng = np.random.default_rng(r)
    table = rng.standard_normal((r, 2)).astype(np.float32)
    idx = _edge_indices(r, 4096, seed=r + 1)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = thg.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    if r == 10:  # the rows the satellite names
        small = np.array([-1, -10, -11, -25, 9, 10, 37], np.int32)
        rows = thg.gather_rows_reference(torch.arange(10.0)[:, None],
                                         torch.from_numpy(small))
        assert rows[:, 0].tolist() == [9, 0, 0, 0, 9, 9, 9]


def _dense_oracle(rows, x, scale, side):
    """numpy restatement of DENSE: pos = x·scale + 0.5 rounded once (the
    float64 product), trilinear over the 8 corners, row (x + y·side +
    z·side²) mod R in uint32 arithmetic."""
    pos = (x.astype(np.float64) * np.float64(np.float32(scale)) + 0.5
           ).astype(np.float32)
    pg = np.floor(pos)
    f = pos - pg
    pg = pg.astype(np.int64)
    out = np.zeros((len(x), rows.shape[1]), np.float64)
    for c in range(8):
        bits = np.array([(c >> d) & 1 for d in range(3)])
        cp = (pg + bits) & 0xFFFFFFFF
        idx = (cp[:, 0] + cp[:, 1] * side + cp[:, 2] * side * side) \
            & 0xFFFFFFFF
        w = np.prod(np.where(bits == 1, f, 1 - f), axis=-1)
        out += w[:, None] * rows[idx % len(rows)]
    return out


def test_dense_wraps_out_of_range_corners():
    """DENSE has no out-of-bound mask: a point outside [0,1]³ reads rows
    (x + y·side + z·side²) mod R in uint32, never an index out of range —
    against a numpy restatement, in and out of [0,1]³."""
    ts = TorchNGP(bound=6.0).grid_spec
    lv = ts.levels()[2]
    side = lv.resolution + 1
    rows = _table(ts, 9)[lv.offset:lv.offset + lv.size]
    x = np.random.default_rng(10).uniform(-1.5, 2.5, (512, 3)).astype(
        np.float32)
    got = thg.dense_level_lookup(torch.from_numpy(rows), torch.from_numpy(x),
                                 lv.scale, side).numpy()
    np.testing.assert_allclose(got, _dense_oracle(rows, x, lv.scale, side),
                               atol=ENC_ATOL, rtol=0)


def _jax_dense_level(rows, x, scale, side):
    """One dense level as the JAX package computes it: the level loop of
    `mirror_nerf_tpu/ops/hashgrid.py hashgrid_encode` (pos, floor, the
    corners' weights and their sum) with its `_corner_indices` (uint32
    strided sum, modulo the row count), on a level of any row count, without
    the out-of-bound mask; jitted, as hashgrid_encode is, so that XLA
    contracts x·scale + 0.5 into one FMA."""
    lv = jhg.LevelSpec(side - 1, float(np.float32(scale)), 0, len(rows),
                       False, (1, side, side * side))
    spec = jhg.HashGridSpec(num_levels=1, level_dim=rows.shape[1])

    @jax.jit
    def level(table, x):
        pos = x * lv.scale + 0.5
        pf = jnp.floor(pos)
        frac = pos - pf
        corners = jnp.asarray(jhg._corner_offsets(3))
        idx = jhg._corner_indices(spec, lv, pf.astype(jnp.int32)[None]
                                  + corners[:, None, :])
        w = jnp.prod(jnp.where(corners[:, None, :] == 1, frac[None],
                               1.0 - frac[None]), axis=-1)
        return jnp.sum(w[..., None] * table[idx], axis=0)

    return np.asarray(level(jnp.asarray(rows), jnp.asarray(x)))


@pytest.mark.parametrize("side,rows", [(17, 4920), (17, 4876), (62, 238328),
                                       (62, 200_003)])
def test_dense_matches_jax_at_any_row_count(side, rows):
    """The plain DENSE against the JAX package's level arithmetic on levels
    whose row count is side³ or not (4920 rows of side 17, as the bound-6
    spec's level 0; 4876 and 200,003: the rows wrap inside [0,1]³) at
    samples in [−0.05, 1.05]³ (their uint32 rows wrap too); the samples'
    x-rows are both even and odd, and both ways the kernel loads an x-pair
    (one 16-B load, two 8-B loads) occur."""
    rng = np.random.default_rng(side + rows)
    table = rng.standard_normal((rows, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (4096, 3)).astype(np.float32)
    scale = np.float32(side - 1.0 - 0.37)
    got = thg.dense_level_lookup(torch.from_numpy(table),
                                 torch.from_numpy(x), float(scale), side)
    np.testing.assert_allclose(got.numpy(),
                               _jax_dense_level(table, x, scale, side),
                               atol=ENC_ATOL, rtol=0)
    r8 = thg.dense_corner_rows(rows, torch.from_numpy(x), float(scale), side)
    assert (r8[0] % 2 == 0).any() and (r8[0] % 2 == 1).any()
    # the strided sum before the modulo: some corners wrap the row count
    g = np.floor(x.astype(np.float64) * scale + 0.5).astype(np.int64)
    h = (g[:, 0] + g[:, 1] * side + g[:, 2] * side * side) & 0xFFFFFFFF
    assert (h >= rows).any()
    pairs = thg.dense_pair_loads(r8, 0)
    assert pairs.any() and (~pairs).any()


def _round32(exact: Fraction) -> float:
    """The float32 nearest `exact`, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return float(min(cands, key=lambda c: (
        abs(Fraction(float(c)) - exact), int(np.float32(c).view(np.int32))
        & 1)))


def test_dense_plain_is_the_kernel_arithmetic():
    """The plain DENSE bit for bit against the kernel's arithmetic restated
    in exact rationals: pos = x·scale + 0.5 rounded once, t = pos − ⌊pos⌋,
    w = ((w_x·w_y)·w_z) in fp32, acc = fl(w·v + acc) over corners 0..7
    from 0 (`dense_sum`'s fmaf chain)."""
    side, rows = 17, 4920
    rng = np.random.default_rng(11)
    table = (rng.standard_normal((rows, 2)) * 1e3).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (64, 3)).astype(np.float32)
    scale = np.float32(15.63)
    got = thg.dense_level_lookup_reference(
        torch.from_numpy(table), torch.from_numpy(x), float(scale), side)
    r8 = thg.dense_corner_rows(rows, torch.from_numpy(x), float(scale),
                               side).numpy()
    for i in range(len(x)):
        pos = [np.float32(_round32(Fraction(float(v)) * Fraction(float(scale))
                                   + Fraction(1, 2))) for v in x[i]]
        t = [p - np.floor(p) for p in pos]
        acc = [Fraction(0), Fraction(0)]
        for c in range(8):
            f = [t[d] if (c >> d) & 1 else np.float32(1) - t[d]
                 for d in range(3)]
            w = (f[0] * f[1]) * f[2]
            for k in range(2):
                acc[k] = Fraction(_round32(
                    Fraction(float(w)) * Fraction(float(table[r8[c, i], k]))
                    + acc[k]))
        assert [float(a) for a in acc] == got[i].tolist(), i


# ------------------------------------------------------------- dispatch


def test_dispatch_contract():
    """CPU tensors take the plain version (differentiable, no launch); a
    device with neither raises; mixed devices raise."""
    spec = thg.HashGridSpec(**SMALL)
    table = torch.from_numpy(_table(spec, 10))
    x = torch.rand((16, 3))
    before = (thg.launches_encode, thg.launches_gather, thg.launches_dense)
    out = thg.hashgrid_encode(table.requires_grad_(True), x, spec)
    assert out.requires_grad
    thg.gather_rows(table.detach(), torch.zeros(4, dtype=torch.int32))
    thg.dense_level_lookup(table.detach(), x, 3.0, 5)
    assert (thg.launches_encode, thg.launches_gather,
            thg.launches_dense) == before
    with pytest.raises(ValueError, match="no hash-grid encode path"):
        thg.hashgrid_encode(table.detach().to("meta"), x.to("meta"), spec)
    with pytest.raises(ValueError, match="several devices"):
        thg.hashgrid_encode(table.detach(), x.to("meta"), spec)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers themselves launch or raise: on CPU tensors they
    raise before any build, a table that requires grad included (ENCODE
    has no grad guard since the encoder trains); the differentiable
    encoder runs that table on the CPU through its plain versions."""
    spec = thg.HashGridSpec(**SMALL)
    table = torch.from_numpy(_table(spec, 11))
    x = torch.rand((16, 3))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.hashgrid_encode_cuda(table, x, spec)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.hashgrid_encode_cuda(table.requires_grad_(True), x, spec)
    thg.hashgrid_encode(table, x, spec).sum().backward()
    assert float(table.grad.abs().sum()) > 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.gather_rows_cuda(table.detach(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.dense_level_lookup_cuda(table.detach(), x, 3.0, 5)


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _full_case(n, seed, device="cuda"):
    """The bound-6 spec, a ×1e4 table, n points with ~2 % out of bound and
    the boundary/node points of `_points`."""
    ts = TorchNGP(bound=6.0).grid_spec
    table = torch.from_numpy(_table(ts, seed)).to(device)
    x = _points(ts, max(n, 20), seed + 1)[:n]
    return ts, table, torch.from_numpy(x).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 4096, 100_003])
def test_cuda_encode_matches_plain(n):
    _needs_card()
    ts, table, x = _full_case(n, seed=12)
    before = thg.launches_encode
    with torch.no_grad():
        got = thg.hashgrid_encode(table, x, ts)
        torch.cuda.synchronize()
        assert thg.launches_encode == before + 1
        ref = thg.hashgrid_encode_reference(table, x, ts)
    oob = ((x < 0) | (x > 1)).any(-1)
    if oob.any():
        assert float(got[oob].abs().max()) == 0.0
    # the same single-rounded positions: fp32 corner sums in another order
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_cuda_gather_exact(dtype, c):
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(c)
    table = torch.randn((2 ** 19, c), generator=g, device="cuda").to(dtype)
    idx = torch.randint(0, 2 ** 19, (64, 4096), generator=g, device="cuda",
                        dtype=torch.int32)
    before = thg.launches_gather
    got = thg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert thg.launches_gather == before + 1
    assert got.dtype == dtype and torch.equal(got, table[idx.long()])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_out_of_range(dtype):
    """Indices in [−2R, 2R) with −1, −R, R − 1, R and ±2³¹: the kernel reads
    the plain version's rows (JAX's `table[idx]`), bit for bit."""
    _needs_card()
    r = 4096
    table = torch.randn((r, 2), generator=torch.Generator().manual_seed(3)
                        ).to(dtype).cuda()
    idx = torch.from_numpy(_edge_indices(r, 100_003, seed=4)).cuda()
    got = thg.gather_rows(table, idx)
    torch.cuda.synchronize()
    want = thg.gather_rows_reference(table, idx)
    assert torch.equal(got, want)
    assert torch.equal(got[:3], table[[r - 1, 0, 0]])


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 3])
def test_cuda_dense_matches_plain(level):
    """Bit for bit against the plain version (the kernel's arithmetic), on
    the level as packed and read from its second row (odd rows then 16-B
    aligned, the row count then not side³), at samples whose rows wrap;
    the in-bound samples against ENCODE's slice of the level."""
    _needs_card()
    ts, table, _ = _full_case(20, seed=13)
    lv = ts.levels()[level]
    rows = table[lv.offset:lv.offset + lv.size].contiguous()
    # ~7 % of the points outside [0,1]³: DENSE wraps their rows, no mask
    x = (torch.rand((100_003, 3), generator=torch.Generator().manual_seed(
        level)) * 1.05 - 0.025).cuda()
    for r in (rows[1:], rows):
        before = thg.launches_dense
        got = thg.dense_level_lookup(r, x, lv.scale, lv.resolution + 1)
        torch.cuda.synchronize()
        assert thg.launches_dense == before + 1
        ref = thg.dense_level_lookup_reference(r, x, lv.scale,
                                               lv.resolution + 1)
        assert torch.equal(got, ref)
    inb = ((x >= 0) & (x <= 1)).all(-1)
    enc = thg.hashgrid_encode(table, x, ts)[:, 2 * level:2 * level + 2]
    torch.testing.assert_close(got[inb], enc[inb], atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_grad_guard():
    """A table requiring grad under grad mode no longer raises: the output
    carries the graph (HashEncode), whose backward launches BWD, never a
    silent zero gradient; under no_grad ENCODE alone."""
    _needs_card()
    ts, table, x = _full_case(64, seed=14)
    table.requires_grad_(True)
    n0 = thg.launches_bwd
    y = thg.hashgrid_encode(table, x, ts)
    assert y.requires_grad
    y.sum().backward()
    assert thg.launches_bwd == n0 + 1 and float(table.grad.abs().sum()) > 0
    with torch.no_grad():
        assert thg.hashgrid_encode(table, x, ts).shape == (64, 32)
