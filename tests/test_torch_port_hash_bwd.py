"""The hash encoder's backward kernels, BWD and BWD2 (`csrc/hashgrid.cu`),
at their summation plan: which (row, value) pairs of the table grads a
warp's runs add on chip before one reduction goes to L2
(`ops/hashgrid.reduction_plan`, the plan in plain PyTorch).

On the CPU: the plan's sums equal `index_add_` of every pair and JAX's
vjp of the encoder (BWD) and of its x-vjp (BWD2), on a train batch's
ray-ordered samples, with every point in one level-0 cell and at a ragged
tail; it sends fewer reductions than pairs at the coarse levels of a
ray-ordered batch and one a pair where no neighbours share a cell; a run
ends at a tile's edge and at a point outside the cube; it counts every
pair exactly once, at a ragged tail and around points outside the cube.
On the card (`gpu`):
the kernels on those layouts against their plain versions, and captured in
a CUDA graph.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.ops import hashgrid as jhg
from mirror_nerf_tpu_torch.models.ngp import NGPField
from mirror_nerf_tpu_torch.ops import hashgrid as thg

# 4 levels, 2^10 rows a level at most: levels 0, 1 dense (sides 5, 9), 2, 3
# hashed (as tests/test_torch_port_hash_train.py)
SPEC = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=10, per_level_scale=2.0)
# the plan's float64 sums against index_add_'s (another order) and JAX's
# fp32 vjp: max|a − b| / max(1, max|ref|)
REL64 = 1e-12
REL = 1e-6
# the kernels against the plain versions (chip_smoke.py HASH_BWD_REL)
KERNEL_REL = 1e-5
LAYOUTS = ("ray-ordered", "one-cell", "ragged")


def _specs():
    return jhg.HashGridSpec(**SPEC), thg.HashGridSpec(**SPEC)


def _layout(name: str, rays: int = 3, samples: int = 128, seed: int = 0):
    """(N, 3) float32 points in [0, 1]-ish: `ray-ordered`, `rays` rays of
    `samples` stratified samples each through the cube (their ends
    outside); `one-cell`, every point in [0.44, 0.49]³, one level-0 cell
    of the full-width spec (scale 15: [0.4333, 0.5)³) and of SPEC's (scale
    3: [0.1667, 0.5)³); `ragged`, the ray-ordered layout with 37 more samples
    (N not a multiple of a tile's 32) and every fifth point moved outside
    the cube, inside the runs."""
    rng = np.random.default_rng(seed)
    if name == "one-cell":
        return rng.uniform(0.44, 0.49, (rays * samples, 3)).astype(
            np.float32)
    n_rays = rays + (1 if name == "ragged" else 0)
    pts = []
    for _ in range(n_rays):
        o = rng.uniform(0.3, 0.7, 3)
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        t = (np.arange(samples) + rng.uniform(0, 1, samples)) / samples
        pts.append(o + (t[:, None] * 1.3 - 0.65) * d)
    x = np.concatenate(pts).astype(np.float32)
    if name == "ragged":
        x = x[:rays * samples + 37].copy()
        x[3::5, 1] = 1.25
    return x


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        1.0, float(np.abs(want).max()))


def _scatter(spec, rows, vals):
    return torch.zeros((spec.table_rows, 2), dtype=vals.dtype).index_add_(
        0, rows, vals)


# ------------------------------------------------- the plan on the CPU


@pytest.mark.parametrize("mode", ["bwd", "bwd2"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_sums_equal_index_add(layout, mode):
    """The plan's reductions (the warps' runs) add up to index_add_ of
    every pair (float64: only the order differs); the pairs add up to the
    plain versions' table grads."""
    _, ts = _specs()
    x = torch.from_numpy(_layout(layout)).double()
    rng = np.random.default_rng(1)
    dy = torch.from_numpy(rng.standard_normal((x.shape[0], ts.output_dim)))
    g = torch.from_numpy(rng.standard_normal((x.shape[0], 3)))
    values = thg.pair_values(ts, dy, None if mode == "bwd" else g)
    rows, vals, by_level = thg.reduction_plan(ts, x, values)
    want = _scatter(ts, *thg.table_grad_pairs(ts, x, values))
    assert _rel(_scatter(ts, rows, vals), want) <= REL64
    table = torch.from_numpy(rng.uniform(-1, 1, (ts.table_rows, 2)))
    plain = (thg.encode_backward_reference(table, x, dy, ts, True, False)
             if mode == "bwd" else thg.encode_backward2_reference(
                 table, x, dy, g, ts, True, False, False))[0]
    assert _rel(want, plain) <= REL64
    assert [p for p, _, _ in by_level] == [
        8 * int(thg._in_cube(x).sum())] * ts.num_levels


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_table_grads_match_jax_vjp(layout):
    """index_add_ of the plan (fp32) against JAX's vjp of the encoder for
    the table."""
    js, ts = _specs()
    x = _layout(layout)
    dy = np.random.default_rng(2).standard_normal(
        (x.shape[0], ts.output_dim)).astype(np.float32)
    table = np.zeros((ts.table_rows, 2), np.float32)
    _, vjp = jax.vjp(lambda t: jhg.hashgrid_encode(t, jnp.asarray(x), js),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(dy))
    rows, vals, _ = thg.reduction_plan(ts, torch.from_numpy(x),
                                       thg.pair_values(ts,
                                                       torch.from_numpy(dy)))
    assert _rel(_scatter(ts, rows, vals), want) <= REL


@pytest.mark.parametrize("layout", ["ray-ordered", "one-cell"])
def test_plan_bwd2_table_grads_match_jax_grad_of_grad(layout):
    """index_add_ of BWD2's plan (fp32) against JAX's vjp, for the table,
    of the encoder's x-vjp under the cotangent g of dx01."""
    js, ts = _specs()
    x = _layout(layout)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal((x.shape[0], ts.output_dim)).astype(np.float32)
    g = rng.standard_normal((x.shape[0], 3)).astype(np.float32)
    table = rng.uniform(-1, 1, (ts.table_rows, 2)).astype(np.float32)

    def dx_of(t):
        _, vjp = jax.vjp(lambda xx: jhg.hashgrid_encode(t, xx, js),
                         jnp.asarray(x))
        return vjp(jnp.asarray(dy))[0]

    _, vjp = jax.vjp(dx_of, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    rows, vals, _ = thg.reduction_plan(ts, torch.from_numpy(x),
                                       thg.pair_values(ts,
                                                       torch.from_numpy(dy),
                                                       torch.from_numpy(g)))
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    assert _rel(_scatter(ts, rows, vals), want) <= REL


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_counts_every_pair_once(layout):
    """With every pair's value 1, each row's sum is the number of pairs at
    it: no pair is dropped or added twice, at the ragged tail (N = 421, not
    a multiple of 32) and around the points moved outside the cube
    inside the runs."""
    _, ts = _specs()
    x = torch.from_numpy(_layout(layout)).double()

    def ones(li, f, sign):
        return torch.ones((8, x.shape[0], 2), dtype=torch.float64)

    rows, vals, by_level = thg.reduction_plan(ts, x, ones)
    pair_rows, _ = thg.table_grad_pairs(ts, x, ones)
    want = torch.bincount(pair_rows, minlength=ts.table_rows).double()
    got = _scatter(ts, rows, vals)
    assert torch.equal(got[:, 0], want) and torch.equal(got[:, 1], want)
    assert float(got[:, 0].sum()) == pair_rows.numel()
    for pairs, red, per_tile in by_level:
        assert 0 < red <= pairs and per_tile <= 8 * thg.BWD_TILE
    if layout == "ragged":
        assert x.shape[0] % thg.BWD_TILE and (~thg._in_cube(x)).sum() > 80


def test_plan_cuts_the_coarse_levels_of_a_ray_batch():
    """On a train batch's ray-ordered samples at the model's full width the
    warps' runs send several times fewer reductions than pairs at level 0
    and fewer at every dense level. On one level-0 cell every tile is one
    run: 8 reductions a tile at level 0."""
    spec = NGPField(bound=6.0).grid_spec
    x = torch.from_numpy(_layout("ray-ordered", rays=8)).double()
    dy = torch.ones((x.shape[0], spec.output_dim), dtype=torch.float64)
    values = thg.pair_values(spec, dy)
    _, _, warps = thg.reduction_plan(spec, x, values)
    pairs0, red0, tile0 = warps[0]
    assert red0 * 4 < pairs0, warps[0]
    for i, lv in enumerate(spec.levels()):
        if not lv.use_hash:
            assert warps[i][1] < warps[i][0], (i, warps[i])
    assert tile0 < 8 * thg.BWD_TILE / 4
    one = torch.from_numpy(_layout("one-cell")).double()
    ones = torch.ones((one.shape[0], spec.output_dim), dtype=torch.float64)
    tiles = -(-one.shape[0] // thg.BWD_TILE)
    values = thg.pair_values(spec, ones)
    _, _, w1 = thg.reduction_plan(spec, one, values)
    assert w1[0][1] == 8 * tiles and w1[0][2] == 8.0


def test_plan_constants_are_the_kernels():
    """The plan's tile is the kernel's (`csrc/hashgrid.cu`), and a block
    takes one tile."""
    src = (Path(thg.__file__).resolve().parents[1] / "csrc"
           / "hashgrid.cu").read_text()
    assert re.search(rf"constexpr int TILE = {thg.BWD_TILE};", src)
    assert "return (unsigned)((n + TILE - 1) / TILE);" in src


def test_plan_sends_a_reduction_a_pair_where_no_neighbours_share_a_cell():
    """Points in shuffled order, each in a cell of its own at every level
    (a 4 × 4 × 4 lattice of cell centres at the finest level, shuffled so
    no two neighbours share a level-0 cell either): every pair is its own
    run, one reduction a pair at every level."""
    _, ts = _specs()
    lv = ts.levels()[-1]
    c = (np.arange(4) * 8 + 4.0) / float(np.float32(lv.scale))
    x = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    order = np.argsort((x * [1.0, 3.0, 9.0]).sum(-1) % 0.37)
    x = torch.from_numpy(x[order].astype(np.float32)).double()
    coarse, _ = thg._grid_pos(x, ts.levels()[0].scale, 0.5)
    assert not bool((coarse[1:] == coarse[:-1]).all(-1).any())
    values = thg.pair_values(ts, torch.ones((x.shape[0], ts.output_dim),
                                            dtype=torch.float64))
    _, _, by_level = thg.reduction_plan(ts, x, values)
    for pairs, red, _ in by_level:
        assert red == pairs == 8 * x.shape[0]


@pytest.mark.parametrize("cut", ["tile edge", "outside point"])
def test_plan_ends_a_run_at_a_tile_edge_and_an_outside_point(cut):
    """64 points in one cell of every level: from point 16 on, the first
    16 outside the cube (a run across the edge of tiles 0 and 1: two
    runs), or from point 0 with point 40 moved outside the cube (a run cut
    in two inside tile 1: three runs). Level 0 sends 8 reductions a run,
    and the sums add up to the pairs."""
    _, ts = _specs()
    n = 64
    x = np.full((n, 3), 0.51, np.float32)
    x += np.random.default_rng(4).uniform(0, 1e-3, (n, 3)).astype(np.float32)
    if cut == "tile edge":
        x[:16, 2] = -0.5
        runs = 2  # points 16..31 and 32..63
    else:
        x[40, 0] = 1.5
        runs = 3  # points 0..31, 32..39 and 41..63
    x = torch.from_numpy(x).double()

    def ones(li, f, sign):
        return torch.ones((8, n, 2), dtype=torch.float64)

    rows, vals, by_level = thg.reduction_plan(ts, x, ones)
    live = int(thg._in_cube(x).sum())
    assert by_level[0][1] == 8 * runs
    assert float(vals[:, 0].sum()) == 8 * live * ts.num_levels


def test_plan_refuses_a_spec_the_kernels_do_not_take():
    """Four features a level (the kernels take the model's two): the plan
    raises, as the wrappers do."""
    spec = thg.HashGridSpec(**{**SPEC, "level_dim": 4})
    x = torch.full((4, 3), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="2 features a level"):
        thg.reduction_plan(spec, x, lambda li, f, sign: None)


# ------------------------------------------------------ on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _card_case(layout: str, seed: int):
    """The model's bound-6 spec, a U(±1) table and `layout`'s points (16
    rays of 128 samples, or as many in one cell; ragged: 16 · 128 + 37)
    with seeded dy and g, on the card."""
    spec = NGPField(bound=6.0).grid_spec
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_rows, 2)).astype(np.float32)
    x = _layout(layout, rays=16, seed=seed)
    dy = rng.standard_normal((x.shape[0], spec.output_dim)).astype(
        np.float32)
    g = rng.standard_normal((x.shape[0], 3)).astype(np.float32)
    return spec, [torch.from_numpy(a).cuda() for a in (table, x, dy, g)]


def _scaled(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one-cell", "ragged"])
def test_cuda_bwd_and_bwd2_on_stress_layouts(layout):
    """BWD (each output subset) and BWD2 (all outputs) against their plain
    versions: the table grads within 1e-5 of scale against float64, the
    rest against fp32; zero outside the cube."""
    _needs_card()
    spec, (table, x, dy, g) = _card_case(layout, seed=11)
    r64 = thg.encode_backward_reference(table.double(), x.double(),
                                        dy.double(), spec)
    ref = thg.encode_backward_reference(table, x, dy, spec)
    out = ~thg._in_cube(x)
    for need in ((True, True), (True, False), (False, True)):
        got = thg.encode_backward(table, x, dy, spec, *need)
        if need[0]:
            assert _scaled(got[0], r64[0]) <= KERNEL_REL
        if need[1]:
            assert _scaled(got[1], ref[1]) <= KERNEL_REL
            assert bool((got[1][out] == 0).all())
    got2 = thg.encode_backward2(table, x, dy, g, spec)
    r642 = thg.encode_backward2_reference(table.double(), x.double(),
                                          dy.double(), g.double(), spec)
    ref2 = thg.encode_backward2_reference(table, x, dy, g, spec)
    assert _scaled(got2[0], r642[0]) <= KERNEL_REL
    for a, b in zip(got2[1:], ref2[1:]):
        assert _scaled(a, b) <= KERNEL_REL
    assert bool((got2[1][out] == 0).all()) and bool((got2[2][out] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one-cell", "ragged"])
def test_cuda_graph_capture_of_bwd_and_bwd2(layout):
    """BWD and BWD2 captured in a CUDA graph replay to their eager results
    (the table grads within 1e-5 of scale: atomics add in a run-dependent
    order, the rest bit for bit), the launch counters moving at capture
    only."""
    _needs_card()
    spec, (table, x, dy, g) = _card_case(layout, seed=12)
    eager = (*thg.encode_backward(table, x, dy, spec),
             *thg.encode_backward2(table, x, dy, g, spec))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the launch cache off capture
        thg.encode_backward(table, x, dy, spec)
        thg.encode_backward2(table, x, dy, g, spec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = (thg.launches_bwd, thg.launches_bwd2)
    with torch.cuda.graph(graph):
        outs = (*thg.encode_backward(table, x, dy, spec),
                *thg.encode_backward2(table, x, dy, g, spec))
    n1 = (thg.launches_bwd, thg.launches_bwd2)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert (thg.launches_bwd, thg.launches_bwd2) == n1 == (n0[0] + 1,
                                                           n0[1] + 1)
    for k, (a, b) in enumerate(zip(outs, eager)):
        if k in (0, 2):  # BWD's and BWD2's table grads
            assert _scaled(a, b) <= KERNEL_REL
        else:
            assert torch.equal(a, b), k
