"""The general hash-grid kernels' arithmetic (csrc/hashgrid_any.cu ENCODE,
BWD and BWD2), emulated in plain PyTorch on the CPU:

  * the corners built by trees over the axes (`ops/hashgrid.py
    any_corners`): rows by xor or add of per-axis terms and the level's
    index rule (`index_rule`: mask, none, subtract or modulo) against
    `_corner_indices`, exactly, and weights by doubling in axis order
    against the plain version's products, bit for bit; on every level of
    chip_smoke.py phase 23's five specs, a tiled spec whose levels
    overflow and a spec with C 8, at points at 0, at 1, just below 1 and
    outside (x = 1 with align_corners on an integer scale among them);
  * BWD's reverse walk of the two trees (`Walk::bwd`: a node's adjoint and
    the per-axis sums gf) in float64 against the plain version's dx;
  * BWD2's walk (`walk2`, `Walk2`: the trees carrying the tangent along g,
    the reverse of both for d_x, the top axes' chain) in float64 against
    the plain version's d_table, d_dy and d_x (JAX's grad-of-grad:
    tests/test_torch_port_spec_range.py);
  * BWD's and BWD2's reduction plan (`any_reduction_plan`: runs, x-pair
    merges, shared-memory levels) against `index_add_` of every pair.

The kernels themselves run on a card (tests/test_torch_port_spec_range.py
`-m gpu`, chip_smoke.py phase 23)."""

import dataclasses

import numpy as np
import pytest
import torch

from mirror_nerf_tpu_torch.ops import hashgrid as thg

# chip_smoke.py phase 23's specs (SPEC_HASH over get_encoder's defaults)
PHASE23 = dict(num_levels=16, level_dim=2, base_resolution=16,
               log2_hashmap_size=19, desired_resolution=2048)
SPECS = {
    "2-d, C 2": dict(PHASE23, input_dim=2),
    "3-d, align_corners": dict(PHASE23, align_corners=True),
    "3-d, smoothstep": dict(PHASE23, interpolation="smoothstep"),
    "4-d, C 4": dict(PHASE23, input_dim=4, level_dim=4),
    "7-d, C 1, 8 levels": dict(PHASE23, input_dim=7, level_dim=1,
                               num_levels=8),
    "2-d, C 1, tiled, overflowing": dict(input_dim=2, level_dim=1,
                                         num_levels=4, base_resolution=8,
                                         log2_hashmap_size=6,
                                         gridtype="tiled"),
    "3-d, C 8": dict(input_dim=3, level_dim=8, num_levels=4,
                     base_resolution=4, log2_hashmap_size=10),
    # integer scales 12, 25, 51 with align_corners: dense levels whose
    # index passes their size at x = 1 (the "subtract" rule)
    "3-d, align_corners, base 13": dict(input_dim=3, level_dim=2,
                                        num_levels=3, base_resolution=13,
                                        log2_hashmap_size=16,
                                        align_corners=True),
}
# small specs for the reduction plan and the reverse walk
SMALL = {
    "d1_c4_smooth": dict(input_dim=1, level_dim=4, num_levels=3,
                         base_resolution=5, log2_hashmap_size=6,
                         interpolation="smoothstep"),
    "d2_c2": dict(input_dim=2, level_dim=2, num_levels=4, base_resolution=4,
                  log2_hashmap_size=8),
    "d3_align_c1": dict(input_dim=3, level_dim=1, num_levels=3,
                        base_resolution=4, log2_hashmap_size=8,
                        align_corners=True),
    "d4_c4_tiled": dict(input_dim=4, level_dim=4, num_levels=3,
                        base_resolution=3, log2_hashmap_size=10,
                        gridtype="tiled"),
    "d3_c8": dict(input_dim=3, level_dim=8, num_levels=3,
                  base_resolution=4, log2_hashmap_size=9),
    "d7_c1": dict(input_dim=7, level_dim=1, num_levels=2, base_resolution=2,
                  log2_hashmap_size=12),
}


def _edge_points(d: int, n: int, seed: int) -> torch.Tensor:
    """Points in [0, 1]^D with the edges in front: all 0, all 1, just below
    1, 1 on one axis, outside (1.25, −0.1); then uniform ones."""
    below = np.nextafter(np.float32(1), np.float32(0))
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    edges = [np.zeros(d), np.ones(d), np.full(d, below),
             np.r_[1.0, rng.random(d - 1)], np.r_[rng.random(d - 1), 1.0],
             np.r_[1.25, rng.random(d - 1)], np.r_[rng.random(d - 1), -0.1]]
    return torch.from_numpy(np.concatenate(
        [np.asarray(edges, np.float32)[:, :d], x]))


def _segments(d: int, n_seg: int, per: int, seed: int) -> torch.Tensor:
    """Ray-ordered points: n_seg segments between two uniform points of
    [0, 1]^D, `per` consecutive points along each."""
    rng = np.random.default_rng(seed)
    a, b = rng.random((2, n_seg, 1, d))
    t = np.linspace(0.0, 1.0, per)[None, :, None]
    return torch.from_numpy((a + (b - a) * t).reshape(-1, d).astype(
        np.float32))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tree_corners_match_corner_indices(name):
    """Every level: the tree's rows equal `_corner_indices` for every
    corner of every point in [0, 1]^D, and its weights the plain version's
    products bit for bit."""
    spec = thg.HashGridSpec(**SPECS[name])
    x = _edge_points(spec.input_dim, 256, seed=3)
    live = thg._in_cube(x)
    assert live.any() and not live.all()
    corners = thg._corner_offsets(spec.input_dim, x.device)
    off = 0.0 if spec.align_corners else 0.5
    for lv in spec.levels():
        rows, w = thg.any_corners(spec, lv, x)
        pg, _ = thg._grid_pos(x, lv.scale, off)
        want = lv.offset + thg._corner_indices(spec, lv,
                                               pg[None] + corners[:, None])
        assert torch.equal(rows[:, live], want[:, live]), (name, lv)
        _, f, _, _ = thg._level_corners(spec, lv, x)
        assert torch.equal(w, thg._weights(f)), (name, lv)


def test_align_corners_reaches_the_level_size():
    """x = 1 with align_corners on an integer scale: the upper corner's
    coordinate is the level's side and its raw index reaches the level's
    size. Level 0 of phase 23's 3-d spec (scale 15.0, 16³ rows) takes the
    mask; a level of 13³ rows (scale 12.0, 2200 rows) "subtract". The
    tree's row equals `% size` in both."""
    for kw, rule, side in ((SPECS["3-d, align_corners"], "mask", 16),
                           (SPECS["3-d, align_corners, base 13"],
                            "subtract", 13)):
        spec = thg.HashGridSpec(**kw)
        lv = spec.levels()[0]
        assert np.float32(lv.scale) == side - 1 and not lv.use_hash
        assert thg.index_rule(spec, lv)[0] == rule
        assert thg._max_index(spec, lv) >= lv.size
        rows, w = thg.any_corners(spec, lv, torch.ones((1, 3)))
        raw = sum(side * s for s in lv.dense_strides)  # corner 7 at x = 1
        assert raw >= lv.size
        assert int(rows[7, 0]) == lv.offset + raw % lv.size
        assert float(w[7, 0]) == 0.0 and float(w[0, 0]) == 1.0


@pytest.mark.parametrize("name", sorted(SPECS))
def test_index_rules_by_level(name):
    """The rule of each level: a mask for every power-of-two size (every
    hashed level, and a tiled level that overflows), "none" or "subtract"
    for a dense one (subtract only with align_corners), never a modulo;
    the level table's words 11-13 hold them."""
    spec = thg.HashGridSpec(**SPECS[name])
    words = thg._level_table_any(spec, "cpu").numpy().view(np.uint32)
    for li, lv in enumerate(spec.levels()):
        rule, msk, sub = thg.index_rule(spec, lv)
        if lv.use_hash or spec.gridtype == "tiled" and lv.size < (
                int(np.ceil(lv.scale)) + (1 if spec.align_corners else 2)
        ) ** spec.input_dim:
            assert rule == "mask"
        else:
            assert rule in ("mask", "none", "subtract"), rule
            assert rule != "subtract" or spec.align_corners
        assert tuple(words[li, 11:13]) == (msk, sub)
        assert words[li, 13] == (2 if thg.shared_level(spec, lv) else 0)


def test_modulo_rule_on_a_level_of_any_size():
    """A level whose size is no power of two and whose index passes twice
    the size takes a true modulo, flagged in the level table's word 13."""
    spec = thg.HashGridSpec(input_dim=3, level_dim=2, num_levels=1,
                            base_resolution=16, log2_hashmap_size=10)
    lv = dataclasses.replace(spec.levels()[0], size=1000, use_hash=True)
    assert thg.index_rule(spec, lv) == ("modulo", 0xFFFFFFFF, 0)
    x = _edge_points(3, 200, seed=5)
    rows, _ = thg.any_corners(spec, lv, x)
    pg, _ = thg._grid_pos(x, lv.scale, 0.5)
    want = thg._corner_indices(spec, lv, pg[None] + thg._corner_offsets(
        3, x.device)[:, None])
    live = thg._in_cube(x)
    assert torch.equal(rows[:, live], want[:, live])
    assert int(want.max()) < 1000


def _reverse_walk_dx(spec, table, x, dy):
    """BWD's dx by the kernel's walk (`Walk::bwd`), in float64: two trees
    over the axes at once (bit 0 clear and set), depth first; a leaf's
    adjoint its dot ⟨T_c, dy_l⟩, a node's Σ f_d(b)·adj_b, gf[b][d] the sum of
    prefix·adj_b over the nodes at depth d; dx_d = Σ_l s_l S'_d (gf[1][d] −
    gf[0][d])."""
    d_in, c = spec.input_dim, spec.level_dim
    smooth = spec.interpolation == "smoothstep"
    dx = torch.zeros(x.shape, dtype=torch.float64)
    for li, lv in enumerate(spec.levels()):
        rows, _ = thg.any_corners(spec, lv, x)
        # a point outside the box loads nothing (its rows may pass the level)
        rows = torch.where(thg._in_cube(x)[None], rows, lv.offset)
        _, t = thg._grid_pos(x, lv.scale, 0.0 if spec.align_corners else 0.5)
        t = t.double()
        s = (t * t) * (3 - 2 * t) if smooth else t
        s1 = 6 * t * (1 - t) if smooth else torch.ones_like(t)
        f = (1 - s, s)
        dot = (table.double()[rows] * dy.double()[None, :, c * li:c * li + c]
               ).sum(-1)  # (2^D, N)
        gf = [[torch.zeros_like(t[:, 0]) for _ in range(d_in)]
              for _ in range(2)]

        def walk(depth, wa, wb, ca):
            if depth == d_in:
                return dot[ca], dot[ca + 1]
            adj = []
            for b in (0, 1):
                adj.append(walk(depth + 1, wa * f[b][:, depth],
                                wb * f[b][:, depth], ca + (b << depth)))
            for b in (0, 1):
                gf[b][depth] = gf[b][depth] + wa * adj[b][0] + wb * adj[b][1]
            return tuple(f[0][:, depth] * adj[0][i] + f[1][:, depth]
                         * adj[1][i] for i in (0, 1))

        ada, adb = walk(1, f[0][:, 0], f[1][:, 0], 0)
        gf[0][0] = gf[0][0] + ada
        gf[1][0] = gf[1][0] + adb
        scale = float(np.float32(lv.scale))
        for d in range(d_in):
            dx[:, d] += scale * s1[:, d] * (gf[1][d] - gf[0][d])
    return torch.where(thg._in_cube(x)[:, None], dx,
                       torch.zeros((), dtype=dx.dtype))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reverse_walk_matches_plain_dx(name):
    """The kernel's reverse walk (float64) against the plain version's dx
    (fp32 corner products, pairwise sums): within 1e-6 of scale."""
    spec = thg.HashGridSpec(**SMALL[name])
    rng = np.random.default_rng(7)
    x = _edge_points(spec.input_dim, 120, seed=7)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_rows,
                                                 spec.level_dim))
                             .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32))
    got = _reverse_walk_dx(spec, table, x, dy)
    _, want = thg.encode_backward_reference(table.double(), x.double(),
                                            dy.double(), spec,
                                            need_table=False)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("layout", ["uniform", "ray-ordered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_reduction_plan_sums_every_pair(name, layout):
    """`index_add_` of BWD's plan equals the plain version's table grads
    (`index_add_` of every (row, value) pair) within 1e-6 of scale; runs
    merge on ray-ordered points, x-pairs merge where C ≤ 2."""
    spec = thg.HashGridSpec(**SMALL[name])
    d = spec.input_dim
    x = (_edge_points(d, 300, seed=11) if layout == "uniform"
         else _segments(d, 4, 80, seed=11))
    dy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32))
    table = torch.zeros((spec.table_rows, spec.level_dim))
    el, val, by_level = thg.any_reduction_plan(spec, x, dy)
    got = torch.zeros(table.numel()).index_add_(0, el, val)
    want, _ = thg.encode_backward_reference(table, x, dy, spec,
                                            need_dx=False)
    want = want.reshape(-1)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= 1e-6 * scale, name
    pairs = sum(b["pairs"] for b in by_level)
    sent = sum(b["reductions"] for b in by_level)
    if layout == "ray-ordered":
        assert sent < pairs
    assert [b["shared"] for b in by_level] == [
        thg.shared_level(spec, lv) for lv in spec.levels()]


@pytest.mark.parametrize("layout", ["uniform", "ray-ordered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_bwd2_reduction_plan_sums_every_pair(name, layout):
    """`index_add_` of BWD2's plan (the values u_c = s ∇w_c·g) equals the
    plain BWD2's table grads within 1e-6 of scale; runs merge on
    ray-ordered points."""
    spec = thg.HashGridSpec(**SMALL[name])
    d = spec.input_dim
    x = (_edge_points(d, 300, seed=17) if layout == "uniform"
         else _segments(d, 4, 80, seed=17))
    rng = np.random.default_rng(18)
    dy = torch.from_numpy(rng.standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    table = torch.zeros((spec.table_rows, spec.level_dim))
    el, val, by_level = thg.any_reduction_plan(spec, x, dy, g)
    got = torch.zeros(table.numel()).index_add_(0, el, val)
    want, _, _ = thg.encode_backward2_reference(table, x, dy, g, spec,
                                                need_ddy=False,
                                                need_dx=False)
    want = want.reshape(-1)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= 1e-6 * scale, name
    if layout == "ray-ordered":
        assert sum(b["reductions"] for b in by_level) < sum(
            b["pairs"] for b in by_level)


# the unrolled axes below the walks' loop over the top axes
# (csrc/hashgrid_any.cu WALK_AXES)
WALK_AXES = 3
# the SMALL specs and smoothstep with mixed terms: 3-d (no top axes) and
# 5-d with align_corners (one top axis)
BWD2_WALK = dict(SMALL, d3_smooth_c2=dict(
    input_dim=3, level_dim=2, num_levels=3, base_resolution=4,
    log2_hashmap_size=9, interpolation="smoothstep"), d5_smooth_align_c2=dict(
    input_dim=5, level_dim=2, num_levels=2, base_resolution=3,
    log2_hashmap_size=10, interpolation="smoothstep", align_corners=True))


def walk_bwd2(spec, table, x, dy, g):
    """BWD2 by the kernel's walk (`walk2`, `Walk2`), in float64: per level
    τ_d = g_d S'_d; the two trees over the axes (bit 0 clear and set) carry
    (w, v), a child along axis d with branch b taking w·f_b and v·f_b +
    w·τ_b (τ_1 = τ, τ_0 = −τ); the top axes (above the last WALK_AXES) a
    loop over their paths, each path's prefix kept per axis. A leaf adds
    u_c·dy_l (u_c = s·v_c) to d_table and u_c·T_c to d_dy, and returns its
    dots ⟨T_c, dy_l⟩ as the adjoints of its v (of its w: 0). A node adds
    to gf[d] w·(adj_w1 − adj_w0) + v·(adj_v1 − adj_v0) and to ga[d]
    w·(adj_v1 − adj_v0) and passes up (f_0 adj_w0 + f_1 adj_w1 + τ (adj_v1
    − adj_v0), f_0 adj_v0 + f_1 adj_v1); a path's chain likewise, axis by
    axis, with the root's (w, v) = (1, 0) at axis 0. d_x_d = Σ_l s² (S'_d
    gf[d] + g_d S''_d ga[d]). Returns (d_table, d_dy, d_x), zero outside
    the box."""
    d_in, c = spec.input_dim, spec.level_dim
    smooth = spec.interpolation == "smoothstep"
    live = thg._in_cube(x)
    top = max(d_in - 1 - WALK_AXES, 0)
    gd = torch.where(live[:, None], g.double(), 0.0)
    d_table = torch.zeros(table.shape, dtype=torch.float64)
    d_dy = torch.zeros(dy.shape, dtype=torch.float64)
    d_x = torch.zeros(x.shape, dtype=torch.float64)
    for li, lv in enumerate(spec.levels()):
        rows, _ = thg.any_corners(spec, lv, x)
        rows = torch.where(live[None], rows, lv.offset)
        _, t = thg._grid_pos(x, lv.scale, 0.0 if spec.align_corners else 0.5)
        t = t.double()
        if smooth:
            s, s1, s2 = (t * t) * (3 - 2 * t), 6 * t * (1 - t), 6 - 12 * t
        else:
            s, s1, s2 = t, torch.ones_like(t), torch.zeros_like(t)
        f, tau = (1 - s, s), gd * s1
        scale = float(np.float32(lv.scale))
        dyl = dy.double()[:, c * li:c * li + c]
        rows_t = table.double()[rows]  # (2^D, N, C)
        dot = (rows_t * dyl[None]).sum(-1)
        zero = torch.zeros_like(t[:, 0])
        gf, ga = [zero] * d_in, [zero] * d_in
        acc = torch.zeros_like(dyl)

        def leaf(v, corner):
            nonlocal acc
            u = scale * v
            d_table.index_add_(0, rows[corner], u[:, None] * dyl)
            acc = acc + u[:, None] * rows_t[corner]
            return zero, dot[corner]

        def node(depth, w, v, corner):
            """(w, v) of both halves → the adjoints of each."""
            if depth == d_in:
                (wa, aa), (wb, ab) = leaf(v[0], corner), leaf(v[1], corner + 1)
                return (wa, wb), (aa, ab)
            kids = []
            for b in (0, 1):
                fb = f[b][:, depth]
                tb = tau[:, depth] if b else -tau[:, depth]
                kids.append(node(depth + 1, [wh * fb for wh in w],
                                 [vh * fb + wh * tb for wh, vh in zip(w, v)],
                                 corner + (b << depth)))
            (aw0, av0), (aw1, av1) = kids
            for h in (0, 1):
                gf[depth] = gf[depth] + w[h] * (aw1[h] - aw0[h]) + v[h] * (
                    av1[h] - av0[h])
                ga[depth] = ga[depth] + w[h] * (av1[h] - av0[h])
            f0, f1, tt = f[0][:, depth], f[1][:, depth], tau[:, depth]
            return ([f0 * aw0[h] + f1 * aw1[h] + tt * (av1[h] - av0[h])
                     for h in (0, 1)],
                    [f0 * av0[h] + f1 * av1[h] for h in (0, 1)])

        for j in range(2 ** top):
            w = [[f[0][:, 0], f[1][:, 0]]]
            v = [[-tau[:, 0], tau[:, 0]]]
            bits, corner = [None], 0
            for d in range(1, top + 1):
                b = (j >> (d - 1)) & 1
                fb, tb = f[b][:, d], tau[:, d] if b else -tau[:, d]
                w.append([wh * fb for wh in w[-1]])
                v.append([vh * fb + wh * tb for wh, vh in zip(w[-2], v[-1])])
                bits.append(b)
                corner += b << d
            aw, av = node(top + 1, w[top], v[top], corner)
            for d in range(top, 0, -1):
                sign = 1.0 if bits[d] else -1.0
                fb = f[bits[d]][:, d]
                tb = sign * tau[:, d]
                for h in (0, 1):
                    gf[d] = gf[d] + sign * (aw[h] * w[d - 1][h]
                                            + av[h] * v[d - 1][h])
                    ga[d] = ga[d] + sign * av[h] * w[d - 1][h]
                aw = [aw[h] * fb + av[h] * tb for h in (0, 1)]
                av = [av[h] * fb for h in (0, 1)]
            gf[0] = gf[0] + aw[1] - aw[0]
            ga[0] = ga[0] + av[1] - av[0]
        d_dy[:, c * li:c * li + c] = acc
        for d in range(d_in):
            d_x[:, d] += scale * scale * (s1[:, d] * gf[d]
                                          + gd[:, d] * s2[:, d] * ga[d])
    zero_out = torch.zeros((), dtype=torch.float64)
    return (d_table, torch.where(live[:, None], d_dy, zero_out),
            torch.where(live[:, None], d_x, zero_out))


@pytest.mark.parametrize("name", sorted(BWD2_WALK))
def test_bwd2_walk_matches_plain(name):
    """BWD2's walk (float64) against the plain version's d_table, d_dy and
    d_x (fp32 corner products, pairwise sums): within 1e-6 of each one's
    scale."""
    spec = thg.HashGridSpec(**BWD2_WALK[name])
    rng = np.random.default_rng(19)
    x = _edge_points(spec.input_dim, 120, seed=19)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_rows,
                                                 spec.level_dim))
                             .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    got = walk_bwd2(spec, table, x, dy, g)
    want = thg.encode_backward2_reference(table.double(), x.double(),
                                          dy.double(), g.double(), spec)
    for what, a, b in zip(("d_table", "d_dy", "d_x"), got, want):
        scale = float(b.abs().max())
        assert scale > 0.1, (name, what)
        assert float((a - b).abs().max()) <= 1e-6 * scale, (name, what)
    out = ~thg._in_cube(x)
    assert out.any() and bool((got[2][out] == 0).all())


def test_reduction_plan_merges_x_pairs_and_shares_coarse_levels():
    """On uniform points of a 2-d C 2 spec: level 0 (a coarse dense level)
    is summed in shared memory, a hashed level sends fewer reductions than
    its corners (the {2k, 2k + 1} x-pairs) but more than half of them."""
    spec = thg.HashGridSpec(input_dim=2, level_dim=2, num_levels=6,
                            base_resolution=16, log2_hashmap_size=12)
    lvs = spec.levels()
    assert thg.shared_level(spec, lvs[0]) and lvs[-1].use_hash
    x = _edge_points(2, 2000, seed=13)
    dy = torch.ones((x.shape[0], spec.output_dim))
    _, _, by_level = thg.any_reduction_plan(spec, x, dy)
    assert by_level[0]["shared"]
    assert by_level[0]["reductions"] <= lvs[0].size * 2 * (
        x.shape[0] // thg.ANY_BWD_TILE + 1)
    last = by_level[-1]
    assert not last["shared"]
    assert last["pairs"] / 2 < last["reductions"] < last["pairs"]


@pytest.mark.parametrize("size", [8, 1000, 12168, 3 ** 13, 2 ** 31 + 11,
                                  2 ** 32 - 5])
def test_divisor_magic_is_exact(size):
    """The modulo rule's multiplier M = ⌈2⁶⁴ / size⌉: ⌊i·M / 2⁶⁴⌋ = ⌊i /
    size⌋ for uint32 i at the edges and at random (the kernels' i mod size
    with no division)."""
    lo, hi = thg.divisor_magic(size)
    m = lo | hi << 32
    rng = np.random.default_rng(size % 1000)
    for i in [0, 1, size - 1, size, size + 1, 2 ** 32 - 1,
              *map(int, rng.integers(0, 2 ** 32, 500, dtype=np.uint64))]:
        if i < 2 ** 32:
            assert (i * m) >> 64 == i // size, (size, i)
