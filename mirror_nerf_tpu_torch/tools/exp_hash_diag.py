"""What bounds the fused NGP composite (`hash_field_kernel` of
`csrc/fused_cp_composite.cu`, ops/fused_hash.py): copies of the source with
one piece changed, built beside the real one and timed in turns on the same
inputs, in one process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_hash_diag [--variants ...]

Variants (each a text patch of the source, as in `exp_cp_diag`; the first
two compute wrong values and are timed only, the others must stay within
the bar):

  one_tf32        one TF32 product (a_hi·b_hi) in place of three: the share
                  of the time the tensor pipe's extra products take;
  no_gathers      the levels' corner loads replaced by arithmetic on the
                  positions: the share of the time the gathers take;
  full_2_blocks   the full variant held to 128 registers a thread, two
                  8-warp blocks an SM (its 96 KB of nets fit twice);
  sigma_2_blocks  the σ-only variant at two blocks an SM (128 registers);
  sigma_3_blocks  the σ-only variant at three blocks an SM (85 registers).

With `--dense`, DENSE of `csrc/hashgrid.cu` instead (`mnerf_hash_dense`):
the kernel beside copies with two samples a thread, every corner load
issued before the FMAs (`dense_2_samples`), and with the first design's
body, `interp_level`'s eight 8-B corner loads a sample (`dense_interp`),
on the probe's input (262,144 uniform samples of a side-62 level, ×1e4
rows, `exp_hash_inkernel` DENSE_*) and on a level read from one row in
(odd rows 16-B aligned) with samples that wrap the row count; every build
bit for bit against the plain version; 100 calls a round, best of 5
rounds in turns.

With `--bwd`, BWD and BWD2 of `csrc/hashgrid.cu` (`mnerf_hash_bwd`,
`mnerf_hash_bwd2`) instead: the kernels beside copies without the runs'
on-chip sums (`no_runs`: one reduction a corner and lane, as the first
design), with BWD's corner loads before the table grads' reductions
(`loads_first`) and BWD2's after them (`loads_after2`), on chip_smoke.py
phase 16's four layouts (`bwd_cases`); every build held to the plain versions (the table
grads against float64, the rest against fp32, 1e-5 of scale), timed in
turns on the uniform and ray-ordered layouts (BWD with both outputs, table
grads only, dx01 only; BWD2 with all three), 20 calls a round, best of 5.
With `--bwd_spread N`, the real kernels alone, N runs of each on every
layout: the spread (min, median, max) of the table grads' error against
float64, scaled, beside each layout's bar (`table_bar`).

With `--any [variant ...]`, the general ENCODE, BWD and BWD2 of
`csrc/hashgrid_any.cu` instead, beside copies with one level a block
and each warp storing its own features (`no_stage`: no shared-memory
staging of whole 32-B sectors), the grid ordered point tile outer and
level group inner (`point_major`: the blocks in flight gather from every
level), each corner's row loaded alone (`no_pairs`: no 16-B load of an
x-pair), BWD2's d_dy stored by each lane a (point, level) (`no_stage2`:
no shared-memory staging of a block's rows) and BWD2 with ptxas' own
register target (`bwd2_occupancy`: launch bounds without a block count;
it spills a few words in four instances);
on chip_smoke.py phase 23's five specs (uniform points, ENCODE on
2,097,152, BWD on 131,072 with both outputs, BWD2 with all three and
with (d_table, d_dy)): every build's ENCODE bit for bit with the real
one, its BWD and BWD2 within 2e-3 of each output's scale (atomics); 10
calls a round, best of 3 rounds in turns.

Inputs (`cases`, also chip_smoke.py phase 13's): the hash-grid model at
full width (16 levels × 2, 2¹⁹ rows a level, bound 6; seeded weights with
the table's dense levels ×1e4 and the σ column |w|·5, and a saturating
field, ×2000) on 16384 strided rays of the 800×800 bench camera: S = 128
full (the fine pass's depths merged from the plain coarse weights) and S =
64 σ-only, relu and softplus. Each build launches through the wrapper's own
entry (its ctypes function swapped in), 10 calls a round, best of 3 rounds
in turns; prints ms per call, ptxas' registers and spills of its four
instances, and the largest difference from the plain version over every
case and output (bar 1e-4). Imports only torch and the port; the builds go
to `build/kernels/diag/` (git-ignored).
"""

from __future__ import annotations

import argparse
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build, fused_hash
from . import exp_cp_diag
from .exp_cp_diag import _MMA3, KERNEL_ATOL, _ms

ENTRY = "mnerf_fused_hash_composite"
PATCHES = {
    "one_tf32": [(_MMA3, "  mma_tf32(c, a.hi, b.hi);")],
    "no_gathers": [
        ("        interp_level<2>(rows, L, x[q][0], x[q][1], x[q][2], v);",
         "        v[0] = x[q][0] * L.scale + rows[0];\n"
         "        v[1] = x[q][1] * L.scale - x[q][2];")],
    "full_2_blocks": [("constexpr int HASH_BLOCKS_FULL = 1;",
                       "constexpr int HASH_BLOCKS_FULL = 2;")],
    "sigma_2_blocks": [("constexpr int HASH_BLOCKS_SIGMA = 1;",
                        "constexpr int HASH_BLOCKS_SIGMA = 2;")],
    "sigma_3_blocks": [("constexpr int HASH_BLOCKS_SIGMA = 1;",
                        "constexpr int HASH_BLOCKS_SIGMA = 3;")],
}
WRONG = ("one_tf32", "no_gathers")  # timed only


def hash_params(field, sigma_scale: float, device="cuda") -> dict:
    """Seeded weights (generator seed 0): the table's dense levels ×1e4
    (at the ±1e-4 init σ is ~0 everywhere), the σ column |w|·sigma_scale."""
    p = field.init(torch.Generator().manual_seed(0), device)
    n = sum(lv.size for lv in field.grid_spec.levels() if not lv.use_hash)
    p["grid"][:n] *= 1e4
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * sigma_scale
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    return p


def inputs(n: int = 16384):
    """The hash-grid field at full width and n strided rays of the 800×800
    bench camera on the card: (field, o, d, z64)."""
    from ..core.sampling import stratified_z_vals
    from ..models.ngp import NGPField
    from .exp_launch_ab import camera_rays

    rays_np = camera_rays()
    r = torch.from_numpy(np.ascontiguousarray(
        rays_np[::len(rays_np) // n][:n])).cuda()
    z64 = stratified_z_vals(r[:, 6:7], r[:, 7:8], 64).contiguous()
    return (NGPField(bound=6.0), r[:, 0:3].contiguous(),
            r[:, 3:6].contiguous(), z64)


def cases(n: int = 16384) -> dict:
    """The main path's shapes on the card: case -> (kernel call, plain
    call, params, depths z), seeded and saturating, relu and softplus, S =
    128 full and S = 64 σ-only."""
    from ..core.sampling import merge_fine_z_vals

    field, o, d, z64 = inputs(n)
    out = {}
    with torch.no_grad():
        for pname, scale in (("seeded", 5.0), ("saturating", 2000.0)):
            p = hash_params(field, scale)
            for act in ("relu", "softplus"):
                w = fused_hash.hash_rays_composite_reference(
                    field, p, o, d, d, z64, True, act)["weights"]
                z128 = merge_fine_z_vals(z64, w, 64, 0.0).contiguous()
                for so, z in ((False, z128), (True, z64)):
                    args = (field, p, o, d, d, z, so, act)
                    case = (f"{pname} {act} S={z.shape[1]} "
                            f"{'sigma-only' if so else 'full'}")
                    out[case] = (
                        lambda a=args: fused_hash.fused_hash_rays_composite(
                            *a),
                        lambda a=args: fused_hash.
                        hash_rays_composite_reference(*a), p, z)
    return out


def _swapped(fn, call):
    """`call()` with the wrapper's entry swapped for `fn`."""
    fns = fused_hash._library._fns
    real = fns[ENTRY]
    fns[ENTRY] = fn
    try:
        return call()
    finally:
        fns[ENTRY] = real


def ptxas_lines(log: str) -> list:
    """ptxas' registers and spills of each hash_field_kernel instance."""
    return [f"{_instance(name)}: {v}" for name, v in
            _build.ptxas_by_function(log, "hash_field_kernel").items()]


def _instance(name: str) -> str:
    """hash_field_kernel<σ-only, softplus> from a mangled name."""
    m = re.search(r"hash_field_kernelILb(\d)ELb(\d)E", name)
    return (f"hash_field_kernel<sigma_only {m.group(1)}, softplus "
            f"{m.group(2)}>" if m else name)


def builds(names) -> dict:
    """The real entry and each variant, built in parallel: name -> (ctypes
    entry, ptxas lines of its hash instances)."""
    fused_hash._library()
    out = {"real": (fused_hash._library._fns[ENTRY], ptxas_lines(
        _build.build_log.get(fused_hash._LIB, "")))}
    names = [n for n in names if n != "real"]

    def one(name):
        fn, ptxas = exp_cp_diag.build(f"hash_{name}", {f"hash_{name}":
                                                      PATCHES[name]},
                                      ENTRY, fused_hash._library)
        return fn, ptxas_lines("\n".join(ptxas))

    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(one, names)))
    return out


DENSE_ENTRY = "mnerf_hash_dense"
DENSE_PATCHES = {
    "dense_2_samples": [("constexpr int DENSE_SPT = 1;",
                         "constexpr int DENSE_SPT = 2;")],
    "dense_interp": [
        ("    d[s] = dense_corners(rows, L, x0, x1, x2);\n",
        "    d[s].t[0] = x0;\n    d[s].t[1] = x1;\n    d[s].t[2] = x2;\n"),
        ("    float acc[2];\n    dense_sum(d[s], acc);",
         "    float acc[2];\n    interp_level<2>(rows, L, d[s].t[0], "
         "d[s].t[1], d[s].t[2], acc);")],
}


def dense_inputs():
    """case -> (level rows, x, scale, side): the probe's DENSE input, and a
    level read from its second row (the pairs of odd rows then 16-B
    aligned) at samples in [−0.05, 1.05]³ (their rows wrap)."""
    from .exp_hash_inkernel import DENSE_SAMPLES, DENSE_SCALE, DENSE_SIDE

    g = torch.Generator().manual_seed(4)
    rows = (torch.randn((DENSE_SIDE ** 3 + 1, 2), generator=g) * 1e4).cuda()
    x = torch.rand((DENSE_SAMPLES, 3), generator=g).cuda()
    xw = (x * 1.1 - 0.05).contiguous()
    return {"probe": (rows[:-1], x, DENSE_SCALE, DENSE_SIDE),
            "offset_wrap": (rows[1:], xw, DENSE_SCALE, DENSE_SIDE)}


def dense_main(rounds: int) -> dict:
    """DENSE and its variants, bit for bit and timed in turns."""
    from ..ops import hashgrid

    hashgrid._library()
    fns = {"real": hashgrid._library._fns[DENSE_ENTRY]}
    src = (_build.CSRC / "hashgrid.cu").read_text()

    def one(name):
        return exp_cp_diag.build(f"hash_{name}", {f"hash_{name}":
                                                  DENSE_PATCHES[name]},
                                 DENSE_ENTRY, hashgrid._library,
                                 source=src)[0]

    with ThreadPoolExecutor(len(DENSE_PATCHES)) as pool:
        fns.update(zip(DENSE_PATCHES, pool.map(one, DENSE_PATCHES)))
    real = hashgrid._library._fns
    res = {name: {} for name in fns}
    differ = {name: 0 for name in fns}
    with torch.no_grad():
        for case, (rows, x, scale, side) in dense_inputs().items():
            want = hashgrid.dense_level_lookup_reference(rows, x, scale,
                                                         side)
            call = (lambda rows=rows, x=x, scale=scale, side=side:
                    hashgrid.dense_level_lookup(rows, x, scale, side))
            for name, fn in fns.items():
                real[DENSE_ENTRY] = fn
                try:
                    differ[name] += int((call() != want).sum())
                finally:
                    real[DENSE_ENTRY] = fns["real"]
            for rnd in range(rounds):
                order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
                for name in order:
                    real[DENSE_ENTRY] = fns[name]
                    try:
                        ms = _ms(call, 100)
                    finally:
                        real[DENSE_ENTRY] = fns["real"]
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    print(f"device: {torch.cuda.get_device_name(0)}; DENSE ms per call, "
          f"best of {rounds} rounds in turns; values that differ from the "
          "plain version")
    for name in fns:
        print(f"{name:15s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" (differ {differ[name]})")
    assert not any(differ.values()), differ
    return {"ms": res, "differ": differ}


BWD_ENTRIES = ("mnerf_hash_bwd", "mnerf_hash_bwd2")
BWD_REL = 1e-5  # chip_smoke.py HASH_BWD_REL
# Where one row takes ~10⁵ global reductions (every point in one level-0
# cell, in no order: the few level-1 cells it spans are shared by points
# that are not neighbours, so their rows take one reduction a point),
# fp32's rounding over k sums in a run-dependent order is ~2⁻²⁴·√k of
# scale; that layout's table grads are held to BWD_ROOM times it. A lost
# reduction there reads ~1/(3√k) (dy of either sign: a row's sum grows as
# √k), a sum in bf16, fp16 or TF32 2¹³–2¹⁵ times the rounding: both far
# above the bar.
BWD_ROOM = 4
ONE_CELL = "one level-0 cell"
BWD_POINTS = 131_072
_BWD_LOADS = ("    float2 v[8];\n    if (DX) {\n#pragma unroll\n"
              "      for (int c = 0; c < 8; ++c)\n"
              "        v[c] = live ? __ldg(t2 + row[c]) : "
              "make_float2(0.f, 0.f);\n    }\n")
_BWD_SCATTER = ("    if (TABLE)\n      scatter_level(k, live, row, "
                "[&](int c) {\n        float f[3];\n")
_BWD2_LOADS = ("    float2 v[8];\n    if (DDY || DX) {\n#pragma unroll\n"
               "      for (int c = 0; c < 8; ++c)\n"
               "        v[c] = live ? __ldg(t2 + row[c]) : "
               "make_float2(0.f, 0.f);\n    }\n")
_BWD2_SCATTERED = ("      }, dt);\n"
                   "    float2 ddy = make_float2(0.f, 0.f);\n")
BWD_PATCHES = {
    "no_runs": [("  const bool head = lane == 0 || !live",
                 "  const bool head = true || !live")],
    "loads_first": [(_BWD_LOADS, ""),
                    (_BWD_SCATTER, _BWD_LOADS + _BWD_SCATTER)],
    "loads_after2": [
        (_BWD2_LOADS, "    float2 v[8];\n"),
        (_BWD2_SCATTERED, _BWD2_SCATTERED.replace(
            "    float2 ddy", _BWD2_LOADS.replace(
                "    float2 v[8];\n", "") + "    float2 ddy"))]}


def bwd_cases():
    """chip_smoke.py phase 16's inputs on the card: the full-width spec
    (bound 6: 16 levels × 2, 6,616,280 rows), a U(±1) table and four
    layouts of ~131,072 points with dy (N, 32) and g (N, 3): uniform over
    [−0.02, 1.02]³ and a train batch's ray-ordered samples (1024 strided
    rays of the 800×800 camera × 128 stratified samples), each with edge
    points in front (0 and 1, points outside the cube, points at grid
    nodes of every level); every point in one level-0 cell (pos = x·15 +
    0.5 in [7, 8)³: a corner's row takes every sum); and the ray-ordered
    batch cut to 131,072 − 91 points (no multiple of a tile's 32) with
    every fifth point moved outside the cube, inside the
    runs. Returns (spec, table, {layout: (x, dy, g)})."""
    from ..core.sampling import stratified_z_vals
    from ..models.ngp import NGPField
    from .exp_launch_ab import camera_rays

    spec = NGPField(bound=6.0).grid_spec
    g = torch.Generator().manual_seed(21)
    table = (torch.rand((spec.table_rows, 2), generator=g) * 2 - 1).cuda()
    edge = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5],
            [1.0, 0.0, 0.25], [1.5, 0.5, 0.5], [-0.01, 0.5, 0.5],
            [0.5, 1.0001, 0.5]]
    for lv in spec.levels():
        for k in (1, lv.resolution // 2, lv.resolution - 1):
            c = (k - 0.5) / float(lv.scale)
            edge += [[c, c, c], [c, 0.37, 0.61]]
    edge = torch.tensor(edge, dtype=torch.float32)
    uni = torch.rand((BWD_POINTS, 3), generator=g) * 1.04 - 0.02
    rays = torch.from_numpy(camera_rays(800))
    rays = rays[::rays.shape[0] // 1024][:1024]
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 128)
    xyz = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(
        -1, 3)
    ray = (xyz + 6.0) * float(torch.tensor(1 / 12.0, dtype=torch.float32))
    cell = torch.rand((BWD_POINTS, 3), generator=g) * 0.05 + 0.44
    ragged = ray[:BWD_POINTS - 91].clone()
    ragged[3::5, 1] = 1.25
    cases = {}
    for name, x in (("uniform", uni), ("ray-ordered 1024 x 128", ray),
                    (ONE_CELL, cell),
                    ("ragged, outside points in the runs", ragged)):
        x = x.clone()
        if name != ONE_CELL:
            x[:edge.shape[0]] = edge
        n = x.shape[0]
        cases[name] = (x.cuda().contiguous(),
                       torch.randn((n, 32), generator=g).cuda(),
                       torch.randn((n, 3), generator=g).cuda())
    return spec, table, cases


def table_bar(layout: str, busiest: int) -> float:
    """The table grads' bar (scaled, against float64) on `layout`, whose
    busiest row takes `busiest` global reductions: BWD_REL but on the
    one-cell layout."""
    if layout != ONE_CELL:
        return BWD_REL
    bar = max(BWD_REL, BWD_ROOM * 2.0**-24 * busiest**0.5)
    assert bar <= 1 / (16 * busiest**0.5), (busiest, bar)  # sees a lost one
    return bar


def busiest_row(spec, x, dy) -> int:
    """The most global reductions BWD sends to one row
    (`reduction_plan`)."""
    from ..ops import hashgrid as hg

    rows, _, _ = hg.reduction_plan(spec, x, hg.pair_values(spec, dy))
    return int(torch.bincount(rows).max())


def _bwd_build(name: str) -> dict:
    """A variant of BWD and BWD2 built into build/kernels/diag/: entry ->
    ctypes function, typed as the wrapper's."""
    import ctypes

    from ..ops import hashgrid

    src = (_build.CSRC / "hashgrid.cu").read_text()
    tag = "hash_" + name.replace("+", "_")
    patches = [pt for part in name.split("+") for pt in BWD_PATCHES[part]]
    fn, _ = exp_cp_diag.build(tag, {tag: patches}, BWD_ENTRIES[0],
                              hashgrid._library, source=src)
    lib = ctypes.CDLL(str(_build.BUILD_DIR / "diag" / f"{tag}.so"))
    fn2 = getattr(lib, BWD_ENTRIES[1])
    fn2.argtypes = hashgrid._library.entries[BWD_ENTRIES[1]]
    fn2.restype = ctypes.c_int
    return {BWD_ENTRIES[0]: fn, BWD_ENTRIES[1]: fn2}


def _scaled(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def bwd_main(rounds: int, names=None) -> dict:
    """BWD and BWD2 beside their variants: held to the plain versions on
    the four layouts, timed in turns on two."""
    from ..ops import hashgrid as hg

    hg._library()
    names = list(names or BWD_PATCHES)
    fns = {"real": {e: hg._library._fns[e] for e in BWD_ENTRIES}}
    with ThreadPoolExecutor(len(names)) as pool:
        fns.update(zip(names, pool.map(_bwd_build, names)))
    real = hg._library._fns

    def swapped(name, call):
        real.update(fns[name])
        try:
            return call()
        finally:
            real.update(fns["real"])

    spec, table, layouts = bwd_cases()
    worst = {name: 0.0 for name in fns}
    calls = {}
    with torch.no_grad():
        for layout, (x, dy, g) in layouts.items():
            r1 = hg.encode_backward_reference(table, x, dy, spec)
            r1t = hg.encode_backward_reference(
                table.double(), x.double(), dy.double(), spec, True, False)
            r2 = hg.encode_backward2_reference(table, x, dy, g, spec)
            r2t = hg.encode_backward2_reference(
                table.double(), x.double(), dy.double(), g.double(), spec,
                True, False, False)
            bar = table_bar(layout, busiest_row(spec, x, dy))
            for name in fns:
                a = swapped(name, lambda: hg.encode_backward(table, x, dy,
                                                             spec))
                b = swapped(name, lambda: hg.encode_backward2(
                    table, x, dy, g, spec))
                errs = [_scaled(a[1], r1[1])] + [
                    _scaled(u, v) for u, v in zip(b[1:], r2[1:])]
                table_errs = [_scaled(a[0], r1t[0]), _scaled(b[0], r2t[0])]
                assert max(errs) <= BWD_REL and max(table_errs) <= bar, (
                    name, layout, errs, table_errs, bar)
                worst[name] = max(worst[name], *errs, *table_errs)
            del r1, r1t, r2, r2t
            if layout in ("uniform", "ray-ordered 1024 x 128"):
                calls.update({
                    f"{layout}: BWD": lambda x=x, dy=dy: hg.encode_backward(
                        table, x, dy, spec),
                    f"{layout}: BWD table": lambda x=x, dy=dy:
                        hg.encode_backward(table, x, dy, spec, True, False),
                    f"{layout}: BWD dx01": lambda x=x, dy=dy:
                        hg.encode_backward(table, x, dy, spec, False, True),
                    f"{layout}: BWD2": lambda x=x, dy=dy, g=g:
                        hg.encode_backward2(table, x, dy, g, spec)})
        res = {name: {} for name in fns}
        for rnd in range(rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, call in calls.items():
                    ms = swapped(name, lambda c=call: _ms(c, 20))
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    print(f"device: {torch.cuda.get_device_name(0)}; BWD / BWD2 ms per "
          f"call, best of {rounds} rounds in turns; the largest error "
          "against the plain versions over the four layouts, scaled to the "
          f"largest entry (bar {BWD_REL:.0e}; the one-cell layout's table "
          "grads `table_bar`)")
    for name in fns:
        print(f"{name:12s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" (max err {worst[name]:.3e})")
    return {"ms": res, "max_err": worst}


def bwd_spread(reps: int) -> dict:
    """BWD (both outputs) and BWD2 (all outputs) `reps` times on each of
    the four layouts: the table grads' error against float64 (scaled to
    its largest entry) each run, and the layout's bar."""
    from ..ops import hashgrid as hg

    spec, table, layouts = bwd_cases()
    out = {}
    with torch.no_grad():
        for layout, (x, dy, g) in layouts.items():
            bar = table_bar(layout, busiest := busiest_row(spec, x, dy))
            errs = {}
            for kind in ("BWD", "BWD2"):
                want = (hg.encode_backward_reference(
                    table.double(), x.double(), dy.double(), spec, True,
                    False) if kind == "BWD" else
                    hg.encode_backward2_reference(
                        table.double(), x.double(), dy.double(), g.double(),
                        spec, True, False, False))[0]
                errs[kind] = sorted(
                    _scaled((hg.encode_backward(table, x, dy, spec)
                             if kind == "BWD" else hg.encode_backward2(
                                 table, x, dy, g, spec))[0], want)
                    for _ in range(reps))
                del want
            out[layout] = {"bar": bar, "busiest": busiest, **errs}
            print(f"{layout}: busiest row {busiest} reductions, bar "
                  f"{bar:.3e}; " + "; ".join(
                      f"{k} min {e[0]:.3e}, median {e[len(e) // 2]:.3e}, "
                      f"max {e[-1]:.3e}" for k, e in errs.items())
                  + f" ({reps} runs; {torch.cuda.get_device_name(0)})",
                  flush=True)
            assert max(errs["BWD"][-1], errs["BWD2"][-1]) <= bar, layout
    return out


ANY_ENTRIES = ("mnerf_hash_any_encode", "mnerf_hash_any_bwd",
               "mnerf_hash_any_bwd2")
_ANY_GROUPS = ("  int G = 1;\n"
               "  while (2 * G <= gmax && 2 * G <= a.n_levels) G *= 2;\n")
_ANY_ORDER = ("  const unsigned group = blockIdx.x / tiles;\n"
              "  const long long tile = blockIdx.x - group * tiles;\n")
_ANY_PAIRS = ("  const bool pair = (a ^ b) == 1u;\n"
              "  const bool hi = a & 1u;\n"
              "  if constexpr (CV == 1) {\n"
              "    if ((a ^ b) - 1u < 3u && (vec & TABLE_16)) {\n")
_ANY_STAGE2 = ("  const int stride =\n"
               "      d_dy && BWD_TILE * (lc + 1) <= STAGE_FLOATS ? (int)lc + 1"
               " : 0;\n")
_ANY_BOUNDS2 = ("__global__ void __launch_bounds__(BWD_TILE, 1)\n"
                "    bwd2_any_kernel(")
ANY_PATCHES = {
    "no_stage": [(_ANY_GROUPS, "  int G = 1;\n  (void)gmax;\n")],
    "point_major": [(_ANY_ORDER,
                     "  const unsigned groups = (n_levels + G - 1) / G;\n"
                     "  const unsigned tile = blockIdx.x / groups;\n"
                     "  const unsigned group = blockIdx.x - tile * groups;"
                     "\n")],
    "no_pairs": [(_ANY_PAIRS, _ANY_PAIRS.replace(
        "(a ^ b) == 1u;", "false;").replace(
        "if ((a ^ b) - 1u < 3u && (vec & TABLE_16))", "if (false)"))],
    "no_stage2": [(_ANY_STAGE2, "  const int stride = 0;\n  (void)lc;\n")],
    "bwd2_occupancy": [(_ANY_BOUNDS2, _ANY_BOUNDS2.replace(
        "(BWD_TILE, 1)", "(BWD_TILE)"))]}


def _any_build(name: str) -> dict:
    """A variant of the general ENCODE, BWD and BWD2 built into
    build/kernels/diag/ (the functions ptxas reports spilling printed):
    entry -> ctypes function, typed as the wrapper's."""
    import ctypes

    from ..ops import hashgrid

    src = (_build.CSRC / "hashgrid_any.cu").read_text()
    tag = "hash_any_" + name
    fn, ptxas = exp_cp_diag.build(tag, {tag: ANY_PATCHES[name]},
                                  ANY_ENTRIES[0], hashgrid._any_library,
                                  source=src)
    spills = [ln for ln in ptxas if "spill" in ln and not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
    print(f"{name}: ptxas reports {len(spills)} function(s) that spill"
          + "".join(f"\n  {ln}" for ln in spills))
    lib = ctypes.CDLL(str(_build.BUILD_DIR / "diag" / f"{tag}.so"))
    out = {ANY_ENTRIES[0]: fn}
    for entry in ANY_ENTRIES[1:]:
        out[entry] = getattr(lib, entry)
        out[entry].argtypes = hashgrid._any_library.entries[entry]
        out[entry].restype = ctypes.c_int
    return out


def any_main(rounds: int, names=None) -> dict:
    """The general ENCODE, BWD and BWD2 beside their variants on phase 23's
    five specs: each build held to the real one, then timed in turns."""
    from ..ops import hashgrid as hg
    from .exp_launch_ab import HASH_ANY_SPECS, hash_any_points, hash_any_spec

    hg._any_library()
    names = list(names or ANY_PATCHES)
    real = hg._any_library._fns
    fns = {"real": {e: real[e] for e in ANY_ENTRIES}}
    with ThreadPoolExecutor(len(names)) as pool:
        fns.update(zip(names, pool.map(_any_build, names)))

    def swapped(name, call):
        real.update(fns[name])
        try:
            return call()
        finally:
            real.update(fns["real"])

    calls, worst = {}, {name: 0.0 for name in fns}
    with torch.no_grad():
        for si, spec_name in enumerate(HASH_ANY_SPECS):
            spec = hash_any_spec(spec_name)
            table = (hg.init_hashgrid(torch.Generator().manual_seed(si),
                                      spec) * 1e4).cuda()
            x = hash_any_points(spec, 2_097_152, "uniform", 30 + si)
            xb = x[:131_072].contiguous()
            gen = torch.Generator(device="cuda").manual_seed(50 + si)
            dy = torch.randn((xb.shape[0], spec.output_dim), generator=gen,
                             device="cuda")
            g = torch.randn(xb.shape, generator=gen, device="cuda")
            enc = hg.encode_forward(table, x, spec)
            grads = {
                "BWD": lambda xb=xb, dy=dy, table=table, spec=spec:
                    hg.encode_backward(table, xb, dy, spec),
                "BWD2": lambda xb=xb, dy=dy, g=g, table=table, spec=spec:
                    hg.encode_backward2(table, xb, dy, g, spec),
                "BWD2 (d_table, d_dy)":
                    lambda xb=xb, dy=dy, g=g, table=table, spec=spec:
                    hg.encode_backward2(table, xb, dy, g, spec,
                                        need_dx=False)[:2]}
            want = {k: fn() for k, fn in grads.items()}
            for name in fns:
                got = swapped(name, lambda: hg.encode_forward(table, x, spec))
                assert torch.equal(got, enc), (name, spec_name)
                del got
                for k, fn in grads.items():
                    for a, b in zip(swapped(name, fn), want[k]):
                        err = _scaled(a, b)
                        assert err <= 2e-3, (name, spec_name, k, err)
                        worst[name] = max(worst[name], err)
            del enc, want
            calls[f"{spec_name}: ENCODE"] = (
                lambda x=x, table=table, spec=spec:
                hg.encode_forward(table, x, spec))
            calls.update((f"{spec_name}: {k}", fn) for k, fn in grads.items())
        res = {name: {} for name in fns}
        for rnd in range(rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, call in calls.items():
                    ms = swapped(name, lambda c=call: _ms(c, 10))
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    print(f"device: {torch.cuda.get_device_name(0)}; general ENCODE / BWD "
          f"/ BWD2 ms per call, best of {rounds} rounds in turns; ENCODE bit "
          "for bit with the real build, BWD's and BWD2's largest difference "
          "from it (scaled to each output's largest entry)")
    for name in fns:
        print(f"{name:12s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" (BWD, BWD2 differ by {worst[name]:.2e})")
    return {"ms": res, "max_diff": worst}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dense", action="store_true",
                    help="DENSE's variants instead of the fused kernel's")
    ap.add_argument("--bwd", nargs="*",
                    help="BWD's and BWD2's variants (all without names; "
                         "a+b applies both patches) instead of the fused "
                         "kernel's")
    ap.add_argument("--bwd_spread", type=int, metavar="N",
                    help="N runs of BWD and BWD2 on each layout: the "
                         "table grads' error spread")
    ap.add_argument("--any", nargs="*", choices=list(ANY_PATCHES),
                    help="the general ENCODE's, BWD's and BWD2's variants "
                         "(all without names) instead of the fused kernel's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    if args.any is not None:
        return any_main(args.rounds, args.any)
    if args.dense:
        return dense_main(max(args.rounds, 5))
    if args.bwd_spread:
        return bwd_spread(args.bwd_spread)
    if args.bwd is not None:
        for name in args.bwd:
            for part in name.split("+"):
                if part not in BWD_PATCHES:
                    ap.error(f"--bwd: no variant {part!r} (of "
                             f"{', '.join(BWD_PATCHES)})")
        return bwd_main(max(args.rounds, 5), args.bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = builds(args.variants)
    fns = {k: v[0] for k, v in built.items()}
    all_cases = cases()
    diff = {}
    with torch.no_grad():
        wants = {case: c[1]() for case, c in all_cases.items()}
        for name, fn in fns.items():
            diff[name] = 0.0
            for case, (kern, *_) in all_cases.items():
                got = _swapped(fn, kern)
                for k, v in wants[case].items():
                    diff[name] = max(diff[name], float(
                        (got[k] - v).abs().max()) / max(
                            1.0, float(v.abs().max())))
    timed = {c: v for c, v in all_cases.items() if c.startswith("seeded relu")}
    res = {name: {} for name in fns}
    with torch.no_grad():
        for rnd in range(args.rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, (kern, *_) in timed.items():
                    ms = _swapped(fns[name], lambda k=kern: _ms(k))
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; ms per call, best of {args.rounds} rounds in "
          "turns; max |build - plain| (scaled above 1) over every case (bar "
          f"{KERNEL_ATOL:.0e})")
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"max |build - plain| {diff[name]:.3e}")
        print(f"{name:15s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" ({note})")
        for line in built[name][1]:
            print(f"{'':15s} ptxas: {line}")
    for name, d in diff.items():
        if name not in WRONG:
            assert d <= KERNEL_ATOL, (name, d)
    return {"device": card, "ms": res, "max_diff": diff}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
