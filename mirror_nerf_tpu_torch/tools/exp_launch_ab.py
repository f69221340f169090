"""The launch path of two trees side by side on the card: this tree's
wrappers and those of another checkout of the repository, in one process,
timed in turns.

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python -m mirror_nerf_tpu_torch.tools.exp_launch_ab --other build/other

The other tree's `mirror_nerf_tpu_torch` is imported under another name, so
its wrappers, with its kernels built from its own sources into its own
`build/`, run in this process beside this tree's, on the same inputs. A
yardstick that changes with the host, such as a time per call, is only
compared within one such run.

Per call (`timing.per_call_ms`: CUDA events over 200 back-to-back calls,
the functions of a group in turns, best of 5 rounds), each group with its
library call where there is one:
  gather_fp32, gather_bf16: GATHER (`gather_rows`) on the 2¹⁹ × 2 table at
    idx (64, 4096), and `t[idx]`;
  dense: DENSE (`dense_level_lookup`) on 262,144 samples of a side-62
    level, and trilinear `grid_sample`;
  prefix: SCAN and TRI (`segment_prefix`) on 16384 × 128 values, S = 128,
    and `torch.cumsum` on the segment view (inclusive: timed only);
  weights: WEIGHTS (`prefix_weights`) on the same size, S = 128;
  floor: the launch floor's SMALL wrapper `axpb(x, out)` on (8, 128), and
    `torch.add(1e-6, x, alpha=1.000001, out=y)`;
  moved_cp, moved_train, moved_mlp, moved_mma: the four libraries that
    last moved onto the launch path, at small shapes: the CP
    composite (one ray, S = 16, default field), the CP train forward
    (tangents, 1024 points; ∇σ within 1e-4, as the trees' train kernels
    may differ), the flagship composite (one ray, S = 16) and the int8
    table products (2 blocks, g 64, r 16, 128 lanes).
With `--groups composite`, the CP composite kernel at the main path's
shapes (16384 strided rays of the 800×800 camera, the default field,
seeded weights; 20 calls a round, best of 3): COMPOSITE S = 128 full and
S = 64 σ-only, ROWS S = 128 full, SAMPLES S = 128 full; and each tree's
composite library's registers and spills (ptxas) and its SASS counts of
HMMA, FFMA, LDS and LDG per instance. With `--groups view`: one 800×800
level-2 CP view through each tree's `run_view` (run.sh mode-1 nerf_tpu
flags, --fused_field, chunk 16384, seeded and all-mirror weights made once
and handed to both), a warm view each, then 3 rounds in turns. With
`--groups flagship`: the flagship PE-MLP kernel at its main path's shapes
(16384 strided rays of the 400×300 camera, the default field, seeded
weights; 5 calls a round, best of 3): composite S = 128 full and S = 64
σ-only, rows S = 128 full; then one 400×300 level-2 flagship view through
each tree's `run_view` (chip_smoke.py phase 10's flags), seeded and
all-mirror weights, as the CP view.
With `--groups train`: the CP train kernels' tangent forward and tangent
backward with d_x on `exp_train_diag.cases` (uniform T = 131072, a train
batch's ray-ordered 1024 × 128 and 1024 × 64 samples; 10 calls a round,
best of 3), each through its tree's wrapper.
Each group is also checked: the two trees' outputs agree (GATHER and the
floor bit for bit, the views and the train backward within 1e-3, the rest
within their kernels' bars).

It imports only torch and the two trees' ports. `main` returns the numbers
as a dict.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import (_build, fused_cp, fused_cp_train, fused_mlp, fused_mlp_t,
                   hashgrid, invoke_floor, segment_scan, table_mma)
from .exp_hash_inkernel import (DENSE_SAMPLES, DENSE_SCALE, DENSE_SIDE,
                                IDX_SHAPE, TABLE_ROWS, _grid_sample_args)
from .exp_reshape_probe import PREFIX_BAR, path_input, with_sentinel
from .timing import per_call_ms

LIBS = ("segment_scan", "hashgrid", "invoke_floor", "fused_cp",
        "fused_cp_train", "fused_mlp_t", "table_mma")
GROUPS = ("launch", "composite", "view", "flagship", "train")
KERNEL_BAR = 1e-4  # the composite's bar against its plain version
VIEW_BAR = 1e-3  # a whole render: sampling compounds the kernels' order
OTHER = "other_port"  # the name the other tree's package is imported under


def load_other(root) -> dict:
    """The other tree's ops modules (`_build`, `hashgrid`, `invoke_floor`,
    `segment_scan`), its package imported as `other_port`."""
    pkg = Path(root).resolve() / "mirror_nerf_tpu_torch"
    if not (pkg / "__init__.py").exists():
        raise SystemExit(f"{root}: no mirror_nerf_tpu_torch package there")
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"{OTHER}.ops.{name}")
            for name in ("_build", "fused_mlp", *LIBS)}


def _libraries(mods: dict) -> list:
    """The kernel libraries (`_LIB` names) of a tree's modules."""
    return [mods[name]._LIB for name in LIBS]


def _groups(other: dict, seed: int) -> dict:
    """group -> (name -> callable, the pair whose outputs must agree, the
    bar: 0 for bit for bit)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    hg, ohg = hashgrid, other["hashgrid"]
    ss, oss = segment_scan, other["segment_scan"]
    fl, ofl = invoke_floor, other["invoke_floor"]
    groups = {}
    t32 = torch.from_numpy(rng.standard_normal(
        (TABLE_ROWS, 2)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, TABLE_ROWS, IDX_SHAPE,
                                        dtype=np.int32)).to(dev)
    for dtype, t in (("fp32", t32), ("bf16", t32.to(torch.bfloat16))):
        groups[f"gather_{dtype}"] = (
            {"this": lambda t=t: hg.gather_rows(t, idx),
             "other": lambda t=t: ohg.gather_rows(t, idx),
             "library": lambda t=t: t[idx]}, 0.0)
    rows = torch.from_numpy(rng.standard_normal(
        (DENSE_SIDE ** 3, 2)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.random((DENSE_SAMPLES, 3),
                                    dtype=np.float32)).to(dev)
    vol, grid = _grid_sample_args(rows, x, DENSE_SCALE, DENSE_SIDE)
    groups["dense"] = (
        {"this": lambda: hg.dense_level_lookup(rows, x, DENSE_SCALE,
                                               DENSE_SIDE),
         "other": lambda: ohg.dense_level_lookup(rows, x, DENSE_SCALE,
                                                 DENSE_SIDE),
         "library": lambda: torch.nn.functional.grid_sample(
             vol, grid, mode="bilinear", align_corners=True)}, 1e-5)
    p = path_input(dev, seed)
    groups["prefix"] = (
        {"scan_this": lambda: ss.segment_prefix(p, 128, "scan"),
         "scan_other": lambda: oss.segment_prefix(p, 128, "scan"),
         "tri_this": lambda: ss.segment_prefix(p, 128, "tri"),
         "tri_other": lambda: oss.segment_prefix(p, 128, "tri"),
         "library": lambda: torch.cumsum(p.view(-1, 128), -1)}, PREFIX_BAR)
    sd = with_sentinel(p * 1.5, 128)
    groups["weights"] = (
        {"this": lambda: ss.prefix_weights(sd, 128),
         "other": lambda: oss.prefix_weights(sd, 128)}, 1e-5)
    a = torch.from_numpy(rng.standard_normal(fl.SMALL_SHAPE).astype(
        np.float32)).to(dev)
    b, c = torch.empty_like(a), torch.empty_like(a)
    eps = torch.tensor(float(fl.SHIFT), device=dev)
    groups["floor"] = (
        {"this": lambda: fl.axpb(a, b), "other": lambda: ofl.axpb(a, c),
         "library": lambda: torch.add(eps, a, alpha=float(fl.SCALE),
                                      out=c)}, 0.0)
    groups.update(_moved_groups(other, rng))
    return groups


def _moved_groups(other: dict, rng, dev: str = "cuda") -> dict:
    """The four libraries that last moved onto the launch path (the CP
    composite, the train kernels, the flagship, the table products), at
    small shapes."""
    from ..models.fields import MirrorNeRFField
    from ..models.tpugrid import TPUGridField

    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    cp_field, mlp_field = TPUGridField(bound=6.0), MirrorNeRFField()
    cpp = cp_field.init(g, dev)
    mlpp = mlp_field.init(g, dev)
    o = torch.zeros((1, 3), device=dev)
    d = torch.tensor([[0.0, 0.6, 0.8]], device=dev)
    z = torch.linspace(0.5, 4.0, 16, device=dev)[None]
    x = (torch.rand((1024, 3), generator=g) * 4 - 2).to(dev)
    tr, otr = fused_cp_train, other["fused_cp_train"]
    x8 = torch.from_numpy(rng.random((2, 1, 128), dtype=np.float32)).to(dev)
    t8 = torch.from_numpy(rng.integers(-127, 127, (3, 16, 64)).astype(
        np.int8)).to(dev)

    def cat(res: dict):
        return torch.cat([v.reshape(-1).float() for v in res.values()])

    return {
        "moved_cp": ({"this": lambda: cat(fused_cp.fused_cp_rays_composite(
                      cp_field, cpp, o, d, d, z)),
                   "other": lambda: cat(other["fused_cp"].
                                        fused_cp_rays_composite(
                                            cp_field, cpp, o, d, d, z))},
                  KERNEL_BAR),
        "moved_train": ({"this": lambda: tr.density_with_grad_fused(
                          cp_field, cpp, x)[2],
                      "other": lambda: otr.density_with_grad_fused(
                          cp_field, cpp, x)[2]}, KERNEL_BAR),
        "moved_mlp": ({"this": lambda: cat(fused_mlp_t.fused_t_rays_composite(
                        mlp_field, mlpp, o, d, d, z)),
                    "other": lambda: cat(other["fused_mlp_t"].
                                         fused_t_rays_composite(
                                             mlp_field, mlpp, o, d, d, z))},
                   0.0),
        "moved_mma": ({"this": lambda: table_mma.table_mma(x8, t8),
                    "other": lambda: other["table_mma"].table_mma(x8, t8)},
                   0.0)}


def camera_rays(size: int = 800, height: int = None) -> np.ndarray:
    """The bench camera's size×height rays (chip_smoke's: the first pose of
    the procedural ring, 0.9 rad across the width; height defaults to
    size), (size·height, 8)."""
    from ..core.rays import get_ray_directions, get_rays, make_ray_buffer
    from ..data.synthetic import camera_ring

    focal = 0.5 * size / np.tan(0.45)
    ro, rd = get_rays(get_ray_directions(height or size, size, focal),
                      camera_ring(1)[0])
    return make_ray_buffer(ro, rd, 0.05, 8.0)


def _main_path_rays(n: int = 16384, dev: str = "cuda"):
    """n strided rays of the 800×800 bench camera: o, d (n, 3) and the
    coarse depths z (n, 64)."""
    from ..core.sampling import stratified_z_vals

    rays_np = camera_rays()
    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).to(dev)
    z64 = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 64).contiguous()
    return rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous(), z64


def _composite_groups(other: dict, n: int = 16384,
                      dev: str = "cuda") -> dict:
    """The CP composite's three modes at the main path's shapes, both
    trees on the same inputs."""
    from ..core.sampling import merge_fine_z_vals
    from ..models.tpugrid import TPUGridField

    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    p = field.init(torch.Generator().manual_seed(0), dev)
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 5.0
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    o, d, z64 = _main_path_rays(n, dev)
    coarse = fused_cp.cp_rays_composite_reference(field, p, o, d, d, z64,
                                                  sigma_only=True)
    z128 = merge_fine_z_vals(z64, coarse["weights"], 64, 0.0).contiguous()
    xyz = (o[:, None, :] + d[:, None, :] * z128[..., None]).contiguous()
    v = d[:, None, :].expand_as(xyz).contiguous()
    deltas = torch.cat([z128[:, 1:] - z128[:, :-1],
                        torch.full_like(z128[:, :1], 1e10)], -1)
    ocp = other["fused_cp"]

    def cat(res: dict):
        return torch.cat([t.reshape(-1) for t in res.values()])

    calls = {
        "composite_s128": lambda m: m.fused_cp_rays_composite(
            field, p, o, d, d, z128),
        "composite_s64_sigma": lambda m: m.fused_cp_rays_composite(
            field, p, o, d, d, z64, sigma_only=True),
        "rows_s128": lambda m: m.fused_cp_rays_eval(field, p, o, d, d, z128),
        "samples_s128": lambda m: m.fused_cp_forward_composite(
            field, p, xyz, v, z128, deltas)}
    return {name: ({"this": lambda c=c: cat(c(fused_cp)),
                    "other": lambda c=c: cat(c(ocp))}, KERNEL_BAR)
            for name, c in calls.items()}


def _flagship_groups(other: dict, n: int = 16384,
                     dev: str = "cuda") -> dict:
    """The flagship PE-MLP kernel at the main path's shapes (16384 strided
    rays of the 400×300 camera, the default field, seeded weights with the
    σ column |w|·5), both trees on the same inputs: composite S = 128 full
    and S = 64 σ-only, rows S = 128 full."""
    from ..core.sampling import merge_fine_z_vals, stratified_z_vals
    from ..models.fields import MirrorNeRFField

    field = MirrorNeRFField()
    p = _sigma_scaled(field.init(torch.Generator().manual_seed(0), dev))
    rays_np = camera_rays(400, 300)
    rays = torch.from_numpy(rays_np[::len(rays_np) // n][:n]).to(dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    z64 = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 64).contiguous()
    coarse = fused_mlp_t.mlp_rays_composite_reference(field, p, o, d, d,
                                                      z64, sigma_only=True)
    z128 = merge_fine_z_vals(z64, coarse["weights"], 64, 0.0).contiguous()
    om, omr = other["fused_mlp_t"], other["fused_mlp"]

    def cat(res: dict):
        return torch.cat([t.reshape(-1) for t in res.values()])

    calls = {
        "flagship_s128": lambda m, _: cat(m.fused_t_rays_composite(
            field, p, o, d, d, z128)),
        "flagship_s64_sigma": lambda m, _: cat(m.fused_t_rays_composite(
            field, p, o, d, d, z64, sigma_only=True)),
        "flagship_rows_s128": lambda _, r: r.fused_rays_eval(
            field, p, o, d, d, z128)}
    return {name: ({"this": lambda c=c: c(fused_mlp_t, fused_mlp),
                    "other": lambda c=c: c(om, omr)}, KERNEL_BAR)
            for name, c in calls.items()}


def _train_groups(other: dict) -> dict:
    """The CP train kernels at the main path's shapes (`exp_train_diag.
    cases`: uniform T = 131072 and a train batch's ray-ordered 1024 × 128
    and 1024 × 64 samples, the default field with the σ column |w|·5),
    both trees on the same inputs: the tangent forward (σ, geo, ∇σ) and the
    tangent backward with d_x (every grad), each launched through the
    tree's wrapper. The two trees' outputs agree within the forward's bar
    (their backwards sum in other orders: within 1e-3 of the largest grad
    entry above 1), ∇σ, σ, geo and d_x on `exp_train_diag.stable_samples`
    (∇σ jumps where a hidden unit changes sign: the first design's kernel
    differed from the plain version by up to 0.39 at a few samples within
    1e-6 of it)."""
    from .exp_train_diag import (_calls, cases, field_and_params,
                                 stable_samples)

    field, p = field_and_params()
    otr = other["fused_cp_train"]
    out = {}
    for case, (x, cots) in cases(field, p).items():
        stable = stable_samples(field, p, x)

        def flat(res, stable=stable):
            """Per-sample outputs (σ, geo, ∇σ, d_x) on the stable samples,
            the parameter grads whole."""
            parts = []
            for r in res:
                for v in (r if isinstance(r, list) else [r]):
                    if v is not None:
                        per_sample = v.shape[0] == stable.shape[0]
                        parts.append((v[stable] if per_sample else v)
                                     .reshape(-1))
            return torch.cat(parts)

        this = _calls(fused_cp_train, field, p, x, cots)
        oth = _calls(otr, field, p, x, cots)
        for k, what in enumerate(("fwd", "bwd")):
            out[f"train_{case}_{what}"] = (
                {"this": this[k], "other": oth[k]},
                KERNEL_BAR if what == "fwd" else 1e-3, flat)
    return out


def composite_code(other: dict) -> dict:
    """Each tree's composite library: ptxas' registers and spills, and the
    SASS counts of every `cp_field_kernel` instance."""
    res = {}
    for tree, b in (("this", _build), ("other", other["_build"])):
        log = [ln.strip() for ln in b.build_log.get(
            "fused_cp_composite", "").splitlines()
            if "registers" in ln or "spill" in ln]
        res[tree] = {"ptxas": log, "sass": _build.sass_counts(
            b.library_path("fused_cp_composite"), "cp_field_kernel")}
    return res


def _agree(fns: dict, bar: float, flat=None) -> float:
    """The largest difference, scaled above 1, between the two trees'
    outputs of each pair in a group (this vs other), `flat` (default:
    the output as it is) turning an output into the values compared;
    asserted ≤ bar."""
    worst = 0.0
    flat = flat or (lambda v: v)
    for name in fns:
        if not name.endswith("this"):
            continue
        got = flat(fns[name]()).float()
        want = flat(fns[name[:-4] + "other"]()).float()
        err = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        assert err <= bar, (name, err, bar)
        worst = max(worst, err)
    return worst


def bench(other: dict, seed: int = 1, groups=("launch",)) -> dict:
    """Per group: µs per call of each function (in turns) and the largest
    difference between the two trees' outputs."""
    res = {}
    with torch.no_grad():
        todo = {}
        if "launch" in groups:
            todo.update((k, (v, 200, 5)) for k, v in
                        _groups(other, seed).items())
        if "composite" in groups:
            todo.update((k, (v, 20, 3)) for k, v in
                        _composite_groups(other).items())
        if "flagship" in groups:
            todo.update((k, (v, 5, 3)) for k, v in
                        _flagship_groups(other).items())
        if "train" in groups:
            todo.update((k, (v, 10, 3)) for k, v in
                        _train_groups(other).items())
        for group, ((fns, bar, *flat), reps, rounds) in todo.items():
            diff = _agree(fns, bar, *flat)
            us = {k: v * 1e3 for k, v in
                  per_call_ms(fns, reps, rounds).items()}
            res[group] = {"us": us, "max_diff": diff}
        if "view" in groups:
            res["view"] = view_ab(other)
        if "flagship" in groups:
            res["flagship_view"] = view_ab(other, size=400, height=300,
                                           flags=FLAGSHIP_VIEW_FLAGS)
    return res


# run.sh mode 1, MODEL_TYPE=nerf_tpu, with --fused_field (chip_smoke.py)
VIEW_FLAGS = ["--dataset_name", "blender", "--near", "0.05", "--far", "8",
              "--model_type", "nerf_tpu", "--predict_normal",
              "--predict_mirror_mask", "--trace_secondary_rays",
              "--bound", "6", "--N_importance", "64", "--chunk", "16384",
              "--fused_field", "--max_recursive_level", "2",
              "--img_wh", "800", "800"]
# run.sh mode 1, MODEL_TYPE=nerf, with --fused_field (chip_smoke.py phase
# 10: the flagship's 400×300 view)
FLAGSHIP_VIEW_FLAGS = ["--dataset_name", "blender", "--near", "0.05",
                       "--far", "8", "--scale_factor", "6", "--model_type",
                       "nerf", "--predict_normal", "--predict_mirror_mask",
                       "--trace_secondary_rays", "--bound", "6",
                       "--N_importance", "64", "--chunk", "16384",
                       "--fused_field", "--max_recursive_level", "2",
                       "--img_wh", "400", "300"]


def _sigma_scaled(side: dict) -> dict:
    """A side's weights with the σ column |w|·5 (CP-grid or flagship)."""
    m = dict(side)
    if "sigma" in side:
        m["sigma"] = {"w": side["sigma"]["w"].abs() * 5.0,
                      "b": side["sigma"]["b"]}
    else:
        s2 = side["sigma_net"][1]["w"].clone()
        s2[:, 0] = s2[:, 0].abs() * 5.0
        m["sigma_net"] = [side["sigma_net"][0], {"w": s2}]
    return m


def _all_mirror(side: dict) -> dict:
    """`_sigma_scaled` with the mirror head biased on (+5): every ray an
    opaque mirror at every level."""
    m = _sigma_scaled(side)
    m2 = dict(side["is_mirror"][1])
    m2["b"] = m2["b"] + 5.0
    m["is_mirror"] = [side["is_mirror"][0], m2]
    return m


def view_ab(other: dict, rounds: int = 3, size: int = 800,
            device: str = "cuda", extra=(), height: int = None,
            flags=VIEW_FLAGS) -> dict:
    """One size×height level-2 view (`flags`: the CP model by default, or
    FLAGSHIP_VIEW_FLAGS) through each tree's `run_view`, seeded and
    all-mirror weights (the same tensors for both), in turns: rays/s of the
    best round each (a CPU run times nothing), and the largest difference
    of rgb_fine."""
    import time

    from ..eval import get_opt
    from ..eval.cli import init_params
    from ..models.fields import make_field

    cfg, args = get_opt(flags[:-3] + ["--img_wh", str(size),
                                      str(height or size), *extra])
    field = make_field(cfg)
    seeded = init_params(field, cfg, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mirror = {k: _all_mirror(side) for k, side in seeded.items()}
    rays_np = camera_rays(size, height)
    sample = {"rays": rays_np}
    out = {}
    for label, params in (("seeded", seeded), ("all_mirror", mirror)):
        runs = {}
        for tree, prefix in (("this", "mirror_nerf_tpu_torch"),
                             ("other", OTHER)):
            apps = importlib.import_module(f"{prefix}.eval.apps")
            ctx = apps.AppContext.build(cfg, args, field, params, device)
            runs[tree] = (apps.run_view, ctx)
        first = {t: fn(ctx, sample) for t, (fn, ctx) in runs.items()}
        diff = float(np.abs(first["this"]["rgb_fine"]
                            - first["other"]["rgb_fine"]).max())
        assert diff <= VIEW_BAR, (label, diff)
        best = {t: float("inf") for t in runs}
        for r in range(rounds):
            for t in (("other", "this") if r % 2 == 0 else
                      ("this", "other")):
                fn, ctx = runs[t]
                sync()
                t0 = time.perf_counter()
                fn(ctx, sample)
                sync()
                best[t] = min(best[t], time.perf_counter() - t0)
        out[label] = {"rays_per_s": {t: len(rays_np) / v
                                     for t, v in best.items()},
                      "rgb_max_diff": diff}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of another checkout of the repository")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--groups", nargs="+", choices=GROUPS,
                    default=["launch"],
                    help="launch: the wrappers' per-call times; composite: "
                         "the CP composite at the main path's shapes; view: "
                         "the 800×800 CP view; flagship: the flagship "
                         "kernel at its main path's shapes and the 400×300 "
                         "flagship view; train: the CP train kernels at "
                         "their main path's shapes")
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the launch path is timed on a card")
    other = load_other(args.other)
    this = {name: globals()[name] for name in LIBS}
    with ThreadPoolExecutor(2) as pool:  # both trees' kernels at once
        list(pool.map(lambda t: t[0].build_libraries(_libraries(t[1])),
                      ((_build, this), (other["_build"], other))))
    print(f"device: {torch.cuda.get_device_name(0)}; other tree "
          f"{Path(args.other).resolve()}")
    res = {"device": torch.cuda.get_device_name(0), "other": args.other,
           "bench": bench(other, args.seed, args.groups)}
    if "composite" in args.groups:
        res["composite_code"] = composite_code(other)
        for tree, c in res["composite_code"].items():
            for line in c["ptxas"]:
                print(f"[{tree}] ptxas: {line}")
            for name, counts in c["sass"].items():
                print(f"[{tree}] {name[:72]}: " + ", ".join(
                    f"{k} {v}" for k, v in counts.items()))
    for group, r in res["bench"].items():
        if group in ("view", "flagship_view"):
            for label, v in r.items():
                print(f"{group} {label:10s} rays/s: " + ", ".join(
                    f"{k} {x:.1f}" for k, x in v["rays_per_s"].items())
                    + f"; rgb differs by {v['rgb_max_diff']:.2e}")
            continue
        print(f"{group:12s} µs per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["us"].items())
            + f"; outputs differ by {r['max_diff']:.2e}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
