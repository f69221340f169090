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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dense", action="store_true",
                    help="DENSE's variants instead of the fused kernel's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    if args.dense:
        return dense_main(max(args.rounds, 5))
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
