"""What bounds the CP composite kernel: copies of `csrc/fused_cp_composite.cu`
with one piece changed, built beside the real one and timed in turns on
the same inputs, in one process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_cp_diag [--variants ...]

Variants (each a text patch of the source; the first three compute wrong
values and are timed only, the others must stay within the bar):

  one_tf32        one TF32 product (a_hi·b_hi) in place of three: the share
                  of the time the tensor pipe's extra products take, and
                  the error a single-pass kernel would make;
  no_table_loads  the CP encode's table rows replaced by constants: the
                  share the table loads take;
  both            the two above together;
  split_at_load   the weights staged unsplit and each B fragment split at
                  its load (six more instructions a fragment), the design
                  the kernel replaced;
  4_warp_blocks   4-warp blocks in place of 8 (the same registers a thread;
                  shared memory then holds one full or three σ-only blocks
                  an SM);
  full_128_regs   the full variant held to 128 registers a thread.

Accuracy: every build against the plain version on `chip_smoke.py` phase
3's inputs (the field with both heads, seeded from 0 and saturating, on
16384 strided rays of the 800×800 bench camera; COMPOSITE S = 128 full
and S = 64 σ-only, relu and softplus), as the largest absolute difference
over every output. The real build and the variants that keep the
arithmetic must stay within KERNEL_ATOL = 1e-4; `one_tf32` must not, or
the bar would pass a single-pass TF32 kernel.

Timing inputs: the default CP field (levels 64:64, 256:64, 512:64, bound
6, seeded weights with the σ column |w|·5) on 16384 contiguous rays from
the middle of the 800×800 bench camera (as a view's chunk gets them) and
on 16384 strided rays (as phase 3 takes them): COMPOSITE S = 128 full and
S = 64 σ-only. Each variant launches through the wrapper's own entry (its
ctypes function swapped in), 10 calls a round, best of 3 rounds in turns.
Prints ms per call, ptxas' registers and spills, and each build's
difference from the plain version. Imports only torch and the port; the
builds go to `build/kernels/diag/` (git-ignored). A patch that no longer
matches the kernel's source exactly once stops the tool with an error
naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build, fused_cp

_MMA3 = ("  mma_tf32(c, a.lo, b.hi);\n  mma_tf32(c, a.hi, b.lo);\n"
         "  mma_tf32(c, a.hi, b.hi);")
_LOADS = [("const float4 t0 = __ldg(reinterpret_cast<const float4*>(r0));",
           "const float4 t0 = make_float4(1.f, 1.f, 1.f, "
           "__int_as_float(row[q][k] + p));"),
          ("const float4 t1 = __ldg(reinterpret_cast<const float4*>"
           "(r0 + R));",
           "const float4 t1 = make_float4(1.f, 1.f, 0.5f, "
           "__int_as_float(row[q][k]));")]
_ONE = [(_MMA3, "  mma_tf32(c, a.hi, b.hi);")]
PATCHES = {
    "one_tf32": _ONE,
    "no_table_loads": _LOADS,
    "both": _ONE + _LOADS,
    "split_at_load": [
        ("    uint32_t h0, l0, h1, l1;\n"
         "    tf32_split(col[0], h0, l0);\n"
         "    tf32_split(col[4 * n], h1, l1);\n"
         "    d4[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),"
         "\n                          __uint_as_float(l0), "
         "__uint_as_float(l1));",
         "    d4[idx] = make_float4(col[0], col[4 * n], 0.f, 0.f);"),
        ("  f.hi[0] = __float_as_uint(b.x);\n"
         "  f.hi[1] = __float_as_uint(b.y);\n"
         "  f.lo[0] = __float_as_uint(b.z);\n"
         "  f.lo[1] = __float_as_uint(b.w);",
         "  tf32_split(b.x, f.hi[0], f.lo[0]);\n"
         "  tf32_split(b.y, f.hi[1], f.lo[1]);")],
    "4_warp_blocks": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "full_128_regs": [("__launch_bounds__(BLOCK, SIGMA_ONLY ? 2 : 1)",
                       "__launch_bounds__(BLOCK, 2)")],
}
WRONG = ("one_tf32", "no_table_loads", "both")  # timed only
KERNEL_ATOL = 1e-4  # chip_smoke.py's bar, kernel against plain


def patched_source(name: str, src: str = None, patches: dict = None) -> str:
    """`src` (default: the composite's source) with variant `name`'s
    patches (default: `PATCHES`) applied; raises ValueError unless each
    matches exactly once."""
    if src is None:
        src = composite_source()
    for old, new in (patches or PATCHES)[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: the patch does not match the source "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def composite_source() -> str:
    """The composite's source with `csrc/tf32.cuh` written in place of its
    include, so that a patch can change the 3×TF32 products too."""
    header = (_build.CSRC / "tf32.cuh").read_text().replace(
        "#pragma once\n", "")
    return (_build.CSRC / "fused_cp_composite.cu").read_text().replace(
        '#include "tf32.cuh"\n', header)


def build(name: str, patches: dict = None,
          entry: str = "mnerf_fused_cp_composite", library=None):
    """nvcc a variant (of `patches`, default `PATCHES`) into
    build/kernels/diag/: (its ctypes `entry`, typed as `library`'s, default
    the CP composite's; ptxas lines)."""
    out = _build.BUILD_DIR / "diag"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        # replaced whole: a build running in another thread may read it
        tmp = out / f"{header.name}.{threading.get_ident()}.tmp"
        tmp.write_text(header.read_text())
        os.replace(tmp, out / header.name)
    cu = out / f"{name}.cu"
    cu.write_text(patched_source(name, patches=patches))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = (library or fused_cp._library).entries[entry]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    return fn, ptxas


def inputs():
    """The default field's seeded weights and two ray sets on the card:
    name -> (o, d, z64, z128)."""
    from ..core.sampling import merge_fine_z_vals, stratified_z_vals
    from ..models.tpugrid import TPUGridField
    from .exp_launch_ab import camera_rays

    field = TPUGridField(bound=6.0)
    p = field.init(torch.Generator().manual_seed(0), "cuda")
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 5.0
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    rays_np = camera_rays()
    mid = len(rays_np) // 2 - 8192
    sets = {}
    for tag, rays in (("contiguous", rays_np[mid:mid + 16384]),
                      ("strided", rays_np[::len(rays_np) // 16384][:16384])):
        r = torch.from_numpy(np.ascontiguousarray(rays)).cuda()
        o, d = r[:, 0:3].contiguous(), r[:, 3:6].contiguous()
        z64 = stratified_z_vals(r[:, 6:7], r[:, 7:8], 64).contiguous()
        w = fused_cp.cp_rays_composite_reference(field, p, o, d, d, z64,
                                                 sigma_only=True)["weights"]
        z128 = merge_fine_z_vals(z64, w, 64, 0.0).contiguous()
        sets[tag] = (o, d, z64, z128)
    return field, p, sets


def _ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def builds(names):
    """The real entry and each variant in `names`, built in parallel:
    name -> (ctypes entry, ptxas lines)."""
    fused_cp._library()
    out = {"real": (fused_cp._library._fns["mnerf_fused_cp_composite"], [])}
    names = [n for n in names if n != "real"]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(build, names)))
    return out


def _swapped(fn, call):
    """`call()` with the wrapper's composite entry swapped for `fn`."""
    real = fused_cp._library._fns["mnerf_fused_cp_composite"]
    fused_cp._library._fns["mnerf_fused_cp_composite"] = fn
    try:
        return call()
    finally:
        fused_cp._library._fns["mnerf_fused_cp_composite"] = real


def phase3_cases():
    """chip_smoke.py phase 3's inputs and the plain version's outputs:
    case -> (kernel call, plain outputs)."""
    from ..core.sampling import merge_fine_z_vals, stratified_z_vals
    from ..models.tpugrid import TPUGridField
    from .exp_launch_ab import camera_rays

    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    seeded = field.init(torch.Generator().manual_seed(0), "cuda")
    saturating = dict(seeded)
    s2 = seeded["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * 2000.0
    saturating["sigma_net"] = [seeded["sigma_net"][0], {"w": s2}]
    rays_np = camera_rays()
    r = torch.from_numpy(np.ascontiguousarray(
        rays_np[::len(rays_np) // 16384][:16384])).cuda()
    o, d = r[:, 0:3].contiguous(), r[:, 3:6].contiguous()
    z64 = stratified_z_vals(r[:, 6:7], r[:, 7:8], 64).contiguous()
    cases = {}
    with torch.no_grad():
        for pname, p in (("seeded", seeded), ("saturating", saturating)):
            for act in ("relu", "softplus"):
                w = fused_cp.cp_rays_composite_reference(
                    field, p, o, d, d, z64, True, act)["weights"]
                z128 = merge_fine_z_vals(z64, w, 64, 0.0).contiguous()
                for so, z in ((False, z128), (True, z64)):
                    case = (f"{pname} {act} S={z.shape[1]} "
                            f"{'sigma-only' if so else 'full'}")
                    cases[case] = (
                        lambda p=p, z=z, so=so, act=act: fused_cp.
                        fused_cp_rays_composite(field, p, o, d, d, z, so,
                                                act),
                        fused_cp.cp_rays_composite_reference(
                            field, p, o, d, d, z, so, act))
    return cases


def plain_differences(fns: dict, cases: dict = None) -> dict:
    """name -> case -> output -> max |build − plain| (default cases: phase
    3's)."""
    cases = cases or phase3_cases()
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            out[name] = {}
            for case, (call, want) in cases.items():
                got = _swapped(fn, call)
                out[name][case] = {k: float((got[k] - v).abs().max())
                                   for k, v in want.items()}
    return out


def worst(diff: dict) -> dict:
    """name -> the largest difference over every case and output."""
    return {name: max(max(c.values()) for c in cases.values())
            for name, cases in diff.items()}


def check_differences(diff: dict) -> None:
    """The real build and the variants that keep the arithmetic within
    KERNEL_ATOL; one TF32 product beyond it."""
    for name, d in worst(diff).items():
        if name == "one_tf32":
            assert d > KERNEL_ATOL, (
                f"one TF32 product differs from the plain version by only "
                f"{d:.2e}: the bar would pass a single-pass kernel")
        elif name not in WRONG:
            assert d <= KERNEL_ATOL, (name, d)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    built = builds(args.variants)
    fns = {k: v[0] for k, v in built.items()}
    diff = plain_differences(fns)
    field, p, sets = inputs()
    cases = {}
    for tag, (o, d, z64, z128) in sets.items():
        for so, z in ((False, z128), (True, z64)):
            cases[f"{tag} S={z.shape[1]} {'sigma-only' if so else 'full'}"] = (
                lambda o=o, d=d, z=z, so=so: fused_cp.fused_cp_rays_composite(
                    field, p, o, d, d, z, so))
    res = {name: {} for name in fns}
    with torch.no_grad():
        for rnd in range(args.rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, fn in cases.items():
                    ms = _swapped(fns[name], lambda fn=fn: _ms(fn))
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; ms per call, best of {args.rounds} rounds in "
          "turns; max |build - plain| over phase 3's inputs (bar "
          f"{KERNEL_ATOL:.0e})")
    top = worst(diff)
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"max |build - plain| {top[name]:.3e}")
        print(f"{name:15s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" ({note})")
        for line in built[name][1]:
            print(f"{'':15s} ptxas: {line}")
    for name in fns:
        print(f"|build - plain| of {name} by case and output:")
        for case, errs in diff[name].items():
            print(f"  {case}: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items()))
    check_differences(diff)
    return {"device": card, "ms": res, "max_diff": top}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
