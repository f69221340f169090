"""What bounds the flagship PE-MLP kernel: copies of `csrc/fused_mlp_t.cu`
with one piece changed, built beside the real one and timed in turns on
the same inputs, in one process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_mlp_diag [--variants ...]

Variants (each a text patch of the source; the first two compute wrong
values and are timed only, the others must stay within the bar):

  one_tf32         one TF32 product (a_hi·b_hi) in place of three: the share
                   of the time the tensor pipe's extra products take, and
                   the error a single-pass kernel would make;
  no_b_loads       the weight ring filled once, then reused: no weight
                   bytes leave L2 after the first five k-steps, so the
                   difference is what the weight stream holds back;
  promote_1        the tensor cores sum one k-step at a time (PROMOTE 1,
                   not 2): twice the fp32 adds and waits, less bias;
  promote_4        four k-steps at a time: half the adds, more bias;
  layer_sums       the tensor cores sum each part over the whole layer,
                   straight into the layer's output registers (no fp32
                   adds): the adds the chunk sums cost (the bias they
                   remove shows in raw σ, which this kernel does not
                   write: `exp_rows_tc_diag`'s `layer_sums`);
  cluster_1        clusters of one CTA: every CTA copies whole stages for
                   itself (no multicast), twice the L2 reads;
  one_consumer_wg  one consumer warpgroup (64 samples a pass) in place of
                   two: half the samples per weight stage.

Accuracy: every build against the plain version on `chip_smoke.py` phase
9's inputs (the flagship field with both heads, seeded from 0 with the σ
column |w|·5, and saturating at ·2000, on 16384 strided rays of the 400×300
view; S = 128 full and S = 64 σ-only, relu and softplus), as the largest
absolute difference over every output, scaled above 1. The real build and
the variants that keep the arithmetic must stay within KERNEL_ATOL = 1e-4;
`one_tf32` must not, or the bar would pass a single-pass TF32 kernel.

Timing: the seeded relu cases, S = 128 full and S = 64 σ-only. Each
variant launches through the wrapper's own entry (its ctypes function
swapped in), 5 calls a round, best of 3 rounds in turns. Prints ms per
call, ptxas' registers and spills, and each build's difference from the
plain version. Imports only torch and the port; the builds go to
`build/kernels/diag_mlp/` (git-ignored). A patch that no longer matches the
kernel's source exactly once stops the tool with an error naming it.
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

from ..ops import _build, fused_mlp_t
from .exp_cp_diag import KERNEL_ATOL, _ms, worst

_ENTRY = "mnerf_fused_mlp_t"
_COPY = ("            mbar_expect_tx(base + L.full + 8 * stage, bytes);\n"
         "            bulk_copy(base + L.ring + stage * STAGE_BYTES + "
         "rank * part,\n"
         "                      src + rank * part, part, base + L.full + 8 "
         "* stage);")
# the tensor cores sum each part over the whole layer in the layer's output
# registers (the design before the fp32 chunk sums): no restart, no adds
_CHUNK_SUMS = """  float d[PART / 2];
#pragma unroll
  for (int q = 0; q < N / PART; ++q) {
    // part q: B rows 64q … 64q + 63 of each plane (2 KB apart)
    const uint64_t at = (q * PART * 32) >> 4, lo = (N * 32) >> 4;
    wgmma_fence();"""
_LAYER_SUMS = """#pragma unroll
  for (int q = 0; q < N / PART; ++q) {
    float (&d)[PART / 2] =
        *reinterpret_cast<float (*)[PART / 2]>(s + q * PART / 2);
    const uint64_t at = (q * PART * 32) >> 4, lo = (N * 32) >> 4;
    wgmma_fence();"""
PATCHES = {
    "one_tf32": [
        ("      wgmma_n64(d, f[j].lo, desc[j] + at, j > 0);\n"
         "      wgmma_n64(d, f[j].hi, desc[j] + lo + at, 1);\n", ""),
        ("    for (int j = 0; j < NK; ++j) "
         "wgmma_n64(d, f[j].hi, desc[j] + at, 1);",
         "    for (int j = 0; j < NK; ++j)\n"
         "      wgmma_n64(d, f[j].hi, desc[j] + at, j > 0);")],
    "no_b_loads": [
        (_COPY,
         "            if (p == 0 && l == 0 && k < STAGES) {\n" + _COPY
         + "\n            } else {\n"
         "              asm volatile(\"mbarrier.arrive.shared::cta.b64 _, "
         "[%0];\" ::\"r\"(base + L.full + 8 * stage) : \"memory\");\n"
         "            }")],
    "promote_1": [("constexpr int PROMOTE = 2;",
                   "constexpr int PROMOTE = 1;")],
    "promote_4": [("constexpr int PROMOTE = 2;",
                   "constexpr int PROMOTE = 4;")],
    "layer_sums": [
        (_CHUNK_SUMS, _LAYER_SUMS),
        ("      wgmma_n64(d, f[j].lo, desc[j] + at, j > 0);",
         "      wgmma_n64(d, f[j].lo, desc[j] + at, 1);"),
        ("    for (int i = 0; i < PART / 2; ++i) s[q * PART / 2 + i] += d[i];",
         "    for (int i = 0; i < 0; ++i) s[q * PART / 2 + i] += d[i];")],
    "cluster_1": [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")],
    "one_consumer_wg": [("constexpr int CONSUMERS = 2;",
                         "constexpr int CONSUMERS = 1;")],
}
WRONG = ("one_tf32", "no_b_loads")  # timed only


def patched_source(name: str, src: str = None) -> str:
    """`src` (default: the kernel's source) with variant `name`'s patches
    applied; raises ValueError unless each matches exactly once."""
    if src is None:
        src = (_build.CSRC / "fused_mlp_t.cu").read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: the patch does not match the source "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name: str):
    """nvcc a variant into build/kernels/diag_mlp/: (ctypes entry, ptxas
    lines)."""
    out = _build.BUILD_DIR / "diag_mlp"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):  # launch.cuh, sm90.cuh, ...
        # replaced whole: a build running in another thread may read it
        tmp = out / f"{header.name}.{threading.get_ident()}.tmp"
        tmp.write_text(header.read_text())
        os.replace(tmp, out / header.name)
    cu = out / f"{name}.cu"
    cu.write_text(patched_source(name))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), _ENTRY)
    fn.argtypes = fused_mlp_t._library.entries[_ENTRY]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(proc.stdout + proc.stderr)


def ptxas_lines(log: str) -> list:
    """ptxas' registers, spills and wgmma warnings of a build."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "wgmma" in ln]


def builds(names):
    """The real entry and each variant in `names`, built in parallel:
    name -> (ctypes entry, ptxas lines)."""
    fused_mlp_t._library()
    out = {"real": (fused_mlp_t._library._fns[_ENTRY],
                    ptxas_lines(_build.build_log.get(fused_mlp_t._LIB,
                                                     "")))}
    names = [n for n in names if n != "real"]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(build, names)))
    return out


def _swapped(fn, call):
    """`call()` with the wrapper's entry swapped for `fn`."""
    real = fused_mlp_t._library._fns[_ENTRY]
    fused_mlp_t._library._fns[_ENTRY] = fn
    try:
        return call()
    finally:
        fused_mlp_t._library._fns[_ENTRY] = real


def phase9_inputs():
    """chip_smoke.py phase 9's field, its seeded and saturating weights,
    and 16384 strided rays of the 400×300 view: (field, params by name, o,
    d, z64)."""
    from ..core.sampling import stratified_z_vals
    from ..models.fields import MirrorNeRFField
    from .exp_launch_ab import camera_rays

    field = MirrorNeRFField()
    base = field.init(torch.Generator().manual_seed(0), "cuda")
    params = {}
    for pname, scale in (("seeded", 5.0), ("saturating", 2000.0)):
        w = base["sigma"]["w"].clone()
        w[:, 0] = w[:, 0].abs() * scale
        params[pname] = {**base, "sigma": {"w": w, "b": base["sigma"]["b"]}}
    rays_np = camera_rays(400, 300)
    n = 16384
    r = torch.from_numpy(np.ascontiguousarray(
        rays_np[::len(rays_np) // n][:n])).cuda()
    o, d = r[:, 0:3].contiguous(), r[:, 3:6].contiguous()
    z64 = stratified_z_vals(r[:, 6:7], r[:, 7:8], 64).contiguous()
    return field, params, o, d, z64


def phase9_cases():
    """chip_smoke.py phase 9's inputs and the plain version's outputs:
    case -> (kernel call, plain outputs)."""
    from ..core.sampling import merge_fine_z_vals

    field, params, o, d, z64 = phase9_inputs()
    cases = {}
    with torch.no_grad():
        for pname, act in (("seeded", "relu"), ("seeded", "softplus"),
                           ("saturating", "relu")):
            p = params[pname]
            w = fused_mlp_t.mlp_rays_composite_reference(
                field, p, o, d, d, z64, True, act)["weights"]
            z128 = merge_fine_z_vals(z64, w, 64, 0.0).contiguous()
            for so, z in ((False, z128), (True, z64)):
                case = (f"{pname} {act} S={z.shape[1]} "
                        f"{'sigma-only' if so else 'full'}")
                cases[case] = (
                    lambda p=p, z=z, so=so, act=act: fused_mlp_t.
                    fused_t_rays_composite(field, p, o, d, d, z, so, act),
                    fused_mlp_t.mlp_rays_composite_reference(
                        field, p, o, d, d, z, so, act))
    return cases


def plain_differences(fns: dict, cases: dict = None) -> dict:
    """name -> case -> output -> max |build − plain| over max(1, max
    |plain|) (default cases: phase 9's)."""
    cases = cases or phase9_cases()
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            out[name] = {}
            for case, (call, want) in cases.items():
                got = _swapped(fn, call)
                torch.cuda.synchronize()
                out[name][case] = {
                    k: float((got[k] - v).abs().max())
                    / max(1.0, float(v.abs().max()))
                    for k, v in want.items()}
    return out


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
    torch.backends.cuda.matmul.allow_tf32 = False
    built = builds(args.variants)
    fns = {k: v[0] for k, v in built.items()}
    cases = phase9_cases()
    diff = plain_differences(fns, cases)
    timed = {case: call for case, (call, _) in cases.items()
             if case.startswith("seeded relu")}
    res = {name: {} for name in fns}
    with torch.no_grad():
        for rnd in range(args.rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, fn in timed.items():
                    ms = _swapped(fns[name], lambda fn=fn: _ms(fn, reps=5))
                    res[name][case] = min(res[name].get(case, 1e9), ms)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; ms per call, best of {args.rounds} rounds in "
          "turns; max |build - plain| (scaled above 1) over phase 9's "
          f"inputs (bar {KERNEL_ATOL:.0e})")
    top = worst(diff)
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"max |build - plain| {top[name]:.3e}")
        print(f"{name:16s} " + ", ".join(
            f"{case} {ms:.4f}" for case, ms in res[name].items())
            + f" ({note})")
        for line in built[name][1]:
            print(f"{'':16s} ptxas: {line}")
    for name in fns:
        print(f"|build - plain| of {name} by case and output:")
        for case, errs in diff[name].items():
            print(f"  {case}: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items()))
    check_differences(diff)
    return {"device": card, "ms": res, "max_diff": top}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
