"""What bounds the PE-MLP rows kernel on the tensor cores, and how far its
raw σ leans: copies of `csrc/fused_mlp_rows_tc.cu` with one piece changed,
built beside the real one and timed in turns on the same inputs, in one
process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_rows_tc_diag \
        [--variants ...] [--trunks ...] [--no_lean]

Variants (each a text patch of the source; those in WRONG compute wrong
values and are timed only, the others must stay within the bar). Of the
instances of widths 128 … 512:

  one_tf32    one TF32 product (a_hi·b_hi) in place of three: the share of
              the time the tensor pipe's extra products take;
  no_b_loads  the weight ring filled once, then reused: no weight bytes
              leave L2 after the first stages, so the difference is what
              the weight stream holds back;
  promote_1   the tensor cores sum one k-step at a time at every width
              (the kernel: 1 at width 512, 2 below);
  promote_2   two k-steps at a time at every width;
  layer_sums  the tensor cores sum each part over the whole layer, straight
              into the layer's output registers (no fp32 adds): the
              truncation the chunk sums keep out of raw σ's lean.

Of the cluster instance (wider than 512) `wide_one_tf32` and
`wide_no_b_loads` likewise, and:

  wide_promote_1, wide_promote_2  one or two k-steps a tensor-core sum at
                    every width (the kernel: two where its ring holds five
                    stages or more; PROMOTE 2 with ≤ 3 parts a warpgroup,
                    so wrong values where a CTA holds more than 6);
  wide_single_parts  every part its own m64n64 sum and wait, not two
                    neighbouring parts one m64n128 sum;
  wide_ctas_512     C = ⌈W / 512⌉ CTAs a group (width 1408: 3, clusters of
                    6), not the fewest of 2, 4, 8 with ≤ 6 parts each (the
                    wrapper packs for the latter: wrong values);
  wide_local_a      every A fragment read from this CTA's own park through
                    the cluster window (wrong values): what reading the
                    peers' parks costs over the CTA's own;
  wide_ld_shared    every A fragment read from the own park by a plain
                    shared load (wrong values): what the cluster window
                    costs;
  wide_no_sync      no cluster-wide barrier between the CTAs (a race, wrong
                    values): what the barriers around each park cost;
  wide_no_prefetch  A read at its use, not one chunk ahead.

Timing: chip_smoke.py phase 23's trunks (width 512, depth 8, skip 4;
width 128, depth 6, skips 2, 4; width 640, depth 2; width 1408, depth 2)
and a width-384 one (depth 6, skip 3), all-mirror seeded weights, on
strided rays of the 400×300 view at S = 128 (16384; 4096 at width 640,
1024 at 1408), full and σ-only; `--trunks` picks some. Each variant
launches through the wrapper's own entry (its ctypes function swapped
in), 3 calls a round, best of 3 rounds in turns. Accuracy: every build
against the plain version on those rays, the largest difference scaled
above 1 (bar KERNEL_ATOL = 1e-4).

σ's lean (unless `--no_lean`): raw σ (σ-only rays, 4096 × 128) against a
float64 plain version, the mean signed and the largest error over max(1,
max |σ|), for each build and the fp32 plain version, on phase 23's
weights and on He-scaled ones (every trunk weight ×√6, the σ column |w|·5:
the trunk keeps its features through its depth and σ is far above 1),
for the timed trunks and the default one. Imports only torch and the
port; the builds go to `build/kernels/diag_rows_tc/` (git-ignored). A
patch that no longer matches the kernel's source exactly once stops the
tool with an error naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build, fused_mlp
from ..train.checkpoints import _map
from .exp_cp_diag import KERNEL_ATOL, _ms
from .exp_mlp_diag import ptxas_lines

_ENTRY = "mnerf_mlp_rows_tc"
_SOURCE = "fused_mlp_rows_tc.cu"
_COPY = ("            mbar_expect_tx(base + C::FULL + 8 * stage, bytes);\n"
         "            bulk_copy(base + C::RING + stage * C::STAGE_BYTES + "
         "rank * part,\n"
         "                      src + rank * part, part, base + C::FULL + 8 "
         "* stage);")
_WIDE_COPY = (
    "            mbar_expect_tx(base + sh.full + 8 * stage, bytes);\n"
    "            bulk_copy_to(base + stage * sh.stage_bytes + r * (bytes / "
    "2),\n"
    "                         src, bytes / 2, base + sh.full + 8 * stage, "
    "mask);")
_ARRIVE = ("              asm volatile(\"mbarrier.arrive.shared::cta.b64 _, "
           "[%0];\" ::\"r\"(base + {} + 8 * stage) : \"memory\");\n")
# the tensor cores sum each part over the whole layer in the layer's output
# registers: no restart, no adds
_CHUNK_SUMS = """  float d[PART / 2];
#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < np) {"""
_LAYER_SUMS = """#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < np) {
      float (&d)[PART / 2] =
          *reinterpret_cast<float (*)[PART / 2]>(s + lq * PART / 2);"""
_PICK = ("  w.kern = w.sh.stages >= 5 ? mlp_rows_wide_kernel<2>\n"
         "                            : mlp_rows_wide_kernel<1>;")
_CTAS = ("  s.ctas = parts <= 12 ? 2 : (parts <= 24 ? 4 : WIDE_CTAS);")
PATCHES = {
    "one_tf32": [
        ("        wgmma_n64(d, f[j].lo, desc[j] + at, j > 0);\n"
         "        wgmma_n64(d, f[j].hi, desc[j] + lo + at, 1);\n", ""),
        ("      for (int j = 0; j < NK; ++j) "
         "wgmma_n64(d, f[j].hi, desc[j] + at, 1);",
         "      for (int j = 0; j < NK; ++j)\n"
         "        wgmma_n64(d, f[j].hi, desc[j] + at, j > 0);")],
    "no_b_loads": [
        (_COPY,
         "            if (p == 0 && l == 0 && k < C::STAGES) {\n" + _COPY
         + "\n            } else {\n" + _ARRIVE.format("C::FULL")
         + "            }")],
    "promote_1": [("static constexpr int PROMOTE = W == 512 ? 1 : 2;",
                   "static constexpr int PROMOTE = 1;")],
    "promote_2": [("static constexpr int PROMOTE = W == 512 ? 1 : 2;",
                   "static constexpr int PROMOTE = 2;")],
    "layer_sums": [
        (_CHUNK_SUMS, _LAYER_SUMS),
        ("        wgmma_n64(d, f[j].lo, desc[j] + at, j > 0);",
         "        wgmma_n64(d, f[j].lo, desc[j] + at, 1);"),
        ("      for (int i = 0; i < PART / 2; ++i) s[lq * PART / 2 + i] += "
         "d[i];", "")],
    "wide_one_tf32": [
        ("        wgmma_n128(acc, f[j].lo, desc[j] + at, j > 0);\n"
         "        wgmma_n128(acc, f[j].hi, desc[j] + plane_lo + at, 1);\n",
         ""),
        ("      for (int j = 0; j < NK; ++j) wgmma_n128(acc, f[j].hi, desc[j] "
         "+ at, 1);",
         "      for (int j = 0; j < NK; ++j)\n"
         "        wgmma_n128(acc, f[j].hi, desc[j] + at, j > 0);"),
        ("        wgmma_n64(acc0, f[j].lo, desc[j] + at, j > 0);\n"
         "        wgmma_n64(acc0, f[j].hi, desc[j] + plane_lo + at, 1);\n",
         ""),
        ("      for (int j = 0; j < NK; ++j) wgmma_n64(acc0, f[j].hi, desc[j] "
         "+ at, 1);",
         "      for (int j = 0; j < NK; ++j)\n"
         "        wgmma_n64(acc0, f[j].hi, desc[j] + at, j > 0);")],
    "wide_no_b_loads": [
        (_WIDE_COPY,
         "            if (p == 0 && l == 0 && k < sh.stages) {\n" + _WIDE_COPY
         + "\n            } else {\n" + _ARRIVE.format("sh.full")
         + "            }")],
    "wide_promote_1": [(_PICK, "  w.kern = mlp_rows_wide_kernel<1>;")],
    "wide_promote_2": [(_PICK, "  w.kern = mlp_rows_wide_kernel<2>;")],
    "wide_single_parts": [("    if (i + 1 < P.n) {", "    if (false) {"),
                          ("    } else if (i < P.n) {",
                           "    }\n#pragma unroll\n"
                           "    for (int i2 = i; i2 < i + 2; ++i2) "
                           "if (i2 < P.n) {\n      const uint64_t at = "
                           "(uint64_t)((P.l0 + P.ls * i2) * PART * 32) >> 4;"),
                          ("      for (int e = 0; e < PART / 2; ++e) s[i * "
                           "PART / 2 + e] += acc0[e];",
                           "      for (int e = 0; e < PART / 2; ++e) s[i2 * "
                           "PART / 2 + e] += acc0[e];")],
    "wide_ctas_512": [(_CTAS, "  s.ctas = (parts + WIDE_PARTS - 1) / "
                              "WIDE_PARTS;")],
    "wide_local_a": [("                        rank0 + q % C);",
                      "                        rank);")],
    "wide_ld_shared": [
        ("      return ld_cluster(act_at + (((q / C) * 8 + (kt & 7)) * 128) "
         "* 16,\n                        rank0 + q % C);",
         "      return act[((q / C) * 8 + (kt & 7)) * 128 + wtid];")],
    "wide_no_sync": [("  asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
                      "  if (lead) {",
                      "  asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
                      "  if (ctas > 0) return;\n  if (lead) {")],
    "wide_no_prefetch": [
        ("  for (int j = 0; j < NK; ++j) split(a[j], f[j]);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < PF; ++j)\n"
         "    if (kt + NK + j < ksteps) a[j] = a_of(kt + NK + j);",
         "  for (int j = 0; j < NK; ++j) split(a_of(kt + j), f[j]);")],
}
# timed only: wrong values
WRONG = ("one_tf32", "no_b_loads", "wide_one_tf32", "wide_no_b_loads",
         "wide_local_a", "wide_ld_shared", "wide_no_sync", "wide_ctas_512")
# phase 23's trunks and a width-384 one (timed), and the default trunk
# (the σ lean only); the rays each is timed on (16384 unless named)
TRUNKS = {"w512_d8_s4": dict(width=512, depth=8, skips=(4,)),
          "w384_d6_s3": dict(width=384, depth=6, skips=(3,)),
          "w128_d6_s24": dict(width=128, depth=6, skips=(2, 4)),
          "w640_d2": dict(width=640, depth=2, skips=()),
          "w1408_d2": dict(width=1408, depth=2, skips=()),
          "default": {}}
RAYS = {"w640_d2": 4096, "w1408_d2": 1024}


def patched_source(name: str, src: str = None) -> str:
    """`src` (default: the kernel's source) with variant `name`'s patches
    applied; raises ValueError unless each matches exactly once."""
    if src is None:
        src = (_build.CSRC / _SOURCE).read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: the patch does not match the source "
                             f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name: str):
    """nvcc a variant into build/kernels/diag_rows_tc/: (ctypes entry,
    ptxas lines)."""
    out = _build.BUILD_DIR / "diag_rows_tc"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
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
    fn.argtypes = fused_mlp._tc_library.entries[_ENTRY]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(proc.stdout + proc.stderr)


def builds(names):
    """The real entry and each variant in `names`, built in parallel:
    name -> (ctypes entry, ptxas lines)."""
    fused_mlp._tc_library()
    out = {"real": (fused_mlp._tc_library._fns[_ENTRY],
                    ptxas_lines(_build.build_log.get(fused_mlp._TC_LIB,
                                                     "")))}
    names = [n for n in names if n != "real"]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(build, names)))
    return out


def _swapped(fn, call):
    """`call()` with the wrapper's entry swapped for `fn`."""
    fns = fused_mlp._tc_library._fns
    real = fns[_ENTRY]
    fns[_ENTRY] = fn
    try:
        return call()
    finally:
        fns[_ENTRY] = real


def _field(kw: dict, he: bool):
    """(field, params on the card): seeded from 0, all-mirror (the σ
    column |w|·5, the mirror bias +5) as chip_smoke.py phase 23; `he`
    also scales every trunk weight by √6."""
    from ..models.fields import MirrorNeRFField

    field = MirrorNeRFField(**kw)
    p = field.init(torch.Generator().manual_seed(0), "cuda")
    p["sigma"] = {"w": p["sigma"]["w"].abs() * 5.0, "b": p["sigma"]["b"]}
    m = dict(p["is_mirror"][1])
    m["b"] = m["b"] + 5.0
    p["is_mirror"] = [p["is_mirror"][0], m]
    if he:
        p["trunk"] = [{"w": lin["w"] * 6 ** 0.5, "b": lin["b"]}
                      for lin in p["trunk"]]
    return field, p


def view_rays(n: int, s: int):
    """n strided rays of the 400×300 view and S stratified depths: o, d,
    z on the card."""
    from ..core.sampling import stratified_z_vals
    from .exp_launch_ab import camera_rays

    rays_np = camera_rays(400, 300)
    r = torch.from_numpy(np.ascontiguousarray(
        rays_np[::len(rays_np) // n][:n])).cuda()
    o, d = r[:, 0:3].contiguous(), r[:, 3:6].contiguous()
    return o, d, stratified_z_vals(r[:, 6:7], r[:, 7:8], s).contiguous()


def sigma_lean(fns: dict, trunks=None) -> dict:
    """(weights, trunk) -> run -> (mean signed, max abs) error of raw σ
    against a float64 plain version over max(1, max |σ|), on 4096 rays ×
    128: each build through the wrapper and the fp32 plain version, for
    `trunks` (default: every trunk of TRUNKS)."""
    o, d, z = view_rays(4096, 128)
    out = {}
    with torch.no_grad():
        for weights in ("phase 23", "He-scaled"):
            for trunk in trunks or TRUNKS:
                kw = TRUNKS[trunk]
                field, p = _field(kw, weights == "He-scaled")
                exact = fused_mlp.mlp_rays_rows_reference(
                    field, _map(p, lambda _, t: t.double()), o.double(),
                    d.double(), d.double(), z.double(), True)[:, 0]
                scale = max(1.0, float(exact.abs().max()))
                runs = {name: (lambda fn=fn: _swapped(
                    fn, lambda: fused_mlp.tc_rows_cuda(
                        field, p, o, d, None, z, True)))
                    for name, fn in fns.items()}
                runs["fp32 plain"] = lambda: fused_mlp.mlp_rays_rows_reference(
                    field, p, o, d, d, z, True)
                res = {}
                for name, run in runs.items():
                    err = run()[:, 0].double() - exact
                    res[name] = (float(err.mean()) / scale,
                                 float(err.abs().max()) / scale)
                out[weights, trunk] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--watchdog", type=float, default=600.0,
                    help="seconds after which the tool ends itself (a "
                    "variant whose cluster deadlocks would hold the card)")
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--trunks", nargs="+",
                    choices=[t for t in TRUNKS if t != "default"],
                    default=[t for t in TRUNKS if t != "default"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--no_lean", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    faulthandler.dump_traceback_later(args.watchdog, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = builds(args.variants)
    fns = {k: v[0] for k, v in built.items()}
    cases = {"full": False, "sigma-only": True}
    res = {name: {} for name in fns}
    diff = {name: 0.0 for name in fns}
    with torch.no_grad():
        for trunk in args.trunks:
            field, p = _field(TRUNKS[trunk], False)
            o, d, z = view_rays(RAYS.get(trunk, 16384), 128)

            def run(so, field=field, p=p, o=o, d=d, z=z):
                return fused_mlp.tc_rows_cuda(field, p, o, d,
                                              None if so else d, z, so)
            for c, so in cases.items():
                want = fused_mlp.mlp_rays_rows_reference(field, p, o, d, d,
                                                         z, so)
                for name, fn in fns.items():
                    diff[name] = max(diff[name], float(
                        (_swapped(fn, lambda: run(so)) - want).abs().max())
                        / max(1.0, float(want.abs().max())))
                del want
            for rnd in range(args.rounds):
                order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
                for name in order:
                    for c, so in cases.items():
                        ms = _swapped(fns[name], lambda: _ms(
                            lambda: run(so), reps=3))
                        key = f"{trunk} {c}"
                        res[name][key] = min(res[name].get(key, 1e9), ms)
    lean = {} if args.no_lean else sigma_lean(
        fns, args.trunks + ["default"])
    card = torch.cuda.get_device_name(0)
    rays = ", ".join(f"{t} {RAYS.get(t, 16384)}" for t in args.trunks)
    print(f"device: {card}; rays × 128 ({rays}); ms per call, best of "
          f"{args.rounds} rounds in turns; max |build - plain| (scaled "
          f"above 1; bar {KERNEL_ATOL:.0e})")
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"max |build - plain| {diff[name]:.3e}")
        print(f"{name:16s} " + ", ".join(f"{c} {ms:.3f}" for c, ms in
                                         res[name].items()) + f" ({note})",
              flush=True)
        for line in built[name][1]:
            print(f"{'':16s} ptxas: {line}")
    if lean:
        print("raw σ against a float64 plain version (σ-only, 4096 rays × "
              "128, scaled above 1): mean signed error, max abs error")
    for (weights, trunk), runs in lean.items():
        print(f"  {weights}, {trunk}: " + "; ".join(
            f"{k} {m:+.3e}, {a:.3e}" for k, (m, a) in runs.items()))
    for name, dv in diff.items():
        if name not in WRONG:
            assert dv <= KERNEL_ATOL, (name, dv)
    return {"device": card, "ms": res, "max_diff": diff,
            "sigma_lean": {f"{w}, {t}": v for (w, t), v in lean.items()}}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
