"""What bounds the PE-MLP rows kernel on the tensor cores, and how far its
raw σ leans: copies of `csrc/fused_mlp_rows_tc.cu` with one piece changed,
built beside the real one and timed in turns on the same inputs, in one
process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_rows_tc_diag [--variants ...]

Variants (each a text patch of the source; the first two compute wrong
values and are timed only, the others must stay within the bar):

  one_tf32    one TF32 product (a_hi·b_hi) in place of three: the share of
              the time the tensor pipe's extra products take;
  no_b_loads  the weight ring filled once, then reused: no weight bytes
              leave L2 after the first stages, so the difference is what
              the weight stream holds back;
  promote_1   the tensor cores sum one k-step at a time at every width
              (the kernel: 1 at width 512, 2 below);
  promote_2   two k-steps at a time at every width.

Timing: chip_smoke.py phase 23's trunks (width 512, depth 8, skip 4;
width 128, depth 6, skips 2, 4) and a width-384 one (depth 6, skip 3),
all-mirror seeded weights, on 16384 strided rays of the 400×300 view at S
= 128, full and σ-only; each variant launches through the wrapper's own
entry (its ctypes function swapped in), 3 calls a round, best of 3 rounds
in turns. Accuracy: every build against the plain version on those
rays, the largest difference scaled above 1 (bar KERNEL_ATOL = 1e-4).

σ's lean: raw σ (σ-only rays, 4096 × 128) against a float64 plain version,
the mean signed and the largest error over max(1, max |σ|), for each build
and the fp32 plain version, on phase 23's weights and on He-scaled ones
(every trunk weight ×√6, the σ column |w|·5: the trunk keeps its features
through its depth and σ is far above 1), for the three timed trunks, and
for the default trunk both through the tuned rows mode of
csrc/fused_mlp_t.cu and through this kernel. Imports only
torch and the port; the builds go to `build/kernels/diag_rows_tc/`
(git-ignored). A patch that no longer matches the kernel's source exactly
once stops the tool with an error naming it.
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
         + "\n            } else {\n"
         "              asm volatile(\"mbarrier.arrive.shared::cta.b64 _, "
         "[%0];\" ::\"r\"(base + C::FULL + 8 * stage) : \"memory\");\n"
         "            }")],
    "promote_1": [("static constexpr int PROMOTE = W == 512 ? 1 : 2;",
                   "static constexpr int PROMOTE = 1;")],
    "promote_2": [("static constexpr int PROMOTE = W == 512 ? 1 : 2;",
                   "static constexpr int PROMOTE = 2;")],
}
WRONG = ("one_tf32", "no_b_loads")  # timed only
# phase 23's trunks and a width-384 one (timed), and the default trunk
# (the σ lean only)
TRUNKS = {"w512_d8_s4": dict(width=512, depth=8, skips=(4,)),
          "w384_d6_s3": dict(width=384, depth=6, skips=(3,)),
          "w128_d6_s24": dict(width=128, depth=6, skips=(2, 4)),
          "default": {}}


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


def sigma_lean(fns: dict) -> dict:
    """(weights, trunk) -> run -> (mean signed, max abs) error of raw σ
    against a float64 plain version over max(1, max |σ|), on 4096 rays ×
    128: each build through the wrapper, the fp32 plain version, and on
    the default trunk the tuned rows mode."""
    o, d, z = view_rays(4096, 128)
    out = {}
    with torch.no_grad():
        for weights in ("phase 23", "He-scaled"):
            for trunk, kw in TRUNKS.items():
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
                if trunk == "default":
                    runs["tuned (fused_mlp_t.cu)"] = lambda: fused_mlp.\
                        fused_rows_cuda(field, p, o, d, None, z, True)
                res = {}
                for name, run in runs.items():
                    err = run()[:, 0].double() - exact
                    res[name] = (float(err.mean()) / scale,
                                 float(err.abs().max()) / scale)
                out[weights, trunk] = res
    return out


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
    o, d, z = view_rays(16384, 128)
    cases = {"full": False, "sigma-only": True}
    res = {name: {} for name in fns}
    diff = {name: 0.0 for name in fns}
    with torch.no_grad():
        for trunk in [t for t in TRUNKS if t != "default"]:
            field, p = _field(TRUNKS[trunk], False)

            def run(so, field=field, p=p):
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
    lean = sigma_lean(fns)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; 16384 rays × 128; ms per call, best of "
          f"{args.rounds} rounds in turns; max |build - plain| (scaled above "
          f"1; bar {KERNEL_ATOL:.0e})")
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"max |build - plain| {diff[name]:.3e}")
        print(f"{name:12s} " + ", ".join(f"{c} {ms:.3f}" for c, ms in
                                         res[name].items()) + f" ({note})")
        for line in built[name][1]:
            print(f"{'':12s} ptxas: {line}")
    print("raw σ against a float64 plain version (σ-only, 4096 rays × 128, "
          "scaled above 1): mean signed error, max abs error")
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
