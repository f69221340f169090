"""What bounds the table products (`csrc/table_mma.cu`, ops/table_mma.py):
copies of the source with one piece changed, built beside the real one and
timed in turns on the same inputs, in one process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_table_diag [--variants ...]

Variants (each a text patch of the source, as in `exp_cp_diag`; the first
two compute wrong values and are timed only, the others must stay exact):

  no_build      the producers store a constant unit in place of each basis
                unit (no adds, no cast, no packing; the stores, the table
                copy and the barriers stay): the share the build takes;
  no_products   the consumers issue no `wgmma` (the waits and releases
                stay): the share the tensor cores take;
  cast_f2i      the int8 cast of the first design, __float2int_rz after a
                two-sided clip (the kernel: cvt.rzi.s8.f32 after one fmaxf);
  cast_directed the int8 cast as the add of 1.5·2²³ rounded toward zero
                (c ≥ 0) or up (c < 0) after the clip, whose low byte is the
                truncated value (no F2I, ~3 more instructions an element);
  regs_168      the consumers given 168 registers, the producers 88 (the
                kernel: 152 and 104 in int8, 184 and 72 in bf16);
  stages_3      a ring of three stages in place of four;
  tile_128      tiles of 128 lanes: one consumer warpgroup (184 registers),
                the two producer warpgroups building 4 lanes a thread (160
                registers), the table chunk read per 128 lanes;
  one_tile_a_cta  a CTA a tile (256 at the defaults: two waves), not
                persistent CTAs walking the tiles;
  one_in_flight the consumers issue the next chunk's products before they
                wait for the last chunk's (one group in flight; a stage is
                released a chunk later).

Inputs: the JAX probe's defaults (g 512, r 64, lanes 1024, 64 blocks, 9
tables; `exp_int8_probe.inputs`, seed 1). Every build is held against the
plain version on them and on the edge inputs (`edge_inputs`: x − 5.3, x
spread over ±150 to clip, and x on a 1/64 grid plus 2⁻⁸: bf16 rounding
ties): int8 bit for bit, bf16 ≤ 1e-5 scaled above 1 (the timed-only ones
are reported). Each build launches through the wrapper's own entry (its
ctypes function swapped in), 10 calls a round, best of 3 rounds in turns,
per type. Prints ms per call, ptxas' registers and spills, and the SASS
opcode counts of each instance of the real build (`cuobjdump`). Imports only
torch and the port; the builds go to `build/kernels/diag/` (git-ignored).
A patch that no longer matches the source exactly once stops the tool with
an error naming it.
"""

from __future__ import annotations

import argparse
import faulthandler
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import table_mma as tm
from . import exp_cp_diag
from .exp_cp_diag import _ms
from .exp_int8_probe import inputs

ENTRY = "mnerf_table_mma"
DEFAULTS = dict(g=512, r=64, lanes=1024, blocks=64, tables=9)
BF16_BAR = 1e-5  # scaled above 1: fp32 sums in another order
# the kernel's int8 cast (cast_s8's body), and the F2I-free one: c + 1.5·2²³
# lies in [2²³, 2²⁴), where the fp32 grid is the integers; rounded toward
# zero (c ≥ 0) or up (c < 0) it is 1.5·2²³ + trunc(c), whose low mantissa
# byte is trunc(c) in two's complement
_CVT = ("  int v;\n"
        "  asm(\"{\\n.reg .s8 t;\\ncvt.rzi.s8.f32 t, %1;\\ncvt.s32.s8 %0, t;\\n}\"\n"
        "      : \"=r\"(v) : \"f\"(fmaxf(f, -127.f)));\n"
        "  return (uint32_t)v;")
_DIRECTED = ("  const float c = fminf(fmaxf(f, -127.f), 127.f);\n"
             "  return __float_as_uint(c < 0.f ? __fadd_ru(c, 12582912.f)\n"
             "                                 : __fadd_rz(c, 12582912.f));")
PATCHES = {
    "no_build": [
        ("              basis_unit<T>(a, xl[i], jf);",
         "              make_uint4(__float_as_uint(xl[i]), 0u, 0u, 0u);")],
    "no_products": [
        ("          wgmma_k32(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);",
         "          acc[ks] += 1;")],
    "cast_f2i": [(_CVT, "  return (uint32_t)__float2int_rz(fminf(fmaxf(f, "
                        "-127.f), 127.f));")],
    "cast_directed": [(_CVT, _DIRECTED)],
    "regs_168": [("REG_CONSUMER = 152, REG_PRODUCER = 104;",
                  "REG_CONSUMER = 168, REG_PRODUCER = 88;"),
                 ("REG_CONSUMER = 184, REG_PRODUCER = 72;",
                  "REG_CONSUMER = 168, REG_PRODUCER = 88;")],
    "stages_3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "tile_128": [("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 1;"),
                 ("REG_CONSUMER = 152, REG_PRODUCER = 104;",
                  "REG_CONSUMER = 184, REG_PRODUCER = 160;"),
                 ("REG_CONSUMER = 184, REG_PRODUCER = 72;",
                  "REG_CONSUMER = 184, REG_PRODUCER = 160;")],
    "one_tile_a_cta": [
        ("  const int grid = (int)(tiles < sms ? tiles : sms);",
         "  const int grid = (int)tiles;")],
    "one_in_flight": [
        ("        wgmma_commit();\n"
         "        wgmma_wait_all();\n"
         "        if ((tid & 31) == 0) mbar_arrive(empty + 8 * stage);\n",
         "        wgmma_commit();\n"
         "        asm volatile(\"wgmma.wait_group.sync.aligned 1;\" ::: "
         "\"memory\");\n"
         "        if (c > 0 && (tid & 31) == 0)\n"
         "          mbar_arrive(empty + 8 * ((stage + STAGES - 1) % STAGES));\n"
         "        if (c == chunks - 1) {\n"
         "          wgmma_wait_all();\n"
         "          if ((tid & 31) == 0) mbar_arrive(empty + 8 * stage);\n"
         "        }\n")],
}
WRONG = ("no_build", "no_products")  # timed only
SASS_OPS = ("IGMMA", "HGMMA", "FADD", "FADD.RZ", "FADD.RP", "FMNMX", "FSETP",
            "PRMT", "F2I", "F2FP", "I2F", "LDS", "STS", "LDG", "LDL", "STL")
_EXACT = ("FADD",)  # FADD.RZ and FADD.RP counted apart


def edge_inputs(x: torch.Tensor) -> dict:
    """x and the edge inputs built from it: negative values (x − 5.3),
    values that clip at ±127 (x spread over ±150), and bf16 rounding ties
    (x on a 1/64 grid plus 2⁻⁸: basis_1[0, l] = 1 + x is an odd multiple of
    2⁻⁸ in [1, 2), half a bf16 step)."""
    return {"uniform": x, "negative": x - 5.3, "clipping": x * 300.0 - 150.0,
            "ties": torch.round(x * 64.0) / 64.0 + 2.0 ** -8}


def builds(names) -> dict:
    """The real entry and each variant, built in parallel: name -> (ctypes
    entry, ptxas lines)."""
    tm._library()
    out = {"real": (tm._library._fns[ENTRY], [
        f"{_instance(k)}: {v}" for k, v in _build.ptxas_by_function(
            _build.build_log.get(tm._LIB, ""), "table_mma").items()])}
    src = (_build.CSRC / "table_mma.cu").read_text()
    names = [n for n in names if n != "real"]

    def one(name):
        fn, ptxas = exp_cp_diag.build(f"table_{name}",
                                      {f"table_{name}": PATCHES[name]},
                                      ENTRY, tm._library, source=src)
        return fn, [ln for ln in ptxas if "Used" in ln or "spill" in ln]

    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(one, names)))
    return out


def _instance(name: str) -> str:
    return "bf16" if "bfloat16" in name else "int8"


def sass_counts() -> dict:
    """Opcode counts of each instance of the real build (static)."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(_build.library_path(tm._LIB))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.splitlines()[0].strip()
        if "table_mma_kernel" not in name:
            continue
        ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+"
                         r"(?:\.[A-Z0-9]+)*)", f, flags=re.M)
        out[_instance(name)] = {op: sum(
            o == op or (op not in _EXACT and o.startswith(op + "."))
            for o in ops) for op in SASS_OPS}
        out[_instance(name)]["all"] = len(ops)
    return out


def _swapped(fn, call):
    fns = tm._library._fns
    real = fns[ENTRY]
    fns[ENTRY] = fn
    try:
        return call()
    finally:
        fns[ENTRY] = real


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--watchdog", type=float, default=420.0,
                    help="seconds after which the process ends itself")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    # a variant whose ring deadlocks would hold the card: end the process
    faulthandler.dump_traceback_later(args.watchdog, exit=True)
    built = builds(args.variants)
    fns = {k: v[0] for k, v in built.items()}
    x, tabs = inputs(**DEFAULTS, seed=1, device="cuda")
    cases = edge_inputs(x)
    err = {name: {} for name in fns}
    with torch.no_grad():
        for kind, t in tabs.items():
            for case, xc in cases.items():
                ref = tm.table_mma_reference(xc, t)
                for name, fn in fns.items():
                    got = _swapped(fn, lambda: tm.table_mma(xc, t))
                    e = (float((got != ref).sum()) if kind == "int8" else
                         float((got - ref).abs().max()) / max(
                             1.0, float(ref.abs().max())))
                    err[name][kind] = max(err[name].get(kind, 0.0), e)
        res = {name: {} for name in fns}
        for rnd in range(args.rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for kind, t in tabs.items():
                    ms = _swapped(fns[name],
                                  lambda t=t: _ms(lambda: tm.table_mma(x, t)))
                    res[name][kind] = min(res[name].get(kind, 1e9), ms)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; {DEFAULTS}; ms per call, best of {args.rounds} "
          "rounds in turns; int8 values that differ from the plain version "
          "and bf16's largest difference (scaled above 1) over the uniform "
          "and edge inputs")
    for name in fns:
        note = "wrong values, timed only; " if name in WRONG else ""
        print(f"{name:12s} int8 {res[name]['int8']:.4f}, bf16 "
              f"{res[name]['bf16']:.4f} ({note}int8 differ "
              f"{err[name]['int8']:.0f}, bf16 {err[name]['bf16']:.2e})")
        for line in built[name][1]:
            print(f"{'':12s} ptxas: {line}")
    sass = sass_counts()
    for inst, counts in sass.items():
        print(f"SASS of the real {inst} instance (static): " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
    faulthandler.cancel_dump_traceback_later()
    for name, e in err.items():
        if name not in WRONG:
            assert e["int8"] == 0 and e["bf16"] <= BF16_BAR, (name, e)
    return {"device": card, "ms": res, "err": err, "sass": sass}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
