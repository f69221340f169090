"""The int8 / bf16 table-product probe on the GPU (torch counterpart of
`tools/exp_int8_probe.py`).

    python -m mirror_nerf_tpu_torch.tools.exp_int8_probe         # the card
    python -m mirror_nerf_tpu_torch.tools.exp_int8_probe --cpu   # no card

The JAX probe asked whether int8 products run at twice the bf16 rate inside
its TPU kernel, at the CP encoder's shapes: per block, a (g, lanes) basis
built in the kernel from a (1, lanes) row, then `tables` products
(r, g) @ (g, lanes) summed into (r, lanes). Here the same work runs on the
tensor cores through `csrc/table_mma.cu` (ops/table_mma.py, `mma.sync`), in
int8 (int32 sums) and bf16 (fp32 sums), with the JAX probe's flags and
defaults (g 512, r 64, lanes 1024, 64 blocks, 9 tables).

Parity, against the plain PyTorch version on the same inputs (x uniform
[0, 1), int8 tables uniform in [−127, 127), bf16 tables standard normal):
int8 bit for bit, bf16 max |a − b| / max(1, max |b|) ≤ 1e-5. On the CPU the
wrapper is the plain version and runs at a small size (g 64, r 16, lanes
128, 2 blocks, 3 tables), held against a numpy int64 restatement (int8).

Timing (the card only; CUDA events over `--reps` back-to-back calls, best of
`--dispatches`, and the device time per call from a torch.profiler trace):
the kernel, the plain version, and two library figures, timed only (the
port never calls them). No single PyTorch call computes the function:
"GEMMs only" is one GEMM per table, (r, g) @ (g, blocks·lanes),
`torch._int_mm` for int8 and `torch.matmul` for bf16, on bases PyTorch
built beforehand (at the defaults 64 × 9 × 512 × 1024 values, 604 MB in
bf16: less work than the kernel does); "build + GEMMs" also builds the
bases in each call, the same function as the kernel. Rates in TOP/s (int8)
and TFLOP/s (bf16) of the products' 2·blocks·tables·r·g·lanes operations.

It imports only torch and the port, and builds the kernel at first use.
`main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import table_mma as tm
from .timing import device_ms, time_ms

KINDS = {"int8": torch.int8, "bf16": torch.bfloat16}
CPU_SIZE = dict(g=64, r=16, lanes=128, blocks=2, tables=3)
BF16_BAR = 1e-5  # scaled above 1: fp32 sums in another order


def inputs(g, r, lanes, blocks, tables, seed, device):
    """x (blocks, 1, lanes) fp32 and the tables of each type."""
    rng = np.random.default_rng(seed)
    x = rng.random((blocks, 1, lanes), dtype=np.float32)
    t8 = rng.integers(-127, 127, (tables, r, g)).astype(np.int8)
    t16 = rng.standard_normal((tables, r, g)).astype(np.float32)
    tabs = {"int8": torch.from_numpy(t8).to(device),
            "bf16": torch.from_numpy(t16).to(torch.bfloat16).to(device)}
    return torch.from_numpy(x).to(device), tabs


def numpy_int8(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The int8 function restated in numpy: three fp32 roundings for the
    basis, int64 products, each table's sum to fp32, summed in fp32."""
    nt, r, g = t.shape
    iot = np.arange(g, dtype=np.float32)[:, None] * np.float32(1e-3)
    out = np.zeros((x.shape[0], r, x.shape[2]), np.float32)
    for j in range(nt):
        basis = np.clip((iot + x) + np.float32(j), -127, 127).astype(np.int8)
        out = out + (t[j].astype(np.int64) @ basis.astype(np.int64)
                     ).astype(np.float32)
    return out


def _scaled_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0,
                                                float(ref.abs().max()))


def parity(device, size: dict, seed: int = 0) -> dict:
    """Each type against the plain version (and, on the CPU, int8 against
    numpy); returns the errors and asserts them."""
    x, tabs = inputs(**size, seed=seed, device=device)
    out = {}
    for name, t in tabs.items():
        got = tm.table_mma(x, t)
        assert got.shape == (size["blocks"], size["r"], size["lanes"])
        if device == "cpu":
            if name != "int8":
                continue
            ref = torch.from_numpy(numpy_int8(x.numpy(), t.numpy()))
        else:
            ref = tm.table_mma_reference(x, t)
        out[name] = _scaled_err(got, ref)
        if name == "int8":
            out["int8_values_that_differ"] = int((got != ref).sum())
            assert out["int8_values_that_differ"] == 0, out
        assert out[name] <= BF16_BAR, out
    return out


def _library_call(x, t, name, build: bool = False):
    """The yardstick: one GEMM per table on a basis (g, blocks·lanes) that
    PyTorch built beforehand, or, with `build`, builds in each call."""
    nt, r, g = t.shape

    def bases():
        return [tm.basis_reference(x, g, j, t.dtype).permute(1, 0, 2)
                .reshape(g, -1).contiguous() for j in range(nt)]

    mm = torch._int_mm if name == "int8" else torch.matmul
    if build:
        return lambda: [mm(t[j], b) for j, b in enumerate(bases())]
    built = bases()
    return lambda: [mm(t[j], built[j]) for j in range(nt)]


def bench(size: dict, reps: int, dispatches: int, seed: int = 1) -> dict:
    """Kernel, plain and library times and rates for both types."""
    x, tabs = inputs(**size, seed=seed, device="cuda")
    ops = 2.0 * size["blocks"] * size["tables"] * size["r"] * size["g"] \
        * size["lanes"]
    res = {"operations": ops}
    for name, t in tabs.items():
        def kern():
            return tm.table_mma(x, t)

        lib = _library_call(x, t, name)
        lib_build = _library_call(x, t, name, build=True)
        ms = min(time_ms(kern, reps) for _ in range(dispatches))
        lib_ms = min(time_ms(lib, reps) for _ in range(dispatches))
        build_ms = min(time_ms(lib_build, reps) for _ in range(dispatches))
        plain_ms = time_ms(lambda: tm.table_mma_reference(x, t), 3)
        res[name] = {
            "ms": ms, "device_ms": device_ms(kern, reps),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": device_ms(lib, reps),
            "library_build_ms": build_ms,
            "library_build_device_ms": device_ms(lib_build, reps),
            "rate": ops / ms / 1e9, "plain_rate": ops / plain_ms / 1e9,
            "library_rate": ops / lib_ms / 1e9}
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--g", type=int, default=512)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--tables", type=int, default=9)
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--dispatches", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the parity part on the CPU (plain version, "
                         "small size)")
    ap.add_argument("--skip_parity", action="store_true")
    ap.add_argument("--skip_bench", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu for the parity "
                         "part on the CPU")
    device = "cpu" if args.cpu else "cuda"
    size = CPU_SIZE if args.cpu else dict(
        g=args.g, r=args.r, lanes=args.lanes, blocks=args.blocks,
        tables=args.tables)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"device: {name}; size {size}")
    result = {"device": device, "size": size}
    if not args.skip_parity:
        result["parity"] = parity(device, size)
        print("parity (max abs error, scaled above 1): " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in result["parity"].items()))
    if not args.skip_bench:
        if device == "cpu":
            print("timing: not measured (no card)")
        else:
            result["bench"] = b = bench(size, args.reps, args.dispatches)
            for kind in KINDS:
                v = b[kind]
                unit = "TOP/s" if kind == "int8" else "TFLOP/s"
                print(f"{kind}: kernel {v['ms']:.4f} ms (device "
                      f"{v['device_ms']:.4f}) {v['rate']:.1f} {unit}; plain "
                      f"{v['plain_ms']:.3f} ms {v['plain_rate']:.2f} {unit}; "
                      f"library, GEMMs only {v['library_ms']:.4f} ms "
                      f"(device {v['library_device_ms']:.4f}) "
                      f"{v['library_rate']:.1f} {unit}; library, build + "
                      f"GEMMs {v['library_build_ms']:.4f} ms (device "
                      f"{v['library_build_device_ms']:.4f})")
    return result


if __name__ == "__main__":
    main()
