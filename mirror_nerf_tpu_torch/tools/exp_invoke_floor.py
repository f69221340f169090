"""The launch-floor probe on the GPU (torch counterpart of
`tools/exp_invoke_floor.py`).

    python -m mirror_nerf_tpu_torch.tools.exp_invoke_floor         # the card
    python -m mirror_nerf_tpu_torch.tools.exp_invoke_floor --cpu   # no card

The JAX probe asked what one pallas_call costs on its TPU, beside the work
it does. Here the same question is asked of one launch of a kernel of the
port, through `csrc/invoke_floor.cu` (ops/invoke_floor.py): y =
1.000001·x + 1e-6 over fp32, SMALL on the (8, 128) tensor in one CTA, GRID on
(128, 1, 4096) in 128 CTAs.

Parity, against the plain PyTorch version on the same inputs: SMALL and GRID
bit for bit, and a chain of launches looped in C against the plain version
applied as often. On the CPU the wrapper is the plain version, so there it
is held against the float64 sum, which is exact for these inputs.

Timing (the card only). The JAX probe's four modes, each a dependent chain
of REPS = 256 reps (ping-pong buffers: each call reads the previous
output), best of 4, in µs per rep:
  none: one PyTorch elementwise call per rep, `torch.add(1e-6, x,
    alpha=1.000001)`, the library yardstick (the port never calls it);
    `none_grid` is the same call on the GRID shape;
  one: one SMALL launch per rep;  two: two SMALL launches per rep;
  grid: one GRID launch per rep;
each measured four ways (host clock around the chain, which ends in a
synchronize):
  bare: `mnerf_floor_chain` loops the launches in C, called once;
  ctypes: the library's launch entry called from Python per launch, on
    buffers allocated once, with no checks;
  wrapper: the port's wrapper `axpb(x, out)` per launch (device dispatch,
    checks, stream, launch counter);
  graph: the wrapper chain captured once in a `torch.cuda.CUDAGraph` and
    replayed.
Beside them, each kernel's device time per launch from a torch.profiler
trace. The launch counters move once at capture and not on replay, so the
replays' launches are counted here (`graph_launches`).

It imports only torch and the port, and builds the kernel at first use.
`main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import invoke_floor as fl
from .timing import device_ms, time_ms

REPS = 256
BEST_OF = 4
CHAIN = 5  # launches of the parity chain
# mode -> (buffer shape, calls a rep)
MODES = {"none": (fl.SMALL_SHAPE, 1), "none_grid": (fl.GRID_SHAPE, 1),
         "one": (fl.SMALL_SHAPE, 1), "two": (fl.SMALL_SHAPE, 2),
         "grid": (fl.GRID_SHAPE, 1)}
WAYS = ("bare", "ctypes", "wrapper", "graph")


def _inputs(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)


def parity(device, seed: int = 0) -> dict:
    """SMALL and GRID against the plain version; returns the count of
    values that differ (0 asserted) per case."""
    out = {}
    for name, shape in (("small", fl.SMALL_SHAPE), ("grid", fl.GRID_SHAPE)):
        x = _inputs(shape, seed, device)
        got = fl.axpb(x)
        if device == "cpu":  # exact in float64 for |x| of a normal sample
            ref = (x.double() * float(fl.SCALE) + float(fl.SHIFT)).float()
        else:
            ref = fl.axpb_reference(x)
        out[name] = int((got != ref).sum())
        # a dependent chain: C's loop on the card, the wrapper on the CPU
        want = x
        for _ in range(CHAIN):
            want = fl.axpb_reference(want)
        if device == "cpu":
            chained = x
            for _ in range(CHAIN):
                chained = fl.axpb(chained)
        else:
            chained = fl.chain_cuda(x.clone(), torch.empty_like(x), CHAIN)
        out[f"{name}_chain{CHAIN}"] = int((chained != want).sum())
        assert out[name] == 0 and out[f"{name}_chain{CHAIN}"] == 0, out
    return out


def _best_us(run) -> float:
    """µs per rep of `run` (a chain of REPS reps), best of BEST_OF
    after a warm run; the host clock ends in a synchronize."""
    run()
    best = float("inf")
    for _ in range(BEST_OF):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / REPS * 1e6


def _ways(mode: str, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The four ways of one mode, µs per rep (None where a way has no
    meaning: no C loop or ctypes entry runs a PyTorch call)."""
    per = MODES[mode][1]
    n = REPS * per
    torch_call = mode.startswith("none")
    eps = torch.tensor(float(fl.SHIFT), device=a.device)
    alpha = float(fl.SCALE)

    def chain():
        x, y = a, b
        for _ in range(n):
            if torch_call:
                torch.add(eps, x, alpha=alpha, out=y)
            else:
                fl.axpb(x, y)
            x, y = y, x

    res = {"wrapper": _best_us(chain)}
    if not torch_call:
        res["bare"] = _best_us(lambda: fl.chain_cuda(a, b, n))
        lib = fl._library()
        launch = lib.mnerf_floor_launch
        rows, row_len, small = fl._shape(a)
        pa, pb = a.data_ptr(), b.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        rcs = []

        def raw():
            x, y = pa, pb
            rc = 0
            for _ in range(n):
                rc |= launch(x, y, rows, row_len, stream)
                x, y = y, x
            rcs.append(rc)

        res["ctypes"] = _best_us(raw)
        assert not any(rcs), rcs
        fl._count(small, len(rcs) * n)  # launches made past the wrapper
    # the wrapper chain captured once, replayed
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()  # warm on a side stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (fl.launches_small, fl.launches_grid)
    with torch.cuda.graph(graph):
        chain()
    at_capture = (fl.launches_small, fl.launches_grid)
    replays = [0]

    def replay():
        graph.replay()
        replays[0] += 1

    res["graph"] = _best_us(replay)
    assert (fl.launches_small, fl.launches_grid) == at_capture, \
        "the launch counter moved on a replay"
    res["graph_launches"] = replays[0] * n
    res["counted_at_capture"] = sum(at_capture) - sum(before)
    del graph
    return {w: res.get(w) for w in (*WAYS, "graph_launches",
                                    "counted_at_capture")}


def bench(seed: int = 1) -> dict:
    """The floor table (mode × way, µs per rep), the device time per launch
    of each kernel and of the yardstick, and the plain version's time."""
    dev = "cuda"
    res = {"floor_us": {}, "device_us": {}, "plain_ms": {}}
    for mode, (shape, _) in MODES.items():
        a = _inputs(shape, seed, dev)
        b = torch.empty_like(a)
        res["floor_us"][mode] = _ways(mode, a, b)
    eps = torch.tensor(float(fl.SHIFT), device=dev)
    for name, shape in (("small", fl.SMALL_SHAPE), ("grid", fl.GRID_SHAPE)):
        a = _inputs(shape, seed, dev)
        b = torch.empty_like(a)
        res["device_us"][name] = device_ms(lambda: fl.axpb(a, b), 64) * 1e3
        res["device_us"][f"torch_add_{name}"] = device_ms(
            lambda: torch.add(eps, a, alpha=float(fl.SCALE), out=b),
            64) * 1e3
        res["plain_ms"][name] = time_ms(lambda: fl.axpb_reference(a), 20)
    return res


def format_table(floor_us: dict) -> str:
    """The floor table as text: a row per mode, a column per way."""
    lines = [f"{'µs per rep':<11}" + "".join(f"{w:>10}" for w in WAYS)]
    for mode, row in floor_us.items():
        lines.append(f"{mode:<11}" + "".join(
            f"{row[w]:10.3f}" if row[w] is not None else f"{'—':>10}"
            for w in WAYS))
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the parity part on the CPU (plain version)")
    ap.add_argument("--skip_parity", action="store_true")
    ap.add_argument("--skip_bench", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu for the parity "
                         "part on the CPU")
    device = "cpu" if args.cpu else "cuda"
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"device: {name}")
    result = {"device": device}
    if not args.skip_parity:
        result["parity"] = parity(device)
        print("parity (values that differ): " + ", ".join(
            f"{k} {v}" for k, v in result["parity"].items()))
    if not args.skip_bench:
        if device == "cpu":
            print("timing: not measured (no card)")
        else:
            result["bench"] = b = bench()
            print(format_table(b["floor_us"]))
            print("device µs per launch (profiler): " + ", ".join(
                f"{k} {v:.3f}" for k, v in b["device_us"].items()))
            print("plain version ms per call: " + ", ".join(
                f"{k} {v:.4f}" for k, v in b["plain_ms"].items()))
    return result


if __name__ == "__main__":
    main()
