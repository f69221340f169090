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
output), the ways of a mode timed in turns, best of 8 rounds, in µs per
rep:
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

The wrapper's cost, step by step (`breakdown`, host clock over 10⁴ calls of
each step alone on the SMALL tensors, the steps in turns, best of 3 rounds,
less the loop's own cost): the port's launch path as the wrappers run it now
(dispatch, checks, the raw stream, the ctypes launch with the device guard
in C, the counter) beside the steps it replaced (`torch.cuda.device` around
the launch, `torch.cuda.current_stream(dev)`, the device set of the old
dispatch), a way it does not take (the arguments packed by `struct` into
one ctypes argument, `mnerf_floor_launch_packed`) and an allocation
(`torch.empty_like`), which the wrappers that return a new tensor pay.

It imports only torch and the port, and builds the kernel at first use.
`main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import ctypes
import struct
import time

import numpy as np
import torch

from ..ops import invoke_floor as fl
from .timing import device_ms, time_ms

REPS = 256
BEST_OF = 8
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


def _best_us(runs: dict) -> dict:
    """µs per rep of each of `runs` (name -> a chain of REPS reps), timed
    in turns so that a slow spell of the shared host hits every way alike:
    BEST_OF rounds (in reverse order every other round) after a warm run of
    each, the best round of each; the host clock ends in a synchronize."""
    for run in runs.values():
        run()
    best = dict.fromkeys(runs, float("inf"))
    names = list(runs)
    for r in range(BEST_OF):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            best[name] = min(best[name], time.perf_counter() - t0)
    return {name: t / REPS * 1e6 for name, t in best.items()}


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

    runs = {"wrapper": chain}
    rcs = []
    if not torch_call:
        runs["bare"] = lambda: fl.chain_cuda(a, b, n)
        launch = fl._library.entry("mnerf_floor_launch")
        rows, row_len, small = fl._shape(a)
        card = a.get_device()
        stream = torch.cuda.current_stream().cuda_stream
        pa, pb = a.data_ptr(), b.data_ptr()

        def raw():
            x, y = pa, pb
            rc = 0
            for _ in range(n):
                rc |= launch(x, y, rows, row_len, card, stream)
                x, y = y, x
            rcs.append(rc)

        runs["ctypes"] = raw
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
    graph.replay()
    torch.cuda.synchronize()
    assert (fl.launches_small, fl.launches_grid) == at_capture, \
        "the launch counter moved on a replay"
    replays = [1]

    def replay():
        graph.replay()
        replays[0] += 1

    runs["graph"] = replay
    res = _best_us(runs)
    assert not any(rcs), rcs
    if rcs:
        fl._count(small, len(rcs) * n)  # launches made past the wrapper
    res["graph_launches"] = replays[0] * n
    res["counted_at_capture"] = sum(at_capture) - sum(before)
    del graph
    return {w: res.get(w) for w in (*WAYS, "graph_launches",
                                    "counted_at_capture")}


BREAKDOWN_CALLS = 10_000


def _launch_packed():
    """The floor's launch with its arguments in one buffer (x, y, rows,
    row_len, device, stream, native alignment), and their packer."""
    fn = fl._library().mnerf_floor_launch_packed
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn, struct.Struct("PPiiiP").pack


def breakdown(seed: int = 1, calls: int = BREAKDOWN_CALLS) -> dict:
    """µs per call of each step of a wrapper's launch on the SMALL tensors
    (host clock over `calls` calls, the steps in turns, best of 3 rounds,
    less an empty call's cost); the launches the bare steps make are counted
    past the wrapper."""
    from ..ops import _build

    a = _inputs(fl.SMALL_SHAPE, seed, "cuda")
    b = torch.empty_like(a)
    launch = fl._library.entry("mnerf_floor_launch")
    packed, pack = _launch_packed()
    card, pa, pb = a.get_device(), a.data_ptr(), b.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    f32 = (torch.float32,)
    rcs = []

    def device_ctx():  # a `with` block, timed whole (enter and exit)
        with torch.cuda.device(a.device):
            pass

    steps = {
        "empty call (subtracted)": lambda: None,
        "dispatch: x.is_cuda": lambda: a.is_cuda,
        "checks: card_index(x, out)": lambda: _build.card_index(
            "floor", ("x", a, f32, 16), ("out", b, f32, 16)),
        "checks: the floor's shape": lambda: fl._shape(a),
        "stream: _build.current_stream(i)":
            lambda: _build.current_stream(card),
        "ctypes launch (device guard in C)":
            lambda: rcs.append(launch(pa, pb, 1, 1024, card, stream)),
        "counter (adding 0: the count stays true)":
            lambda: fl._count(True, 0),
        "the wrapper: axpb(x, out)": lambda: fl.axpb(a, b),
        "not taken: the arguments packed into one (struct, ctypes)":
            lambda: rcs.append(packed(pack(pa, pb, 1, 1024, card, stream))),
        "replaced: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(a.device).cuda_stream,
        "replaced: with torch.cuda.device(x.device)": device_ctx,
        "replaced: the dispatch's device set, on_card(x, out)":
            lambda: _build.on_card("floor", a, b),
        "allocation: torch.empty_like(x)": lambda: torch.empty_like(a),
        "allocation: x.new_empty(x.shape)": lambda: a.new_empty(a.shape),
    }
    us = dict.fromkeys(steps, float("inf"))
    for _ in range(3):
        for name, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us[name] = min(us[name], (time.perf_counter() - t0) / calls * 1e6)
    assert not any(rcs), f"a bare launch returned {set(rcs)}"
    fl._count(True, len(rcs))  # the bare launches, past the wrapper
    base = us.pop("empty call (subtracted)")
    return {"calls": calls, "empty_call_us": base,
            "us": {k: v - base for k, v in us.items()}}


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
    res["breakdown"] = breakdown(seed)
    return res


def format_table(floor_us: dict) -> str:
    """The floor table as text: a row per mode, a column per way."""
    lines = [f"{'µs per rep':<11}" + "".join(f"{w:>10}" for w in WAYS)]
    for mode, row in floor_us.items():
        lines.append(f"{mode:<11}" + "".join(
            f"{row[w]:10.3f}" if row[w] is not None else f"{'—':>10}"
            for w in WAYS))
    return "\n".join(lines)


def format_breakdown(bd: dict) -> str:
    """The wrapper's cost step by step, as text."""
    return "\n".join(
        [f"the wrapper step by step, µs per call over {bd['calls']} calls "
         f"(less {bd['empty_call_us']:.3f} µs of an empty call):"]
        + [f"  {k:<55s}{v:8.3f}" for k, v in bd["us"].items()])


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
            print(format_breakdown(b["breakdown"]))
    return result


if __name__ == "__main__":
    main()
