"""The segmented-prefix probe on the GPU (torch counterpart of
`tools/exp_reshape_probe.py`).

    python -m mirror_nerf_tpu_torch.tools.exp_reshape_probe         # the card
    python -m mirror_nerf_tpu_torch.tools.exp_reshape_probe --cpu   # no card

The JAX probe asked whether its TPU compiler lowers an in-kernel
(1, L) → (L/128, 128) reshape, so that the composite's per-ray exclusive
prefix becomes one matmul by the triangular TRI. On this card the question
is which formulation to use, and both are modes of `csrc/segment_scan.cu`
(ops/segment_scan.py): SCAN (a warp per 128-wide row, shuffles) and TRI (the
TPU's matmul, on the tensor cores: x split into three bf16 pieces, fp32
sums). WEIGHTS, the compositing epilogue on SCAN, is the form the composite
uses.

Parity, against a float64 exclusive prefix, max |a − b| / max(1, max |b|)
≤ 2e-6: the JAX probe's input ((8, 1, 4096) uniform [0, 1) from
RandomState(0)) and, on the card, the composite's 16384 rays × 128 samples;
S = 128, 64 and 16; the uniform input, the sentinel input (1e10 on each
segment's last value), where each sentinel's own value must equal the sum
of its segment's other values to the same bar, and the wide input (values
spread log-uniformly over 1e-6 … 1e10). WEIGHTS against float64
weights (atol 1e-5), per-segment Σw ≤ 1 + 1e-5, on uniform [0, 1.5) sd with
the sentinel (the input of tests/test_fused_cp.py:194-199); a miss names
the worst segment, its position and its input (`worst_segment`). On the CPU
both modes are the plain version.

Timing (the card only; CUDA events over back-to-back calls, in turns and
best of 5 rounds (`timing.per_call_ms`), and the device time per call from a
torch.profiler trace): SCAN, TRI, the plain version and the library
yardstick `torch.cumsum` on the segment view (inclusive: timed, never used)
at the JAX probe's shape (S = 128) and at the composite's 2,097,152 values
(S = 128 and 64); WEIGHTS and its plain version at 2,097,152 values, S =
128. At the composite's size SCAN is also called through bare ctypes, the C
entry with the same pointers and no checks (`*_bare`, counted in
`launches_scan` like the wrapper's): the wrapper's cost above it is the
launch path's. Rates in GB/s of compulsory traffic (each value
read once and written once). At the path's size the 16.8 MB of a call stay
in the 50 MB L2 from one call to the next, so the device time is also taken
cold (`cold_device_ms`: a 64 MiB fill before each call, left out of the
sum).

It imports only torch and the port, and builds the kernel at first use.
`main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import segment_scan as ss
from .timing import FLUSH_KERNEL, device_ms, l2_flush, per_call_ms

L = 4096
PROBE_SHAPE = (8, 1, L)
PATH_SHAPE = (16384, 128)  # the composite: rays × samples
SEGMENTS = (128, 64, 16)
PREFIX_BAR = 2e-6  # scaled above 1, against float64
WEIGHTS_ATOL = 1e-5
SENTINEL = 1e10
KINDS = ("uniform", "sentinel", "wide")


def probe_input(device) -> torch.Tensor:
    """The JAX probe's own input."""
    return torch.from_numpy(np.random.RandomState(0).rand(*PROBE_SHAPE)
                            .astype(np.float32)).to(device)


def path_input(device, seed: int = 0, high: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(PATH_SHAPE) * high).astype(
        np.float32)).to(device)


def wide_input(device, shape=PATH_SHAPE, seed: int = 0) -> torch.Tensor:
    """Values spread log-uniformly over 1e-6 … 1e10 (22 binades of
    exponent between neighbours, the sentinel's magnitude at the top)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((10.0 ** rng.uniform(-6.0, 10.0, shape)).astype(
        np.float32)).to(device)


def kind_input(x: torch.Tensor, s: int, kind: str) -> torch.Tensor:
    """x itself, x with sentinels, or a wide input of x's shape."""
    if kind == "sentinel":
        return with_sentinel(x, s)
    if kind == "wide":
        return wide_input(x.device, tuple(x.shape), seed=s)
    return x


def with_sentinel(x: torch.Tensor, s: int) -> torch.Tensor:
    """x with 1e10 on each segment's last value."""
    y = x.clone()
    y.view(-1, s)[:, -1] = SENTINEL
    return y


def exclusive64(x: torch.Tensor, s: int) -> torch.Tensor:
    """The float64 exclusive prefix per segment, (segments, s)."""
    xs = x.double().reshape(-1, s)
    return torch.cat([torch.zeros_like(xs[:, :1]),
                      torch.cumsum(xs[:, :-1], dim=-1)], dim=-1)


def prefix_errors(got: torch.Tensor, x: torch.Tensor, s: int):
    """(error against the float64 prefix, error of each segment's last value
    against the sum of its segment's others), both scaled above 1."""
    ref = exclusive64(x, s)
    g = got.double().reshape(-1, s)
    err = float((g - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    others = x.double().reshape(-1, s)[:, :-1].sum(-1)
    last = float((g[:, -1] - others).abs().max()) / max(
        1.0, float(others.abs().max()))
    return err, last


def weights64(sd: torch.Tensor, s: int) -> torch.Tensor:
    """The float64 weights per segment, (segments, s); the exponentials by
    `segment_scan.exp_plain` (on the CPU no MKL: see its note)."""
    x = sd.double().reshape(-1, s)
    return ss.exp_plain(-exclusive64(sd, s)) * (1.0 - ss.exp_plain(-x))


def weights_errors(got: torch.Tensor, sd: torch.Tensor, s: int):
    """(max abs error against float64 weights, max per-segment Σw)."""
    g = got.double().reshape(-1, s)
    return float((g - weights64(sd, s)).abs().max()), float(g.sum(-1).max())


def worst_segment(got: torch.Tensor, sd: torch.Tensor, s: int) -> str:
    """The segment whose weights stray furthest from float64: its index, the
    position in it, both values and the segment's input."""
    d = (got.double().reshape(-1, s) - weights64(sd, s)).abs()
    k = int(d.max(-1).values.argmax())
    i = int(d[k].argmax())
    return (f"segment {k} (of {d.shape[0]}), position {i}: got "
            f"{float(got.reshape(-1, s)[k, i])!r}, float64 "
            f"{float(weights64(sd, s)[k, i])!r}; Σw "
            f"{float(got.double().reshape(-1, s)[k].sum())!r}; input "
            f"{sd.reshape(-1, s)[k].tolist()}")


def parity(device, path: bool = True) -> dict:
    """Both modes and WEIGHTS against float64; returns the errors and
    asserts them."""
    out = {}
    inputs = [("probe", probe_input(device))]
    if path:
        inputs.append(("path", path_input(device)))
    for iname, x in inputs:
        for s in SEGMENTS:
            for kind in KINDS:
                xi = kind_input(x, s, kind)
                for mode in ("scan", "tri"):
                    err, last = prefix_errors(ss.segment_prefix(xi, s, mode),
                                              xi, s)
                    out[f"{iname}_S{s}_{kind}_{mode}"] = err
                    out[f"{iname}_S{s}_{kind}_{mode}_last"] = last
                    assert err <= PREFIX_BAR and last <= PREFIX_BAR, \
                        (iname, s, kind, mode, err, last)
        for s in (128, 16):
            sd = with_sentinel(x * 1.5, s)
            w = ss.prefix_weights(sd, s)
            err, wsum = weights_errors(w, sd, s)
            out[f"{iname}_S{s}_weights"] = err
            out[f"{iname}_S{s}_weights_max_sum"] = wsum
            assert err <= WEIGHTS_ATOL and wsum <= 1.0 + 1e-5, (
                s, err, wsum, worst_segment(w, sd, s))
    return out


def traffic_bytes(x: torch.Tensor) -> int:
    """Compulsory bytes: each value read once, its result written once."""
    return 2 * x.numel() * x.element_size()


def _bare_scan(x: torch.Tensor, s: int):
    """SCAN through bare ctypes: the C entry with the wrapper's pointers,
    card and stream, no checks, no allocation (the output is made once).
    Returns the call and the list of its return codes."""
    fn = ss._library.entry("mnerf_segment_scan")
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), x.numel() // ss.ROW, s,
            ss.MODES["scan"], x.get_device(),
            torch.cuda.current_stream().cuda_stream)
    rcs = []
    return (lambda: rcs.append(fn(*args))), rcs


def bench(seed: int = 1) -> dict:
    """SCAN, TRI, plain and torch.cumsum at the probe's and the path's
    shapes; WEIGHTS and its plain version at the path's; SCAN through bare
    ctypes at the path's. Each entry: ms per call (in turns), GB/s from it,
    and device_ms for the kernels and the library call (with cold_device_ms
    at the path's size)."""
    dev = "cuda"
    res = {}
    flush = l2_flush(dev)

    def measure(tag, x, fns, on_device):
        per = per_call_ms(fns)
        for name, fn in fns.items():
            ms = per[name]
            r = res[f"{tag}_{name}"] = {
                "ms": ms, "GB_per_s": traffic_bytes(x) / ms / 1e6}
            if name in on_device:
                r["device_ms"] = device_ms(fn, 20)
                if x.numel() > L * 8:  # the path's 16.8 MB fit the L2 warm
                    r["cold_device_ms"] = device_ms(
                        lambda: (flush(), fn()), 20, exclude=FLUSH_KERNEL)

    path = path_input(dev, seed)
    for tag, x, s in (("probe_S128", probe_input(dev), 128),
                      ("path_S128", path, 128), ("path_S64", path, 64)):
        fns = {mode: (lambda m=mode: ss.segment_prefix(x, s, m))
               for mode in ("scan", "tri")}
        fns["plain"] = lambda: ss.segment_prefix_reference(x, s)
        fns["cumsum"] = lambda: torch.cumsum(x.view(-1, s), -1)
        rcs = []
        if tag == "path_S128":
            fns["scan_bare"], rcs = _bare_scan(x, s)
        measure(tag, x, fns, ("scan", "tri", "cumsum"))
        assert not any(rcs), f"bare SCAN returned {set(rcs)}"
        ss.launches_scan += len(rcs)  # launched past the wrapper
    sd = with_sentinel(path * 1.5, 128)
    measure("path_S128", sd, {
        "weights": lambda: ss.prefix_weights(sd, 128),
        "weights_plain": lambda: ss.prefix_weights_reference(sd, 128)},
        ("weights",))
    return res


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
        result["parity"] = p = parity(device, path=device == "cuda")
        worst = max(v for k, v in p.items()
                    if not k.endswith(("_weights", "_max_sum")))
        print(f"parity: prefix max error {worst:.3e} (scaled above 1, vs "
              f"float64; sentinels included), WEIGHTS max abs error "
              f"{max(v for k, v in p.items() if k.endswith('_weights')):.3e}"
              f", max Σw "
              f"{max(v for k, v in p.items() if k.endswith('_max_sum')):.6f}")
    if not args.skip_bench:
        if device == "cpu":
            print("timing: not measured (no card)")
        else:
            result["bench"] = b = bench()
            for k, v in b.items():
                dev = (f" (device {v['device_ms']:.4f} ms"
                       + (f", cold L2 {v['cold_device_ms']:.4f} ms"
                          if "cold_device_ms" in v else "") + ")"
                       if "device_ms" in v else "")
                print(f"{k:26s}: {v['ms']:.4f} ms{dev}, "
                      f"{v['GB_per_s']:.1f} GB/s")
    return result


if __name__ == "__main__":
    main()
