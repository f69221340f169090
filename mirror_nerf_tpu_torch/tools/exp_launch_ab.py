"""The launch path of two trees side by side on the card: this tree's
wrappers and those of another checkout of the repository, in one process,
timed in turns.

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python -m mirror_nerf_tpu_torch.tools.exp_launch_ab --other build/other

The other tree's `mirror_nerf_tpu_torch` is imported under another name, so
its wrappers, with its kernels built from its own sources into its own
`build/`, run in this process beside this tree's, on the same inputs. A
yardstick that changes with the host, such as a time per call, is only
compared within one such run.

Per call (`timing.per_call_ms`: CUDA events over 200 back-to-back calls,
the functions of a group in turns, best of 5 rounds), each group with its
library call where there is one:
  gather_fp32, gather_bf16: GATHER (`gather_rows`) on the 2¹⁹ × 2 table at
    idx (64, 4096), and `t[idx]`;
  dense: DENSE (`dense_level_lookup`) on 262,144 samples of a side-62
    level, and trilinear `grid_sample`;
  prefix: SCAN and TRI (`segment_prefix`) on 16384 × 128 values, S = 128,
    and `torch.cumsum` on the segment view (inclusive: timed only);
  weights: WEIGHTS (`prefix_weights`) on the same size, S = 128;
  floor: the launch floor's SMALL wrapper `axpb(x, out)` on (8, 128), and
    `torch.add(1e-6, x, alpha=1.000001, out=y)`.
Each group is also checked: the two trees' outputs agree (GATHER and the
floor bit for bit, the rest within their kernels' bars).

It imports only torch and the two trees' ports. `main` returns the numbers
as a dict.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, hashgrid, invoke_floor, segment_scan
from .exp_hash_inkernel import (DENSE_SAMPLES, DENSE_SCALE, DENSE_SIDE,
                                IDX_SHAPE, TABLE_ROWS, _grid_sample_args)
from .exp_reshape_probe import PREFIX_BAR, path_input, with_sentinel
from .timing import per_call_ms

LIBS = ("segment_scan", "hashgrid", "invoke_floor")
OTHER = "other_port"  # the name the other tree's package is imported under


def load_other(root) -> dict:
    """The other tree's ops modules (`_build`, `hashgrid`, `invoke_floor`,
    `segment_scan`), its package imported as `other_port`."""
    pkg = Path(root).resolve() / "mirror_nerf_tpu_torch"
    if not (pkg / "__init__.py").exists():
        raise SystemExit(f"{root}: no mirror_nerf_tpu_torch package there")
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"{OTHER}.ops.{name}")
            for name in ("_build", *LIBS)}


def _groups(other: dict, seed: int) -> dict:
    """group -> (name -> callable, the pair whose outputs must agree, the
    bar: 0 for bit for bit)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    hg, ohg = hashgrid, other["hashgrid"]
    ss, oss = segment_scan, other["segment_scan"]
    fl, ofl = invoke_floor, other["invoke_floor"]
    groups = {}
    t32 = torch.from_numpy(rng.standard_normal(
        (TABLE_ROWS, 2)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, TABLE_ROWS, IDX_SHAPE,
                                        dtype=np.int32)).to(dev)
    for dtype, t in (("fp32", t32), ("bf16", t32.to(torch.bfloat16))):
        groups[f"gather_{dtype}"] = (
            {"this": lambda t=t: hg.gather_rows(t, idx),
             "other": lambda t=t: ohg.gather_rows(t, idx),
             "library": lambda t=t: t[idx]}, 0.0)
    rows = torch.from_numpy(rng.standard_normal(
        (DENSE_SIDE ** 3, 2)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.random((DENSE_SAMPLES, 3),
                                    dtype=np.float32)).to(dev)
    vol, grid = _grid_sample_args(rows, x, DENSE_SCALE, DENSE_SIDE)
    groups["dense"] = (
        {"this": lambda: hg.dense_level_lookup(rows, x, DENSE_SCALE,
                                               DENSE_SIDE),
         "other": lambda: ohg.dense_level_lookup(rows, x, DENSE_SCALE,
                                                 DENSE_SIDE),
         "library": lambda: torch.nn.functional.grid_sample(
             vol, grid, mode="bilinear", align_corners=True)}, 1e-5)
    p = path_input(dev, seed)
    groups["prefix"] = (
        {"scan_this": lambda: ss.segment_prefix(p, 128, "scan"),
         "scan_other": lambda: oss.segment_prefix(p, 128, "scan"),
         "tri_this": lambda: ss.segment_prefix(p, 128, "tri"),
         "tri_other": lambda: oss.segment_prefix(p, 128, "tri"),
         "library": lambda: torch.cumsum(p.view(-1, 128), -1)}, PREFIX_BAR)
    sd = with_sentinel(p * 1.5, 128)
    groups["weights"] = (
        {"this": lambda: ss.prefix_weights(sd, 128),
         "other": lambda: oss.prefix_weights(sd, 128)}, 1e-5)
    a = torch.from_numpy(rng.standard_normal(fl.SMALL_SHAPE).astype(
        np.float32)).to(dev)
    b, c = torch.empty_like(a), torch.empty_like(a)
    eps = torch.tensor(float(fl.SHIFT), device=dev)
    groups["floor"] = (
        {"this": lambda: fl.axpb(a, b), "other": lambda: ofl.axpb(a, c),
         "library": lambda: torch.add(eps, a, alpha=float(fl.SCALE),
                                      out=c)}, 0.0)
    return groups


def _agree(fns: dict, bar: float) -> float:
    """The largest difference, scaled above 1, between the two trees'
    outputs of each pair in a group (this vs other); asserted ≤ bar."""
    worst = 0.0
    for name in fns:
        if not name.endswith("this"):
            continue
        got = fns[name]().float()
        want = fns[name[:-4] + "other"]().float()
        err = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        assert err <= bar, (name, err, bar)
        worst = max(worst, err)
    return worst


def bench(other: dict, seed: int = 1) -> dict:
    """Per group: µs per call of each function (in turns) and the largest
    difference between the two trees' outputs."""
    res = {}
    with torch.no_grad():
        for group, (fns, bar) in _groups(other, seed).items():
            diff = _agree(fns, bar)
            us = {k: v * 1e3 for k, v in per_call_ms(fns).items()}
            res[group] = {"us": us, "max_diff": diff}
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of another checkout of the repository")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the launch path is timed on a card")
    other = load_other(args.other)
    with ThreadPoolExecutor(2) as pool:  # both trees' kernels at once
        list(pool.map(lambda b: b.build_libraries(LIBS),
                      (_build, other["_build"])))
    print(f"device: {torch.cuda.get_device_name(0)}; other tree "
          f"{Path(args.other).resolve()}")
    res = {"device": torch.cuda.get_device_name(0), "other": args.other,
           "bench": bench(other, args.seed)}
    for group, r in res["bench"].items():
        print(f"{group:12s} µs per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["us"].items())
            + f"; outputs differ by {r['max_diff']:.2e}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
