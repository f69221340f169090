"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `mirror_nerf_tpu_torch`, on a
machine with the cards the cell asks for. With `--trace 0` the result's
metrics are the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics (a profiled stretch follows the measured window). The last line of
standard output is the result as one JSON object; the numbers that decided
`correct`, each beside its limit, are the last lines of standard error and
the result's last key. Without the cards, or where JAX or the JAX package
got loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def _shares(cell, obs: dict, metrics: dict, card: str) -> None:
    """The 3×TF32 figure of the traced field work, then each share of a
    peak with the card's power limit beside it (standard error)."""
    from . import roof

    if "traced_work" in obs and "trace" in obs:
        fig = roof.tf32x3_seconds(obs["traced_work"][0])
        print(f"[figure] traced field work {obs['traced_work'][0]:.6e} "
              f"operations: {fig * 1e3:.3f} ms at 3×TF32 (495 TFLOP/s), "
              "the bring-up tables' bound", file=sys.stderr)
    for name, m in metrics.items():
        if m["unit"] == "%" and ("roofline" in name or "mfu" in name):
            print(f"[share] {name} {m['value']:.6f} % of 989 TFLOP/s / "
                  f"3.35 TB/s ({card})", file=sys.stderr)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, t_process: float = None) -> dict:
    """One run of cell `name` on `device` (the command's own device check
    is the caller's): the result object, `checks` last."""
    import torch

    from . import harness
    from . import trace as tr

    cell = harness.any_cell(name, overrides=overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv, ref = harness.driver(cell), harness.reference(cell)
    card = _card_line() if trace and device.type == "cuda" else ""
    obs = drv.run(cell, ref, seed, seconds, trace, device,
                  T_PROCESS if t_process is None else t_process)
    print("[run] " + ", ".join(
        f"{k} {obs[k]!r}" for k in ("views", "window_s", "steps", "live_shares",
                                    "ambiguous_share", "mirror_gain_shift",
                                    "setup_s")
        if k in obs), file=sys.stderr)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = harness.read_metrics(entries, obs)
    checks = obs["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": obs["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": obs["attempted"],
              "failed": obs["failed"], "metrics": metrics, "device": dev}
    if trace and obs.get("trace"):
        dev["busy_s"] = obs["trace"]["busy_s"]
        dev["window_s"] = obs["trace"]["span_s"]
        result["breakdown"] = tr.breakdown(obs["trace"])
        _shares(cell, obs, metrics, card)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opt = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import harness

    cell = harness.find_cell(opt.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[error] {opt.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(opt.workload, opt.seed, opt.seconds, bool(opt.trace),
                      torch.device("cuda", 0))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"[error] loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
