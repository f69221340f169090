"""Profiler traces reduced to what the per-layer metrics read: the device's
busy time (the union of its kernel, copy and set intervals), the traced
span, device time by operation, and the idle gaps labelled by what the host
was doing.

`busy_union` and the device / host event split are frozen copies of the
port's profiling tools (`tools/profile_view_torch.py`,
`tools/profile_train_torch.py step_breakdown`).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
TOP = 10


def _merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    return sum(e - s for s, e in _merged(intervals))


def export_events(prof) -> list:
    """A finished `torch.profiler.profile`'s complete ("X") events."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _label_at(t: float, spans: list, ops: list, op_starts: list,
              default: str) -> str:
    """The benchmark span around time t (`default` outside them), and the
    innermost host operation running then (the shortest of the last ones
    started before t that still run)."""
    span = next((name for s, e, name in spans if s <= t <= e), default)
    i = bisect.bisect_right(op_starts, t)
    best = None
    for s, e, name in ops[max(0, i - 64):i]:
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return f"{span}/{best[2]}" if best else span


def reduce(events: list, span_names: tuple, default: str = "outside") -> dict:
    """A trace → span_s, busy_s, idle share, device seconds and calls by
    operation, device events, and idle seconds by label. Times in s."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not dev:
        return {}
    lo = min(e["ts"] for e in dev + host)
    hi = max(e["ts"] + e["dur"] for e in dev + host)
    busy = _merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"][:96]][0] += 1
        by_name[e["name"][:96]][1] += e["dur"] / 1e6
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
             if e.get("cat") == "user_annotation"
             and e["name"] in span_names]
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                 if e.get("cat") == "cpu_op")
    op_starts = [s for s, _, _ in ops]
    idle = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            idle[_label_at(s, spans, ops, op_starts, default)] += (
                e - s) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6  # busy_union's
    span_s = (hi - lo) / 1e6
    return {"span_s": span_s, "busy_s": busy_s,
            "idle_share": 1.0 - busy_s / span_s,
            "device_events": len(dev),
            "device_s": sum(v[1] for v in by_name.values()),
            "by_name": dict(by_name), "idle_by_label": dict(idle)}


def kernel_seconds(reduced: dict, keys) -> float:
    """Device seconds of the operations whose name holds one of `keys`."""
    return sum(s for name, (_, s) in reduced.get("by_name", {}).items()
               if any(k in name for k in keys))


def breakdown(reduced: dict) -> dict:
    """The top device operations by time and the longest idle stretches by
    label, at most TOP each."""
    ops = sorted(((n, s) for n, (_, s) in reduced["by_name"].items()),
                 key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(reduced["idle_by_label"].items(),
                  key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
