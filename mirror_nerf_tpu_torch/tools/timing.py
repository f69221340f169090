"""Timing on the card for the probes: CUDA events over back-to-back calls,
and each call's device time from a torch.profiler trace."""

from __future__ import annotations

import json
import os
import tempfile

import torch


def time_ms(fn, reps: int = 20) -> float:
    """ms per call: CUDA events around `reps` back-to-back calls after a warm
    one. Once a kernel takes a few µs this is the host's launch rate."""
    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_call_ms(fns: dict, reps: int = 200, rounds: int = 5) -> dict:
    """ms per call of each of `fns` (name -> callable), measured in turns so
    that a slow spell of the shared host hits them alike: `rounds` rounds,
    each timing every function over `reps` back-to-back calls with CUDA
    events (in reverse order every other round), after a warm call each;
    the best round of each. At a few µs of device time a call this is the
    host's cost of a call."""
    for fn in fns.values():
        fn()
    best = {name: float("inf") for name in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = fns[name]
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            best[name] = min(best[name], start.elapsed_time(end) / reps)
    return best


def _traced_kernels(fn, reps: int) -> tuple:
    """The kernel events of two torch.profiler traces of `reps` calls each,
    after a warm call: (the first trace's, the second's). The device's
    activity is recorded only some time after the profiler starts: in a
    long process (chip_smoke.py's phase 15 on an H100) a trace of 20 short
    calls started cold held 17 of their 20 kernels, or none. So each trace
    is one pass of calls after a pass in the profiler's own warm-up (two
    cycles of the schedule); the first counts how many kernels a call
    launches, the second is the one timed."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traces = []

    def keep(prof):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                traces.append([e for e in json.load(f)["traceEvents"]
                               if e.get("ph") == "X"
                               and e.get("cat") == "kernel"])

    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=2)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=keep) as prof:
        for _ in range(4):  # warm-up, count; warm-up, time
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    if len(traces) != 2:
        raise RuntimeError(f"the profiler gave {len(traces)} traces of the "
                           "two it was asked for")
    return traces[0], traces[1]


TRACE_TRIES = 3  # pairs of traces `device_ms` takes before it gives up


def device_ms(fn, reps: int = 20, exclude: str = None) -> float:
    """Device time per call: the summed kernel durations of a torch.profiler
    trace of `reps` calls, over reps. With `exclude`, kernels named like it
    (a cache flush before each call) are left out, `fn` must launch one
    kernel, and the time is that kernel's mean duration in the trace.

    A trace may lose kernels (chip_smoke.py phase 15 on an H100: 7 of 20
    after a warm-up pass, or all of a first trace), which would read low:
    a call's kernels are counted in the first of two traces (the larger
    count of the two), and the timed trace must hold `reps` times that.
    Up to TRACE_TRIES pairs of traces are taken; when none is whole (or
    every first trace held no kernel), raises."""
    for _ in range(TRACE_TRIES):
        warm, kernels = _traced_kernels(fn, reps)
        per_call = max(-(-len(warm) // reps), -(-len(kernels) // reps))
        if warm and len(kernels) >= reps * per_call:
            break
    else:
        if not warm:
            raise RuntimeError(f"the warm-up pass of {reps} calls held no "
                               f"kernel event, in each of {TRACE_TRIES} "
                               "tries")
        raise RuntimeError(
            f"a profiler trace of {reps} calls held {len(kernels)} kernel "
            f"events, where a call launched {per_call}, in each of "
            f"{TRACE_TRIES} tries: the trace lost kernels")
    if exclude is None:
        return sum(e["dur"] for e in kernels) / reps / 1e3
    kept = [e for e in kernels if exclude not in e.get("name", "")]
    names = {e.get("name", "") for e in kept}
    assert len(kept) < len(kernels) and len(names) == 1, (
        f"want one kernel besides those named like {exclude!r}, got "
        f"{sorted(n[:80] for n in names)} and {len(kernels) - len(kept)} "
        "left out")
    return sum(e["dur"] for e in kept) / len(kept) / 1e3


def l2_flush(device):
    """A call that evicts the 50 MB L2 cache: one fill of 64 MiB (its kernel
    is named like `FLUSH_KERNEL`; a fill with 0 may be a memset instead),
    for timing a kernel on cold inputs."""
    buf = torch.empty(2 ** 24, dtype=torch.float32, device=device)
    return lambda: buf.fill_(1.0)


FLUSH_KERNEL = "FillFunctor"
