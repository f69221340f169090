"""Profiling and throughput helpers (torch counterpart of
`mirror_nerf_tpu/utils/profiling.py`).

`trace(logdir)` records `torch.profiler` activity (the CPU, and the CUDA
card when there is one) around a block and writes it as a Chrome trace
(`trace.json` in `logdir`, viewable in Perfetto or chrome://tracing), where
the JAX package writes a `jax.profiler` trace for TensorBoard.
`ThroughputMeter` is the JAX package's sliding-window rate meter with JSONL
dumps.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Capture a torch.profiler trace of the block into
    `logdir/trace.json`."""
    if not enabled:
        yield
        return
    import torch

    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ThroughputMeter:
    """Sliding-window rays/sec (or any unit/sec) counter with JSONL dumps."""

    def __init__(self, path: str = None, window: int = 50):
        self.path = path
        self.window = window
        self._events = []  # (t, n)

    def update(self, n: int) -> float:
        now = time.perf_counter()
        self._events.append((now, n))
        if len(self._events) > self.window:
            self._events = self._events[-self.window:]
        return self.rate()

    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        t0, _ = self._events[0]
        t1, _ = self._events[-1]
        total = sum(n for _, n in self._events[1:])
        return total / max(t1 - t0, 1e-9)

    def log(self, step: int, extra: dict = None):
        if not self.path:
            return
        rec = {"step": step, "rate": self.rate(), **(extra or {})}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
