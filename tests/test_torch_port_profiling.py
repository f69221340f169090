"""Port parity, `utils/profiling.py`: `trace` writes a Chrome trace of the
block (CPU ops here; the card's kernels too where there is one, which
chip_smoke.py checks), does nothing when disabled, and `ThroughputMeter`
counts and logs as the JAX package's does."""

import json
import time

import pytest
import torch

from mirror_nerf_tpu.utils.profiling import ThroughputMeter as JaxMeter
from mirror_nerf_tpu_torch.utils.profiling import ThroughputMeter, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.load(open(tmp_path / "prof" / "trace.json"))
    names = [e.get("name", "") for e in data["traceEvents"]]
    assert any("aten::mm" in n or "aten::matmul" in n for n in names)


def test_trace_disabled_writes_nothing(tmp_path):
    with trace(str(tmp_path / "off"), enabled=False):
        torch.ones(3) + 1
    assert not (tmp_path / "off").exists()


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path / "err")):
            torch.ones(3) * 2
            raise RuntimeError("boom")
    assert (tmp_path / "err" / "trace.json").exists()


def test_throughput_meter_matches_jax(tmp_path, monkeypatch):
    """The same clock readings give the same rates and log lines."""
    clock = iter([0.0, 0.5, 1.0, 1.5, 2.0] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    paths = (tmp_path / "port.jsonl", tmp_path / "jax.jsonl")
    meters = (ThroughputMeter(str(paths[0]), window=3),
              JaxMeter(str(paths[1]), window=3))
    rates = []
    for m in meters:
        assert m.rate() == 0.0
        rates.append([m.update(n) for n in (10, 20, 30, 40, 50)])
        m.log(7, {"loss": 1.5})
    assert rates[0] == rates[1]
    assert rates[0][-1] == pytest.approx((40 + 50) / 1.0)
    assert paths[0].read_text() == paths[1].read_text()
    assert ThroughputMeter().log(1) is None  # no path: nothing written
