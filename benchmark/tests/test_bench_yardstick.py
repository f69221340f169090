"""The benchmark's frozen counts and trace reductions against the port's
tools they were copied from, and the roof's bound on every share."""

import random
import sys
from pathlib import Path

import pytest

from benchmark import roof
from benchmark import trace as tr

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(ROOT / "tools"))
    import profile_train_torch
    import profile_view_torch

    return profile_view_torch, profile_train_torch


def test_mlp_macs_match(smoke):
    assert roof.MLP_MACS == smoke.MLP_MACS


@pytest.mark.parametrize("sum_r", [0, 64, 192, 384])
@pytest.mark.parametrize("full", [False, True])
def test_cp_flop_matches(smoke, sum_r, full):
    assert roof.cp_flop(sum_r, full) == smoke._cp_flop(sum_r, full)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_hash_flop_matches(smoke, c):
    assert roof.hash_flop(c) == smoke._hash_flop(c)


def test_mlp_macs_from_widths():
    """The flagship's multiply-adds a sample from its layer widths."""
    w, pe, de = 256, 63, 27
    trunk = pe * w + 6 * w * w + (w + pe) * w
    sigma_only = trunk + w
    full = (sigma_only + w * w + (w + de) * (w // 2) + (w // 2) * 3
            + w * (w // 2) + (w // 2) * 3 + w * (w // 2) + (w // 2))
    assert roof.MLP_MACS == {True: sigma_only, False: full}


@pytest.mark.parametrize("flop,nbytes", [(1e12, 1e6), (1e6, 1e12),
                                         (989e12, 3.35e12), (0.0, 1.0)])
def test_share_at_the_roof_is_100(flop, nbytes):
    least = roof.least_seconds(flop, nbytes)
    assert roof.share_percent(flop, nbytes, least) == pytest.approx(100.0)
    for slower in (1.0001, 2.0, 1e3):
        assert roof.share_percent(flop, nbytes, least * slower) < 100.0


def test_share_without_time_is_none():
    assert roof.share_percent(1.0, 1.0, 0.0) is None


def test_tf32x3_figure_is_slower_than_the_roof():
    flop = 1e15
    assert roof.tf32x3_seconds(flop) > roof.least_seconds(flop, 0.0)


@pytest.mark.parametrize("seed", range(5))
def test_busy_union_matches_the_tool(tools, seed):
    view_tool, _ = tools
    rnd = random.Random(seed)
    ivs = []
    for _ in range(200):
        s = rnd.uniform(0, 1000)
        ivs.append((s, s + rnd.uniform(0, 20)))
    assert tr.busy_union(ivs) == pytest.approx(view_tool.busy_union(ivs))


def _synthetic_trace(seed: int):
    rnd = random.Random(seed)
    events, t = [], 0.0
    for k in range(50):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "train_step", "ts": t, "dur": 900.0})
        for j in range(10):
            events.append({"ph": "X", "cat": "cpu_op", "name": f"aten::op{j}",
                           "ts": t + 80.0 * j, "dur": 50.0})
            events.append({"ph": "X", "cat": "kernel", "name": f"k{j % 3}",
                           "ts": t + 80.0 * j + rnd.uniform(5, 30),
                           "dur": rnd.uniform(10, 60)})
        t += 1000.0
    return events


@pytest.mark.parametrize("seed", range(3))
def test_reduce_matches_step_breakdown(tools, seed):
    _, train_tool = tools
    events = _synthetic_trace(seed)
    ours = tr.reduce(events, ("train_step",), "between_steps")
    theirs = train_tool.step_breakdown(events, 50)
    assert ours["span_s"] * 1e3 == pytest.approx(theirs["span_ms"])
    assert ours["busy_s"] * 1e3 == pytest.approx(theirs["busy_ms"])
    assert ours["idle_share"] == pytest.approx(theirs["idle_share"])
    assert ours["device_s"] * 1e3 / 50 == pytest.approx(
        theirs["device_ms_per_step"])
    assert ours["device_events"] / 50 == theirs["events_per_step"]
    idle = sum(ours["idle_by_label"].values())
    assert idle == pytest.approx(ours["span_s"] - ours["busy_s"])


def test_breakdown_keeps_ten_of_each():
    red = tr.reduce(_synthetic_trace(0), ("train_step",), "between_steps")
    b = tr.breakdown(red)
    assert 0 < len(b["device_ops"]) <= tr.TOP
    assert 0 < len(b["idle_gaps"]) <= tr.TOP
    assert all(s > 0 for _, s in b["device_ops"])
