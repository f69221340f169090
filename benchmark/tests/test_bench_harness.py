"""The harness on the CPU: every cell, configuration, traffic mix and
metric is found by name; every per-layer metric's cells report the
end-to-end metric it moves; and a run with the timed path broken
underneath, or the control in the program's place, comes out not
correct."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import control, harness
from benchmark.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(SPEC["configs"]) + len(SPEC["workloads"]) == len(
        set(c["name"] for c in SPEC["configs"])) + len(set(CELLS))
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert (ROOT / "benchmark" / "run.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.find_cell(cell)
    assert harness.driver(c).run and harness.reference(c).Field
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert m["workloads"], "a per-layer metric lists its cells"
    e2e = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert harness.reports(e2e, cell)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert data["precision"] == "float32" and "assumed" in data
    assert conf["file"].startswith("benchmark/configs/")


def test_split_metric_takes_its_prefix_reader():
    assert harness.reader("render_rays_per_s.flagship")(
        {"kind": "views", "rays_done": 300.0, "window_s": 2.0}) == 150.0
    assert harness.reports({"name": "setup_s"}, CELLS[0])


@pytest.mark.parametrize("kind,metric", [("train", "idle_share.train"),
                                         ("views", "idle_share.view")])
def test_idle_share_against_the_untraced_window(kind, metric):
    unit = {"train": "steps", "views": "views"}[kind]
    obs = {"kind": kind, "trace": {"busy_s": 0.5}, f"traced_{unit}": 5,
           "window_s": 12.0, unit: 100}
    assert harness.reader(metric)(obs) == pytest.approx(
        100.0 * (1.0 - 0.1 / 0.12))


def test_readers_find_nothing_in_an_empty_run():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert harness.reader(m["name"])({"kind": "none"}) is None


SMALL_VIEW = {"view_wh": [16, 12], "check_rays_per_view": 192,
              "traced_views": 1}


def _train_overrides():
    flags = list(harness.find_cell("flagship.train.reflect")
                 .config["train_flags"])
    for k, v in (("--batch_size", "64"), ("--N_importance", "8"),
                 ("--novel_ray_batch", "32")):
        flags[flags.index(k) + 1] = v
    return {"train_flags": flags + ["--N_samples", "8"], "view_wh": [8, 8],
            "trace_schedule": [1, 1, 2]}


def _run(cell, overrides, trace=False, seed=2**33 + 17):
    return run_cell(cell, seed, 0.0, trace, CPU, overrides=overrides,
                    t_process=time.perf_counter())


@pytest.mark.parametrize("cell", ["flagship.view.mirror",
                                  "hashgrid.view.clear"])
def test_view_run_on_the_cpu(cell):
    """Also the hash grid under the no-mirror calibration of
    `traffic/view.clear.json` (a cell measured and left out; PERF.md)."""
    r = _run(cell, SMALL_VIEW, trace=True)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("rows", [None, 1])
def test_view_answer_altered_is_not_correct(monkeypatch, rows):
    """Every ray's colour altered where it is produced, or only the first
    ray's of each chunk: a fault that the widest gaps see."""
    from mirror_nerf_tpu_torch.eval import apps

    real = apps.render_chunk

    def altered(ctx, rays, *a, **k):
        res = real(ctx, rays, *a, **k)
        rgb = res["rgb_fine"] + 0.0
        rgb[:rows] += 0.01
        res["rgb_fine"] = rgb
        return res

    monkeypatch.setattr(apps, "render_chunk", altered)
    r = _run("flagship.view.mirror", SMALL_VIEW)
    assert not r["correct"]
    widest = ("rgb_gap", "reflect_rgb_max")
    assert any(r["checks"][k]["value"] > r["checks"][k]["limit"]
               for k in widest)
    if rows is None:
        for k in widest + ("reflect_rgb_gap", "reflect_rgb_p99"):
            assert r["checks"][k]["value"] > r["checks"][k]["limit"]


def test_train_run_on_the_cpu():
    r = _run("flagship.train.reflect", _train_overrides(), trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["mfu.train"]["value"] > 0


def test_train_state_unchanged_is_not_correct(monkeypatch):
    from mirror_nerf_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, step: None)
    r = _run("flagship.train.reflect", _train_overrides())
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert r["checks"]["change_gap_leaf"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    from mirror_nerf_tpu_torch.train import loop

    real = loop.Trainer.loss_and_aux

    def half(self, statics, batch):
        n = batch["rays"].shape[0] // 2
        return real(self, statics, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(loop.Trainer, "loss_and_aux", half)
    r = _run("flagship.train.reflect", _train_overrides())
    assert not r["correct"]


@pytest.mark.parametrize("cell", ["flagship.view.mirror",
                                  "hashgrid.view.mirror"])
def test_view_control_is_not_correct(cell):
    checks, _ = control.view_control(cell, 2**33 + 3, 2, CPU,
                                     overrides=SMALL_VIEW)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", ["tf32", "half_batch"])
def test_train_control_is_not_correct(fault):
    checks, _ = control.train_control("flagship.train.reflect", 2**33 + 3,
                                      fault, CPU,
                                      overrides=_train_overrides())
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_capacity_witness_on_the_cpu():
    from benchmark import capacity_witness

    (row,) = capacity_witness.witness("hashgrid", 2**33 + 5, 1, (16, 12),
                                      64, CPU)
    assert row["rays"] == 192 and row["full_dropped"] == 0
    assert row["rgb_gap_full_all"][0] < 1e-4


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", cell, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
