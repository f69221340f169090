"""What `run.py` finds by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic (`traffic/<traffic>.json`,
whose `driver` names the general generator under `drivers/`), and every
metric it reports (`metrics/<metric>.py`, each a `read(obs)` that returns a
number, or None where it finds nothing to read; a metric split by
configuration, such as `render_rays_per_s.flagship`, is read by the file of
its longest dotted prefix that has one). Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mirror_nerf_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    overrides: dict = field(default_factory=dict)

    def get(self, key: str):
        """A traffic key, else a configuration key (a test may override)."""
        for src in (self.overrides, self.traffic, self.config):
            if key in src:
                return src[key]
        raise KeyError(key)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`; an
    end-to-end metric without the key, such as `setup_s`, in every cell."""
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, spec: dict = None, overrides: dict = None) -> Cell:
    spec = spec or load_spec()
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if reports(m, name)]
    return Cell(name=name, chips=w["chips"], config=_json(ROOT / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                overrides=dict(overrides or {}))


def any_cell(name: str, overrides: dict = None) -> Cell:
    """`find_cell`, or, for a `<config>.<traffic>` pair that no cell of
    BENCHMARK.json lists, the cell that its two files make (with no
    metrics): the controls, the capacity witness and the tests reach a
    configuration or a mix that no cell measures yet."""
    spec = load_spec()
    if all(w["name"] != name for w in spec["workloads"]):
        config, traffic = name.split(".", 1)
        spec["configs"].append(
            {"name": config, "file": f"benchmark/configs/{config}.json"})
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1})
    return find_cell(name, spec, overrides)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def reference(cell: Cell):
    return importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")


def reader(metric_name: str):
    """The `read(obs)` of `metrics/<metric_name>.py`, else of the file of
    its longest dotted prefix."""
    stem = metric_name
    while not (HERE / "metrics" / f"{stem}.py").exists() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, obs: dict) -> dict:
    """{name: {"value", "unit"}} of the entries whose reader found
    something."""
    out = {}
    for m in entries:
        v = reader(m["name"])(obs)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
