"""Nothing a benchmark run loads is JAX or the JAX package, and the plain
reference loads nothing of the program under test. Each check runs in a
fresh interpreter, so that what this test process loaded does not count."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import importlib, json, sys
from benchmark import capacity_witness, control, harness, roof, run, trace
from benchmark.drivers import train, views
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.find_cell(w["name"])
    harness.driver(cell), harness.reference(cell)
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
for mod in ("mirror_nerf_tpu_torch.eval.apps", "mirror_nerf_tpu_torch.eval.cli",
            "mirror_nerf_tpu_torch.models.fields",
            "mirror_nerf_tpu_torch.train.cli", "mirror_nerf_tpu_torch.train.loop",
            "mirror_nerf_tpu_torch.ops.fused_mlp_t",
            "mirror_nerf_tpu_torch.ops.fused_hash"):
    importlib.import_module(mod)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
from benchmark.reference import common, flagship, hashgrid, train, weights
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods) -> set:
    return {m.split(".")[0] for m in mods}


def test_harness_and_cells_load_no_jax():
    tops = _tops(_loaded(HARNESS))
    assert "mirror_nerf_tpu_torch" in tops  # the cells' modules did load
    assert not tops & {"jax", "jaxlib", "flax", "mirror_nerf_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = _tops(_loaded(REFERENCE))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mirror_nerf_tpu",
                       "mirror_nerf_tpu_torch"}


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("mirror_nerf_tpu", True),
    ("mirror_nerf_tpu.ops", True), ("mirror_nerf_tpu_torch", False),
    ("mirror_nerf_tpu_torch.ops", False), ("jaxtyping", False)])
def test_forbidden_compares_whole_top_level_names(name, found):
    from benchmark import harness

    assert bool(harness.forbidden_modules([name])) == found
