"""Every file a cell is made of is found by name and loads; the benchmark and
its reference stay apart from JAX and the reference from the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from bench_helpers import CELLS, ROOT, SPEC

FORBIDDEN = ("jax", "jaxlib", "flax", "fedicra_tpu")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    from benchmark.run import driver, load_cell

    cell = load_cell(name)
    assert cell["config"]["name"] == cell["cell"]["config"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    for key in ("source", "widths", "precision", "reduced", "assumed"):
        assert key in cell["config"], key
    assert set(cell["config"]["reduced"]) <= set(cell["config"])
    assert {"allow_tf32", "autocast", "peak_flops", "control_mantissa_bits"} <= set(cell["precision"])
    drv = driver(cell["traffic"]["kind"])
    assert callable(drv.run) and callable(drv.compare)
    from benchmark.reference import models

    family = models.load(cell["config"]["model"])
    for name in ("param_specs", "port_kwargs", "forward", "convs", "is_head"):
        assert callable(getattr(family, name)), name
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    from benchmark.harness import readers

    reader = readers.load(metric)
    assert reader.UNIT == next(m["unit"] for m in SPEC["per_layer"] if m["name"] == metric)
    assert reader.read({}) is None


def test_spec_names_and_files():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        traffic = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        assert (ROOT / "benchmark" / "drivers" / f"{json.loads(traffic.read_text())['kind']}.py").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port_or_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"fedicra_torch", *FORBIDDEN}, tops


@pytest.mark.parametrize("path", ["drivers/local_rounds.py", "reference/fedicra_round.py", "harness/work.py"])
def test_harness_imports_no_model_family_by_name(path):
    """A model family is found by the configuration's ``model``: the round,
    its driver and the work count import none of them."""
    tree = ast.parse((ROOT / "benchmark" / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names |= {f"{node.module or ''}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
    families = {p.stem for p in (ROOT / "benchmark" / "reference" / "models").glob("*.py")} | {"unet_lc"}
    assert not any(part in families for n in names for part in n.split(".")), names


def test_run_modules_load_no_jax():
    """In a fresh process: import the run's modules, every driver, the
    reference and the port's modules the window drives, then compare whole
    top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.reference.fedicra_round\n"
        "[benchmark.run.driver(p.stem) for p in __import__('pathlib').Path(%r).glob('*.py')\n"
        " if p.stem != '__init__']\n"
        "from benchmark.reference import models\n"
        "[models.load(p.stem) for p in models.MODELS.glob('*.py') if p.stem != '__init__']\n"
        "import fedicra_torch.engine.trainer, fedicra_torch.models\n"
        "from benchmark.harness import env, readers\n"
        "[readers.load(m['name']) for m in __import__('json').load(open(%r))['per_layer']]\n"
        "print(env.forbidden_modules())\n"
        % (str(ROOT), str(ROOT / "benchmark" / "drivers"), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from benchmark.harness import env

    monkeypatch.setitem(sys.modules, "fedicra_tpu_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert env.forbidden_modules() == ["jaxlib.xla_client"]
