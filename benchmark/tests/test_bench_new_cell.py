"""A cell of another model family joins the benchmark from new files and
appended ``BENCHMARK.json`` entries alone: in a copy of the benchmark, the
plain ``unet`` of ``bench_helpers.plain_unet_cell`` (pCE under FedAvg, on
ODOC's task) is added as a cell, and the benchmark's tests selected for it
pass there with no file of the copy edited."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

from bench_helpers import copy_with_cell, plain_unet_cell

CELL, CONFIG, METRIC = "odoc.unet.local_rounds", "odoc_unet_pce_fedavg_fp32", "full_step_ms.train"
READER = '''"""Round layer: the median step of a one-phase round in the window (ms),
timed by the benchmark's host clock between synchronised ``on_step`` calls."""

import statistics

UNIT = "ms"


def read(record):
    steps = record.get("step_s", {}).get("full")
    return statistics.median(steps) * 1e3 if steps else None
'''


def test_a_cell_of_another_family_joins_by_new_files_alone(tmp_path):
    cell = plain_unet_cell()
    cell["config"]["name"] = CONFIG
    cell["cell"].update(name=CELL, config=CONFIG)
    metric = {"name": METRIC, "unit": "ms", "better": "lower", "source": "host_clock", "layer": "Round",
              "moves": "train_img_per_s"}
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONDONTWRITEBYTECODE": "1"}
    tree = tmp_path / "tree"
    tree.mkdir()
    before = copy_with_cell(tree, cell, metric, READER, env)

    report = tmp_path / "inner.xml"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-k", f"({CELL} or {CONFIG} or {METRIC}) and not test_a_cell_of_another_family", f"--junitxml={report}"],
        cwd=tree, env=env, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    cases = ET.parse(report).getroot().iter("testcase")
    outcomes = {(c.get("classname").split(".")[-1], c.get("name")): [e.tag for e in c] for c in cases}
    assert all(not tags for tags in outcomes.values()), outcomes
    assert {"test_bench_correct", "test_bench_layout", "test_bench_work"} <= {f for f, _ in outcomes}, outcomes
    names = {n for _, n in outcomes}
    assert {f"test_cell_files_load[{CELL}]", f"test_cell_reads_as_pinned[{CELL}]",
            f"test_port_is_correct_at_a_small_size[{CELL}]", f"test_control_is_not_correct[{CELL}]",
            f"test_metric_reader_loads_and_reads_nothing_from_nothing[{METRIC}]"} <= names, names

    changed = [rel for rel, data in before.items()
               if rel != "BENCHMARK.json" and (tree / rel).read_bytes() != data]
    assert not changed, changed
    old, new = json.loads(before["BENCHMARK.json"]), json.loads((tree / "BENCHMARK.json").read_text())
    assert new.keys() == old.keys()
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][:len(value)] == value, key
        else:
            assert new[key] == value, key
    assert [len(new[k]) - len(old[k]) for k in ("configs", "workloads", "per_layer")] == [1, 1, 1]
