"""Shared pieces of the benchmark's CPU tests: the cells as ``run.load_cell``
gives them, cut to a size a CPU test can hold, and cells that exist only
in the tests."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def plain_unet_cell() -> dict:
    """The reference's pCE baseline under FedAvg: the plain ``unet`` at its
    published widths, partial CE alone, one full phase of 10 steps, on
    ODOC's task. Its limits lie between the CPU's readings at 32^2, batch 2,
    over 6 seeds: the port against the reference (loss <= 2.2e-7, grad <=
    3.4e-5, change <= 5.5e-2) and the TF32 control (grad >= 3.0e-2; its loss
    reads 2.1e-7 to 8.2e-5), half the batch (loss >= 1.5e-3, grad >= 0.80)
    and a state left unchanged (change 1)."""
    from benchmark.run import load_cell

    cell = copy.deepcopy(load_cell(CELLS[0]))
    config = cell["config"]
    config.update(name="test_unet_pce_fedavg", model="unet",
                  widths={"features": [16, 32, 64, 128, 256], "dropout": [0.05, 0.1, 0.2, 0.3, 0.5]})
    config["train"].update(procedure="pce", strategy="FedAvg")
    cell["cell"] = {"name": "test.unet_pce_fedavg", "config": config["name"], "traffic": "local_rounds",
                    "chips": 1}
    cell["limits"] = {"loss": 2.0e-6, "grad": 1.0e-3, "change": 0.3}
    return cell


# cells built here, not in BENCHMARK.json: a model family the harness has to
# take from its reference module alone
TEST_CELLS = {"test.unet_pce_fedavg": plain_unet_cell}


def copy_with_cell(dest: Path, cell: dict, metric: dict, reader: str, env: Dict[str, str]) -> Dict[str, bytes]:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` into ``dest`` beside a link
    to the port, then add ``cell`` (as ``plain_unet_cell`` gives it) to the
    copy by new files and appended entries alone: its configuration, its
    limits, the per-layer metric ``metric`` (a ``per_layer`` entry without
    ``workloads``) with its reader's source ``reader``, and its pins, written
    by ``tools/pins.py`` in the copy under ``env``. Returns the bytes of every
    file the copy held before the addition, by path relative to ``dest``."""
    shutil.copy2(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "fedicra_torch").symlink_to(ROOT / "fedicra_torch", target_is_directory=True)
    before = {p.relative_to(dest).as_posix(): p.read_bytes()
              for p in [dest / "BENCHMARK.json", *sorted((dest / "benchmark").rglob("*"))] if p.is_file()}

    config, name = cell["config"], cell["cell"]["name"]
    t, task = config["train"], config["task"]
    why = f"the {config['model']} family on {task['img_class']}'s task, {t['procedure']} under {t['strategy']}"
    new_files = {f"benchmark/configs/{config['name']}.json": json.dumps(config, indent=1) + "\n",
                 f"benchmark/limits/{name}.json": json.dumps({"limits": cell["limits"]}, indent=1) + "\n",
                 f"benchmark/metrics/{metric['name']}.py": reader}
    for rel, text in new_files.items():
        (dest / rel).write_text(text)
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config["name"], "source": config["source"],
                            "file": f"benchmark/configs/{config['name']}.json",
                            "reduced": config["reduced"], "why": why})
    spec["workloads"].append({**cell["cell"], "why": why})
    spec["per_layer"].append({**metric, "workloads": [name]})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1) + "\n")
    subprocess.run([sys.executable, "benchmark/tools/pins.py", "--workload", name], cwd=dest, env=env,
                   check=True, capture_output=True)
    return before


def small_cell(name: str, img: int = 32, batch: int = 2) -> dict:
    """The cell ``name`` (of ``BENCHMARK.json`` or ``TEST_CELLS``) with its
    images cut to ``img``^2 and its batch to ``batch``."""
    from benchmark.run import load_cell

    cell = TEST_CELLS[name]() if name in TEST_CELLS else copy.deepcopy(load_cell(name))
    cell["config"]["task"]["img_size"] = img
    cell["config"]["train"]["batch_size"] = batch
    return cell
