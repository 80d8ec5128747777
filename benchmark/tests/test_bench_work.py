"""The work counts and the trace arithmetic, on known inputs.

Each cell's pins, ``pins/<cell>.json``, written by
``python3 benchmark/tools/pins.py --workload <cell>``: the reference's
readings of client 0's first round (seed 2**31 + 977, 32^2, batch 2, 2 CPU
threads), each float as its hex: the losses, each leaf's gradient norm at
each phase's first step, and each leaf's change; and ``work.step_flops`` at
the cell's own size. A change to the reference or the work count that moves
them rewrites the cell's file and says why; so does a PyTorch or BLAS update
that moves a bit.
"""

from __future__ import annotations

import functools
import json

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import CELLS, ROOT, SPEC, TEST_CELLS, small_cell
from benchmark.harness import inputs, trace, work
from benchmark.reference import models
from benchmark.reference.fedicra_round import contrast_forwards, phases
from benchmark.tools import pins

CONFIG_CELLS = {w["config"]: w["name"] for w in SPEC["workloads"]}
# the configurations of the family whose ``convs`` the LC FLOP test holds
LC_CONFIGS = [c for c, w in CONFIG_CELLS.items() if small_cell(w)["config"]["model"] == "unet_lc_multihead"]
# the published widths, and a narrower model with two heads
NARROW = {"features": [8, 16, 32, 48, 64], "pcs_stages": 1, "dsn_heads": 2, "dsn_hidden": 40,
          "dropout": [0.0] * 5, "dsn_dropout": 0.0}
MODULES = sorted(p.stem for p in (ROOT / "benchmark" / "reference" / "models").glob("*.py")
                 if p.stem != "__init__")
# a cell of each model module: the benchmark's, then those the tests build
MODULE_CELLS = {}
for _name in CELLS + list(TEST_CELLS):
    MODULE_CELLS.setdefault(small_cell(_name)["config"]["model"], _name)


def lc_config(in_chns, classes, clients, img, config):
    """An ``unet_lc_multihead`` configuration at these sizes and widths."""
    cfg = small_cell(CELLS[0])["config"]
    cfg["widths"] = NARROW if config == "narrow" else small_cell(CONFIG_CELLS[config])["config"]["widths"]
    cfg["task"].update(in_chns=in_chns, num_classes=classes, num_clients=clients, img_size=img)
    return cfg


def counted_forward(model, config, batch=2):
    params = inputs.draw_weights(model.param_specs(config), 1, "cpu")
    task = config["task"]
    images = torch.rand(batch, task["img_size"], task["img_size"], task["in_chns"])
    with FlopCounterMode(display=False) as counter:
        model.forward(config, params, images, torch.zeros(batch, dtype=torch.long), None)
    return counter.get_total_flops()


@pytest.mark.parametrize("in_chns,classes,clients,img,config",
                         [(3, 3, 5, 32, c) for c in LC_CONFIGS]
                         + [(1, 2, 5, 32, "narrow"), (3, 2, 4, 48, "narrow")])
def test_forward_flops_match_flop_counter(in_chns, classes, clients, img, config):
    cfg = lc_config(in_chns, classes, clients, img, config)
    model = models.load("unet_lc_multihead")
    assert counted_forward(model, cfg) == 2 * work.forward_flops(model, cfg)


def test_every_model_module_has_a_cell():
    assert MODULES and set(MODULES) <= set(MODULE_CELLS), (MODULES, MODULE_CELLS)


@pytest.mark.parametrize("module", MODULES)
def test_model_module_convs_match_flop_counter(module):
    """Each module's ``convs`` against FlopCounterMode on its own forward."""
    config = small_cell(MODULE_CELLS[module])["config"]
    model = models.load(module)
    assert counted_forward(model, config) == 2 * work.forward_flops(model, config)


@pytest.mark.parametrize("module", MODULES)
def test_step_flops_match_flop_counter(module):
    """Each phase's step: the own forward, its backward to the phase's live
    leaves and the contrast forwards, as FlopCounterMode counts them."""
    config = small_cell(MODULE_CELLS[module])["config"]
    model = models.load(module)
    task, batch = config["task"], config["train"]["batch_size"]
    counts = work.step_flops(model, config)
    images = torch.rand(batch, task["img_size"], task["img_size"], task["in_chns"])
    client = torch.zeros(batch, dtype=torch.long)
    specs = model.param_specs(config)
    for label, live, _, _ in phases(model, config, [n for n, _, _ in specs]):
        params = inputs.draw_weights(specs, 1, "cpu")
        for n in live:
            params[n].requires_grad_(True)
        with FlopCounterMode(display=False) as counter:
            out = model.forward(config, params, images, client, None)
            loss = out["logits"].sum() + sum(a.sum() for a in out.get("aux", []))
            torch.autograd.grad(loss, [params[n] for n in live], allow_unused=True)
            with torch.no_grad():
                for _ in range(contrast_forwards(model, config)):
                    model.forward(config, params, images, client, None)
        assert counter.get_total_flops() == counts[label], label


@pytest.mark.parametrize("groups", [1, 2, 12])
def test_grouped_conv_flops_match_flop_counter(groups):
    x, w = torch.rand(2, 12, 10, 10), torch.rand(24, 12 // groups, 5, 5)
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x, w, padding=2, groups=groups)
    assert counter.get_total_flops() == 2 * work.conv_flops(12, 24, 5, 100, groups)


def test_step_flops_at_odoc():
    config = small_cell("odoc.local_rounds", img=384, batch=12)["config"]
    model = models.load(config["model"])
    fwd = work.forward_flops(model, config)
    assert round(fwd / 1e9, 1) == 52.0
    steps = work.step_flops(model, config)
    assert steps["head"] > 5 * 12 * fwd and steps["body"] < 7 * 12 * fwd


def pin_file(name):
    """The cell's pin file, or a failure naming where it belongs and how it
    is written."""
    path = pins.path(name)
    if not path.is_file():
        pytest.fail(f"no pins for cell {name!r} at {path}; write them with "
                    f"python3 benchmark/tools/pins.py --workload {name}", pytrace=False)
    return json.loads(path.read_text())


@functools.lru_cache(maxsize=None)
def readings(name):
    return pins.readings(name)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reads_as_pinned(name):
    """The reference's readings at 32^2, bit for bit, and the step FLOPs at
    the cell's own size, to the FLOP, as ``pins/<cell>.json`` holds them."""
    pinned = pin_file(name)
    hexes = readings(name)
    moved = [f"loss {j}: {float.fromhex(a)!r} != {float.fromhex(b)!r}"
             for j, (a, b) in enumerate(zip(hexes["losses"], pinned["losses"])) if a != b]
    for key, got, want in [*((f"grad {j}", g, pinned["grads"].get(j, {}))
                             for j, g in hexes["grads"].items()),
                           ("change", hexes["change"], pinned["change"])]:
        moved += [f"{key} {leaf}: {float.fromhex(got[leaf])!r} != {float.fromhex(want[leaf])!r}"
                  for leaf in sorted(got.keys() & want.keys()) if got[leaf] != want[leaf]]
        moved += [f"{key} {leaf}: only on one side" for leaf in sorted(got.keys() ^ want.keys())]
    assert len(hexes["losses"]) == len(pinned["losses"]) and hexes["grads"].keys() == pinned["grads"].keys()
    assert not moved, "readings moved from the pinned ones:\n" + "\n".join(moved)
    assert hexes["step_flops"] == pinned["step_flops"]


@pytest.mark.parametrize("name", CELLS)
def test_pins_tool_writes_each_pin_file(name):
    """``tools/pins.py`` writes the cell's file as it stands, byte for byte."""
    assert pins.render(readings(name)) == pins.path(name).read_text()


def test_a_cell_without_pins_fails_naming_the_path(tmp_path, monkeypatch):
    monkeypatch.setattr(pins, "PINS", tmp_path)
    with pytest.raises(pytest.fail.Exception) as failed:
        test_cell_reads_as_pinned(CELLS[0])
    assert str(tmp_path / f"{CELLS[0]}.json") in str(failed.value)
    assert f"python3 benchmark/tools/pins.py --workload {CELLS[0]}" in str(failed.value)


def test_a_missing_model_module_is_refused_with_its_path():
    with pytest.raises(FileNotFoundError, match=r"reference/models/no_such_model\.py"):
        models.load("no_such_model")


def test_idle_share_and_breakdown_of_a_synthetic_trace():
    device = [("implicit_gemm_conv", 0.0, 40.0), ("elementwise_kernel", 30.0, 50.0),
              ("tree_pass_kernel", 70.0, 90.0), ("bench.client1.step0", 0.0, 100.0)]
    host = [("bench.client1.round", 0.0, 100.0), ("bench.client1.step0", 0.0, 65.0),
            ("bench.client1.step1", 65.0, 100.0), ("aten::item", 52.0, 68.0)]
    s = trace.summarise(device, host, (0.0, 100.0))
    assert s["busy_s"] == pytest.approx(70e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["by_family"] == pytest.approx({"conv": 40e-6, "elementwise": 20e-6, "tree_kernels": 20e-6})
    assert s["breakdown"]["idle_gaps"][0] == ["bench.client1.step0 | aten::item", pytest.approx(20e-6)]
    assert s["breakdown"]["idle_gaps"][1] == ["bench.client1.step1 | no host op", pytest.approx(10e-6)]


def test_tree_roofline_reads_bound_over_time():
    from benchmark.harness import readers

    record = {"trace": {"steps": 2, "by_name": {"tree_pass_kernel<3>": 0.004, "conv": 1.0}},
              "tree_levels": 4 * 12 * 2000, "batch": 12, "img_size": 384, "num_classes": 3}
    assert readers.load("tree_kernels_ms.train").read(record) == pytest.approx(2.0)
    bound = work.tree_step_bound_ms(12, 384, 3, 3, 4 * 12 * 2000)
    assert readers.load("tree_roofline.train").read(record) == pytest.approx(100 * bound / 2.0)
    # bytes bind every tree kernel: the roofline is the bytes over the card's bandwidth
    w = work.tree_chain_work(12, 384, 384, 3, 3, 4 * 12 * 2000)
    assert all(b / work.HBM_BYTES_PER_S >= ops / work.FP32_PEAK_FLOPS for ops, b in w.values())
