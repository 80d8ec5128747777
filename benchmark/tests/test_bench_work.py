"""The work counts and the trace arithmetic, on known inputs."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import SPEC, small_cell
from benchmark.harness import inputs, trace, work
from benchmark.reference.unet_lc import UNetLCMultiHead, param_specs

CONFIG_CELLS = {w["config"]: w["name"] for w in SPEC["workloads"]}
# the published widths, and a narrower model with two heads
NARROW = {"features": [8, 16, 32, 48, 64], "pcs_stages": 1, "dsn_heads": 2, "dsn_hidden": 40,
          "dropout": [0.0] * 5, "dsn_dropout": 0.0}


def widths_of(config):
    return NARROW if config == "narrow" else small_cell(CONFIG_CELLS[config])["config"]["widths"]


@pytest.mark.parametrize("in_chns,classes,clients,img,config",
                         [(3, 3, 5, 32, c) for c in CONFIG_CELLS]
                         + [(1, 2, 5, 32, "narrow"), (3, 2, 4, 48, "narrow")])
def test_forward_flops_match_flop_counter(in_chns, classes, clients, img, config):
    widths = widths_of(config)
    params = inputs.draw_weights(param_specs(in_chns, classes, clients, widths), 1, "cpu")
    images = torch.rand(2, img, img, in_chns)
    with FlopCounterMode(display=False) as counter:
        UNetLCMultiHead(clients, widths)(params, images, torch.zeros(2, dtype=torch.long), None)
    assert counter.get_total_flops() == 2 * work.forward_flops(in_chns, classes, clients, img, widths)


def test_step_flops_at_odoc():
    widths = small_cell("odoc.local_rounds")["config"]["widths"]
    fwd = work.forward_flops(3, 3, 5, 384, widths)
    assert round(fwd / 1e9, 1) == 52.0
    steps = work.step_flops(3, 3, 5, 384, 12, widths)
    assert steps["head"] > 5 * 12 * fwd and steps["body"] < 7 * 12 * fwd


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
