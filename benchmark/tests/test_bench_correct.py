"""``correct`` on the CPU at 32^2: true for the port as it is, false for
the control (TF32 for float32) and for each fault the local rounds can have;
in every cell and in a cell of another model family, strategy and objective
built here (``bench_helpers.TEST_CELLS``), which the harness takes from its
reference module alone.

The port runs its plain routes here (the tree chain's twins, the gated
CRF's twin); the card runs its kernels, which the check on the card holds
to the same reference at the cells' own sizes.
"""

from __future__ import annotations

import time

import pytest
import torch

from bench_helpers import CELLS, TEST_CELLS, small_cell
from benchmark.harness import check
from benchmark.run import driver, run_cell

SEED = 2**31 + 977  # beyond 32 signed bits, as the check's seeds are


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_small(name, trace=False):
    return run_cell(small_cell(name), SEED, 0.1, trace, torch.device("cpu"), time.perf_counter())


ALL_CELLS = CELLS + list(TEST_CELLS)


@pytest.mark.parametrize("name", ALL_CELLS)
def test_port_is_correct_at_a_small_size(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(small_cell(name)["limits"])
    assert set(out["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert out["attempted"] >= 10 and out["failed"] == 0


def test_traced_run_reports_the_host_metrics():
    out = run_small(CELLS[0], trace=True)
    assert out["correct"], out["checks"]
    assert {"head_step_ms.train", "body_step_ms.train", "step_mfu.train"} <= set(out["metrics"])
    assert out["busy_s"] == 0.0 and "idle_share.train" not in out["metrics"]  # no device here


@pytest.mark.parametrize("name", ALL_CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    cfg, traffic = cell["config"], cell["traffic"]
    drv = driver(traffic["kind"])
    ref = drv.reference_readings(cfg, traffic, SEED, "cpu")
    control = drv.reference_readings(cfg, traffic, SEED, "cpu",
                                     round_bits=cell["precision"]["control_mantissa_bits"])
    readings = drv.compare(control, ref)
    assert not check.judge(readings, cell["limits"]), readings


def _state_unchanged(real):
    def make_round_fn(model, cfg, device=None):
        inner = real(model, cfg, device=device)

        def round_fn(state, batches, cid, on_step=None):
            return state, inner(state, batches, cid, on_step=on_step)[1]

        return round_fn

    return make_round_fn


def _half_batch(real):
    def get_objective(cfg):
        objective = real(cfg)

        def half(model, batch, cid, cfg, generator=None):
            rows = batch["image"].shape[0] // 2
            return objective(model, {k: v[:rows] for k, v in batch.items()}, cid, cfg, generator)

        return half

    return get_objective


@pytest.mark.parametrize("name", ALL_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    from fedicra_torch.engine import trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(trainer, "make_round_fn", _state_unchanged(trainer.make_round_fn))
    else:
        monkeypatch.setattr(trainer, "get_objective", _half_batch(trainer.get_objective))
    out = run_small(name)
    assert not out["correct"], out["checks"]
