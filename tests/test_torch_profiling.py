"""The port's profiling hooks against fedicra_tpu's (CPU)."""

import json

import pytest
import torch

from fedicra_torch.utils.profiling import StepTimer, annotate, trace
from fedicra_tpu.utils.profiling import StepTimer as JaxStepTimer
from torch_port_helpers import one_torch_thread  # noqa: F401


def test_summary_equals_jax_on_the_same_durations():
    durations = {"fit": [0.5, 0.25, 1.75, 0.125, 0.3], "eval": [0.01], "ala": [2.0, 3.0]}
    port, ref = StepTimer(), JaxStepTimer()
    for name, vals in durations.items():
        for v in vals:
            port.record(name, v)
            ref.record(name, v)
    assert port.summary() == ref.summary()
    assert set(port.summary()["fit"]) == {"count", "mean_s", "p50_s", "p95_s", "total_s"}


@pytest.mark.parametrize("block_on", [None, torch.ones(3), {"a": [torch.zeros(1)]}, torch.device("cpu")])
def test_time_records_a_duration(block_on):
    timer = StepTimer()
    with timer.time("step", block_on=block_on):
        torch.ones(8).sum()
    s = timer.summary()["step"]
    assert s["count"] == 1 and s["total_s"] >= 0.0


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    with trace(str(tmp_path)):
        with annotate("smoke.span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "smoke.span" for e in events)
