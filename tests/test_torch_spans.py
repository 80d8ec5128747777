"""The port's spans and host-sync counter (``fedicra_torch/utils/profiling.py``)
and the benchmark readers that read them.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack; the README names the command that runs every card
test.
"""

import ast
import json
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.engine.trainer import init_client_state, make_round_fn
from fedicra_torch.losses.tree_energy import multi_scale_tree_energy_loss
from fedicra_torch.models import net_factory
from fedicra_torch.utils import profiling
from fedicra_torch.utils.profiling import HostSyncs, annotate
from torch_card import cuda_device  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEP_PARTS = ("fedicra.step.forward", "fedicra.step.contrast", "fedicra.step.tree_term",
              "fedicra.step.crf_term", "fedicra.step.backward")
HEAD_STATS = "fedicra.contrast.head_stats"  # each DSN head of each contrast forward
DSN_HEAD = "fedicra.dsn.head"  # each DSN head of the step's own forward
ROUND_SPANS = ("fedicra.round.load_state", "fedicra.round.split_state")
# the sharded round's: each client's ALA merge and local round, the FedAvg
FED_SPANS = ("fedicra.fed.ala", "fedicra.fed.local_round", "fedicra.fed.aggregate")
# the readers this file's spans feed, and the spans each sums
SPAN_READERS = {
    "forward_ms.train": ("fedicra.step.forward",),
    "contrast_ms.train": ("fedicra.step.contrast",),
    "tree_term_ms.train": ("fedicra.step.tree_term", "fedicra.tree.filter_backward"),
    "crf_term_ms.train": ("fedicra.step.crf_term",),
    "backward_ms.train": ("fedicra.step.backward",),
}
READERS = [*SPAN_READERS, "host_syncs.train"]


@pytest.fixture(autouse=True)
def empty_table():
    """An empty table, and one torch thread (pytest-xdist's workers share the
    cores)."""
    threads = torch.get_num_threads()
    profiling.reset()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    profiling.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _round(K=5):
    """A 32^2 FedICRA "ours" round of client 1: tree on, K clients, 2 head
    and 1 body steps; the model's forward calls are stamped."""
    cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, iters=3, rep_iters=1,
                               num_clients=K)
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=K)
    state = init_client_state(model, cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    batches = {"image": torch.rand(3, 2, 32, 32, 3, generator=g),
               "label": torch.randint(0, 4, (3, 2, 32, 32), generator=g)}
    stamps = []
    model.register_forward_hook(lambda *_: stamps.append(time.perf_counter()))
    return cfg, make_round_fn(model, cfg, device="cpu"), state, batches, stamps


def _holds(span, t):
    return span["host_s"][0] <= t <= span["host_s"][1]


def test_round_spans_nest_as_the_step_runs():
    cfg, round_fn, state, batches, stamps = _round()
    closed = []  # the steps whose span had closed when on_step ran
    with _profiled():
        round_fn(state, batches, 1, on_step=lambda j, m: closed.append(
            [s["ids"]["j"] for s in profiling.spans() if s["name"] == "fedicra.step"]))
    assert closed == [[0], [0, 1], [0, 1, 2]]
    spans = profiling.spans()
    assert all(s["device_ms"] is None for s in spans)
    by_name = Counter(s["name"] for s in spans)
    assert all(by_name[n] == 1 for n in ROUND_SPANS)
    setups = [s for s in spans if s["name"] == "fedicra.round.phase_setup"]
    assert [s["ids"] for s in setups] == [{"cid": 1, "phase": "head"}, {"cid": 1, "phase": "body"}]
    steps = [s for s in spans if s["name"] == "fedicra.step"]
    assert [s["ids"] for s in steps] == [{"cid": 1, "j": 0, "phase": "head"},
                                         {"cid": 1, "j": 1, "phase": "head"},
                                         {"cid": 1, "j": 2, "phase": "body"}]
    assert all(s["parent"] is None for s in steps + setups)
    for step in steps:
        parts = [s for s in spans if s["parent"] == step["seq"]]
        assert sorted(s["name"] for s in parts) == sorted(STEP_PARTS)
        assert all(s["ids"] == step["ids"] for s in parts)
        forwards = {s["name"]: sum(_holds(s, t) for t in stamps) for s in parts}
        assert forwards["fedicra.step.forward"] == 1
        assert forwards["fedicra.step.contrast"] == cfg.num_clients - 1
        contrast = next(s for s in parts if s["name"] == "fedicra.step.contrast")
        heads = [s for s in spans if s["parent"] == contrast["seq"]]
        assert [s["name"] for s in heads] == [HEAD_STATS] * 3 * (cfg.num_clients - 1)
        assert [s["ids"] for s in heads] == [{**step["ids"], "head": h}
                                             for h in (1, 2, 3) * (cfg.num_clients - 1)]
        forward = next(s for s in parts if s["name"] == "fedicra.step.forward")
        dsn = [s for s in spans if s["parent"] == forward["seq"]]
        assert [(s["name"], s["ids"]) for s in dsn] == [(DSN_HEAD, {**step["ids"], "head": h})
                                                        for h in (1, 2, 3)]
    # every model forward of the round lies in a forward or contrast span
    assert len(stamps) == len(steps) * cfg.num_clients
    assert len(spans) == len(ROUND_SPANS) + len(setups) + len(steps) * (
        1 + len(STEP_PARTS) + 3 + 3 * (cfg.num_clients - 1))
    assert profiling.counters() == {}  # host syncs are counted on a card only


def test_round_without_profiler_leaves_the_table_empty():
    _, round_fn, state, batches, _ = _round(K=3)
    round_fn(state, batches, 1)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_filter_backward_spans_nest_in_the_backward():
    """The native route's four ``TreeFilter`` backwards (the kernels' twins on
    CPU tensors) under a step's backward span."""
    g = torch.Generator().manual_seed(3)
    preds = torch.randn(2, 16, 16, 3, generator=g, requires_grad=True)
    image = torch.rand(2, 16, 16, 3, generator=g)
    auxes = [torch.randn(2, 16 // s, 16 // s, 3, generator=g, requires_grad=True) for s in (2, 4, 8)]
    rois = (torch.rand(2, 16, 16, generator=g) > 0.3).float()
    with _profiled():
        with annotate("fedicra.step", cid=2, j=4, phase="head"):
            loss, *_ = multi_scale_tree_energy_loss(preds, image, *auxes, rois, 0.1, host_offload=True)
            with annotate("fedicra.step.backward"):
                loss.backward()
    spans = {s["seq"]: s for s in profiling.spans()}
    backward = next(s for s in spans.values() if s["name"] == "fedicra.step.backward")
    filters = [s for s in spans.values() if s["name"] == "fedicra.tree.filter_backward"]
    assert len(filters) == 4
    assert all(s["parent"] == backward["seq"] for s in filters)
    assert spans[backward["parent"]]["name"] == "fedicra.step"
    assert all(s["ids"] == {"cid": 2, "j": 4, "phase": "head"} for s in filters)
    assert all(_holds(backward, s["host_s"][0]) and _holds(backward, s["host_s"][1]) for s in filters)
    assert all(a.grad is not None for a in auxes)


def test_annotate_off_makes_no_record_function_and_no_event(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("made while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    with HostSyncs("cuda") as syncs:
        with annotate("fedicra.step", cid=0, j=0, phase="head"), syncs.paused():
            torch.ones(4).sum()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_host_syncs_counts_against_the_innermost_span_and_passes_other_warnings_on(monkeypatch):
    """The counter's warning plumbing, with the debug mode's warnings issued
    by hand (the mode itself needs the card:
    ``test_item_counts_one_sync_and_a_span_times_the_card``)."""
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with _profiled():
            with HostSyncs("cuda") as syncs:
                warnings.warn(profiling.SYNC_WARNING)
                with annotate("fedicra.step"):
                    with annotate("fedicra.step.backward"):
                        for _ in range(2):
                            warnings.warn(profiling.SYNC_WARNING)
                    warnings.warn("something else")
                    with syncs.paused():
                        pass
        assert [str(w.message) for w in shown] == ["something else"]
    assert profiling.counters() == {"host_syncs": {None: 1, "fedicra.step.backward": 2}}
    assert modes == ["warn", 0, "warn", 0]
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with HostSyncs("cuda"):  # no profiler: off
            warnings.warn(profiling.SYNC_WARNING)
    assert len(shown) == 1 and modes == ["warn", 0, "warn", 0]
    assert profiling.counters()["host_syncs"] == {None: 1, "fedicra.step.backward": 2}


def _kernel_name_lists():
    from benchmark.harness import readers

    families = json.loads((ROOT / "benchmark" / "harness" / "kernel_families.json").read_text())
    lists = [tuple(f["substrings"]) for f in families]
    for path in (ROOT / "benchmark" / "metrics").glob("*.py"):
        reader = readers.load(path.stem)
        lists += [tuple(getattr(reader, k)) for k in ("INCLUDE", "EXCLUDE", "KERNELS")
                  if hasattr(reader, k)]
    return {s for lst in lists for s in lst}


def _annotated_names():
    """Every span name the port passes to ``annotate`` as a literal."""
    names = set()
    for path in (ROOT / "fedicra_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "annotate"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_span_names_match_no_kernel_name_list():
    names = _annotated_names()
    assert {*STEP_PARTS, *ROUND_SPANS, "fedicra.step", "fedicra.round.phase_setup",
            "fedicra.tree.filter_backward", HEAD_STATS, DSN_HEAD, *FED_SPANS} == names
    substrings = _kernel_name_lists()
    assert {"gated_crf", "conv", "cat", "fill", "index", "reduce"} <= substrings
    assert not [(n, s) for n in names for s in substrings if s in n.lower()]


class _Table:
    """A program's table as a reader sees it."""

    def __init__(self, spans, counters):
        self._spans, self._counters = spans, counters

    def spans(self):
        return self._spans

    def counters(self):
        return self._counters


def _synthetic_table(steps):
    spans = []
    for j in range(steps):
        for i, name in enumerate(STEP_PARTS):
            spans.append({"name": name, "device_ms": 10.0 * (i + 1) + j})
        spans += [{"name": "fedicra.tree.filter_backward", "device_ms": 0.5}] * 4
        spans.append({"name": "fedicra.step", "device_ms": 1000.0})
    return _Table(spans, {"host_syncs": {"fedicra.round.split_state": 10, "fedicra.step": 5}})


@pytest.mark.parametrize("metric", READERS)
def test_reader_gives_a_step_average_of_the_table(monkeypatch, metric):
    from benchmark.harness import readers

    steps = 10
    monkeypatch.setattr("fedicra_torch.utils.profiling", _synthetic_table(steps))
    reader = readers.load(metric)
    record = {"trace": {"steps": steps}}
    if metric == "host_syncs.train":
        want = 15 / steps
    else:
        names = SPAN_READERS[metric]
        want = sum(10.0 * (STEP_PARTS.index(n) + 1) + j if n in STEP_PARTS else 0.5 * 4
                   for j in range(steps) for n in names) / steps
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    assert reader.read({}) is None


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_nothing_from_a_program_without_the_table(monkeypatch, metric):
    """The parent commit's program: ``annotate`` but no table."""
    from benchmark.harness import readers

    bare = type(sys)("fedicra_torch.utils.profiling")
    bare.annotate = lambda name: torch.profiler.record_function(name)
    monkeypatch.setattr("fedicra_torch.utils.profiling", bare)
    assert readers.load(metric).read({"trace": {"steps": 10}}) is None


def test_host_syncs_reader_reads_zero_where_the_counter_ran_and_counted_nothing(monkeypatch):
    from benchmark.harness import readers

    table = _Table([], {"host_syncs": {}})
    monkeypatch.setattr("fedicra_torch.utils.profiling", table)
    reader = readers.load("host_syncs.train")
    assert reader.read({"trace": {"steps": 10}}) == 0.0
    assert readers.load("forward_ms.train").read({"trace": {"steps": 10}}) is None


@pytest.mark.cuda
def test_item_counts_one_sync_and_a_span_times_the_card(cuda_device):
    a = torch.randn(1024, 1024, device=cuda_device)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with HostSyncs(cuda_device) as syncs:
            with annotate("probe.matmul"):
                b = a @ a
            with annotate("probe.read"):
                b.sum().item()
            with syncs.paused():
                b.sum().item()
    assert profiling.counters() == {"host_syncs": {"probe.read": 1}}
    spans = {s["name"]: s for s in profiling.spans()}
    assert spans["probe.matmul"]["device_ms"] > 0
    assert torch.cuda.get_sync_debug_mode() == 0
