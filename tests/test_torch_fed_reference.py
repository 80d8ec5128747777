"""The federated-rounds cell's pieces on the CPU, at 32^2, batch 2, four
clients: the port's ALA merge, FedAvg and epochs against the benchmark's
plain reference (``benchmark/reference/fed_round.py``), in one process and
as four gloo ranks; the driver's rank, started as the cell starts it,
setting the precision file's switches itself; the cell's run over four
gloo ranks, a client a rank, each rank's client checked; the sharded
round's spans and ``collectives`` counter; the cell's readers; and the
check's verdict on faults of the program.

This file imports no JAX: its rank targets are imported again by the
spawned processes.
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.drivers import fed_rounds  # noqa: E402
from benchmark.harness import inputs, readers  # noqa: E402
from benchmark.reference import models  # noqa: E402
from benchmark.reference.fed_round import ala_merge, epoch_batches, fedavg, is_gated  # noqa: E402
from benchmark.run import load_cell, run_cell  # noqa: E402
from fedicra_torch.data import batcher  # noqa: E402
from fedicra_torch.federation import ala, sharded  # noqa: E402
from fedicra_torch.models import net_factory  # noqa: E402
from fedicra_torch.models.params_filters import is_ala_gated  # noqa: E402
from fedicra_torch.parallel.launch import spawn_ranks  # noqa: E402
from fedicra_torch.utils import profiling  # noqa: E402

CELL = "polyp.fed_rounds.4chip"
SEED = 2**31 + 977  # beyond 32 signed bits, as the check's seeds are
WEIGHTS = [10, 7, 12, 3]  # uneven batch counts, so the mean is weighted


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: pytest-xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    torch.set_num_threads(n)
    profiling.reset()


def tiny_cell(iters=2, img=32, **precision) -> dict:
    """The cell at ``img``^2, batch 2, ``iters`` steps a round (the last
    one the body phase), splits of ``iters`` batches."""
    cell = copy.deepcopy(load_cell(CELL))
    cell["config"]["task"]["img_size"] = img
    cell["config"]["train"].update(batch_size=2, iters=iters, rep_iters=1)
    cell["traffic"]["train_batches"] = iters
    cell["precision"].update(precision)
    return cell


def trees(config, n=4):
    specs = models.load(config["model"]).param_specs(config)
    return [inputs.draw_weights(specs, inputs.sub_seed(SEED, "tree", c), "cpu") for c in range(n)]


def test_reference_gates_the_ports_leaves():
    config = tiny_cell()["config"]
    names = [n for n, _, _ in models.load(config["model"]).param_specs(config)]
    assert [n for n in names if is_gated(n)] == [n for n in names if is_ala_gated(n)]
    assert any(is_gated(n) for n in names) and not all(is_gated(n) for n in names)


def test_ports_ala_merge_equals_the_reference():
    """``learn_gates`` (one epoch, the steady state) against ``ala_merge``
    from the same local and global weights, epoch and dropout stream."""
    cell = tiny_cell()
    config, traffic = cell["config"], cell["traffic"]
    task = config["task"]
    cfg = fed_rounds.port_config(config, cell["precision"], SEED)
    model = net_factory(config["model"], in_chns=task["in_chns"], class_num=task["num_classes"],
                        num_clients=task["num_clients"])
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    glob, local = trees(config, 2)
    epoch = local_pool(config, traffic, cid=1)
    port, _, gates = ala.learn_gates(model, cfg, local, glob, stats, lambda n: epoch,
                                     torch.Generator().manual_seed(5), 1, False)
    ref = ala_merge(models.load(config["model"]), config, local, glob, epoch["image"], epoch["label"], 1,
                    torch.Generator().manual_seed(5))
    assert fed_rounds.worst_gap({n: port[n] for n in ref if is_gated(n)},
                                {n: ref[n] for n in ref if is_gated(n)}) <= 1e-6
    assert all(torch.equal(port[n], glob[n]) for n in glob if not is_gated(n))
    moved = sum(int((g < 1).sum()) for g in gates.values())
    assert moved > 0  # the epoch learnt something to compare


@pytest.mark.parametrize("n,batch,img,epoch", [(6, 2, 16, 0), (7, 3, 17, 1), (20, 4, 32, 5)])
def test_ports_epoch_equals_the_reference(n, batch, img, epoch):
    """``materialize_epoch`` (the batches' and ALA's epochs) against
    ``epoch_batches`` from the same split and stream, bit for bit: the
    order, the wrap to whole batches, rot90 and flip, the rotation and its
    fills."""
    g = torch.Generator().manual_seed(n)
    images = torch.rand(n, img, img, 3, generator=g)
    labels = torch.randint(0, 3, (n, img, img), generator=g).to(torch.uint8)
    stream = SEED + n
    port = batcher.materialize_epoch(images, labels, stream, epoch, batch, 2, "polyp")
    ref = epoch_batches(images, labels, stream, epoch, batch, 2, 0.0)
    assert torch.equal(port[0], ref[0]) and torch.equal(port[1], ref[1])
    assert (ref[1] == 2).any()  # a rotation filled some pixels


def local_pool(config, traffic, cid):
    from benchmark.drivers import local_rounds

    return local_rounds.pool(config, traffic, SEED, cid, "cpu")


def test_fedavg_on_one_rank_equals_the_float64_mean():
    """``_fedavg`` on a (1, 1) mesh holding four clients."""
    config = tiny_cell()["config"]
    held = trees(config)
    w = torch.tensor(WEIGHTS, dtype=torch.float32)
    got = sharded._fedavg(held, w, w.sum(), None)
    assert fed_rounds.worst_gap(got, fedavg(held, WEIGHTS)) <= 1e-6


def _fedavg_rank(rank: int, device: str, out: str) -> None:
    config = tiny_cell()["config"]
    held = trees(config)
    w = torch.tensor(WEIGHTS, dtype=torch.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = sharded._fedavg([held[rank]], w[rank:rank + 1], w.sum(), dist.group.WORLD)
    torch.save({"mean": got, "collectives": profiling.counters().get("collectives")}, f"{out}.{rank}")


def test_fedavg_over_four_gloo_ranks_equals_the_float64_mean(tmp_path):
    """Each rank holds one client; the all-reduce gives every rank the
    weighted mean, counted once as a collective."""
    out = str(tmp_path / "fedavg")
    spawn_ranks(_fedavg_rank, (out,), "gloo", ["cpu"] * 4, timeout=300)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(4)]
    want = fedavg(trees(tiny_cell()["config"]), WEIGHTS)
    for r in ranks:
        assert fed_rounds.worst_gap(r["mean"], want) <= 1e-6
        assert all(torch.equal(r["mean"][n], ranks[0]["mean"][n]) for n in want)
        assert r["collectives"] == {None: 1}


def _switches_rank(rank: int, device: str, cell: dict, out: str) -> None:
    """The driver's rank target, as the cell spawns it."""
    fed_rounds._rank_target(rank, device, cell, SEED, 0.0, False, out)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_a_spawned_rank_sets_the_precision_files_switches(tmp_path, allow_tf32):
    """A spawned process starts at PyTorch's defaults (cuDNN's TF32 on,
    the matmuls' off), so a rank that reports both switches as the file
    sets them, either way, set them itself."""
    cell = tiny_cell(img=16, allow_tf32=allow_tf32)
    spawn_ranks(_switches_rank, (cell, str(tmp_path)), "gloo", ["cpu"], timeout=300)
    rank = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert rank["switches"] == {"cudnn_allow_tf32": allow_tf32, "matmul_allow_tf32": allow_tf32}
    assert rank["forbidden"] == [] and rank["readings"]["precision"] == 0.0


def _rolled_labels(real):
    """A data path that hands each image another sample's labels."""
    def materialize_epoch(*args, **kwargs):
        images, labels = real(*args, **kwargs)
        return images, labels.roll(1, 1)

    return materialize_epoch


def _cell_rank(rank: int, device: str, cell: dict, out: str, faulty_rank) -> None:
    """The driver's rank target, traced; on ``faulty_rank`` the round's
    batches come with rolled labels."""
    if rank == faulty_rank:
        batcher.materialize_epoch = _rolled_labels(batcher.materialize_epoch)
    fed_rounds._rank_target(rank, device, cell, SEED, 0.0, True, out, ("collectives.fed", "ala_ms.fed"))


@pytest.mark.parametrize("faulty_rank", [None, 2])
def test_the_cell_over_four_gloo_ranks_checks_every_ranks_client(tmp_path, faulty_rank):
    """A rank a client, as on the cards: rank 0 gathers each rank's client
    checks, and a fault in rank 2's data path alone fails the check on
    client 2. Traced: the readers run in rank 0 (two all-reduces; no
    device times here)."""
    cell = tiny_cell(img=16)
    spawn_ranks(_cell_rank, (cell, str(tmp_path), faulty_rank), "gloo", ["cpu"] * 4, timeout=600)
    lead = torch.load(tmp_path / "rank0.pt", weights_only=False)
    limits = cell["limits"]
    bad = {c for c, r in lead["client_readings"].items() if any(r[k] > limits[k] for k in r)}
    assert sorted(lead["client_readings"]) == [0, 1, 2, 3]
    assert bad == (set() if faulty_rank is None else {faulty_rank}), lead["client_readings"]
    assert lead["readings"]["loss"] == max(r["loss"] for r in lead["client_readings"].values())
    assert lead["readings"]["fedavg"] <= limits["fedavg"] and lead["readings"]["precision"] == 0
    assert lead["per_layer"] == {"collectives.fed": (2, "count")}
    assert all(torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["rounds"] == 1 for r in range(4))


def test_sharded_round_spans_each_stage():
    """One steady-state round on (1, 1) under the profiler: a merge and a
    local round a client, one aggregate, no all-reduce."""
    cell = tiny_cell(img=16)
    prog = fed_rounds.Program(cell["config"], cell["precision"], cell["traffic"], SEED, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prog.fed.run_round()
    spans = profiling.spans()
    for name, n in (("fedicra.fed.ala", 4), ("fedicra.fed.local_round", 4), ("fedicra.fed.aggregate", 1)):
        got = [s for s in spans if s["name"] == name]
        assert len(got) == n, (name, len(got))
    assert [s["ids"]["cid"] for s in spans if s["name"] == "fedicra.fed.ala"] == [0, 1, 2, 3]
    steps = [s for s in spans if s["name"] == "fedicra.step"]
    local = {s["seq"] for s in spans if s["name"] == "fedicra.fed.local_round"}
    assert steps and all(s["parent"] in local for s in steps)
    assert "collectives" not in profiling.counters()


def test_count_counts_only_under_a_profiler():
    profiling.count("collectives")
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("fedicra.fed.aggregate"):
            profiling.count("collectives")
        profiling.count("collectives")
    assert profiling.counters() == {"collectives": {"fedicra.fed.aggregate": 1, None: 1}}


@pytest.mark.parametrize("metric,record,want", [
    ("ala_ms.fed", {"fed_span_ms": {"fedicra.fed.ala": 612.5}}, 612.5),
    ("local_round_ms.fed", {"fed_span_ms": {"fedicra.fed.local_round": 1402.0}}, 1402.0),
    ("aggregate_ms.fed", {"fed_span_ms": {"fedicra.fed.aggregate": 3.25}}, 3.25),
    ("collectives.fed", {"fed_collectives": 2}, 2),
    ("ala_ms.fed", {"fed_span_ms": {}}, None),
    ("collectives.fed", {"fed_collectives": None}, None),
])
def test_fed_readers(metric, record, want):
    assert readers.load(metric).read(record) == want


@pytest.mark.parametrize("fault", [None, "ala_gates_one", "own_state", "ala_epoch_unaugmented"])
def test_faults_of_the_program_are_not_correct(monkeypatch, fault):
    """The port as it is reads correct; with ALA's gates held at one (the
    merge returns the local weights), with a rank's own returned state
    as the aggregate, or with ALA's epochs drawn without augmentation, it
    does not."""
    if fault == "ala_gates_one":
        monkeypatch.setattr(ala, "ala_epoch", lambda model, cfg, gates, *rest: (gates, 0.0))
    elif fault == "own_state":
        monkeypatch.setattr(sharded, "_fedavg", lambda held, weights, total, group: dict(held[0]))
    elif fault == "ala_epoch_unaugmented":
        real = sharded.materialize_epoch
        monkeypatch.setattr(sharded, "materialize_epoch", lambda *a, **k: real(*a, **{**k, "augment": False}))
    out = run_cell(tiny_cell(), SEED, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] == (fault is None), out["checks"]
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failing == {None: set(), "ala_gates_one": {"ala"}, "own_state": {"fedavg"},
                       "ala_epoch_unaugmented": {"ala"}}[fault], out["checks"]
    assert out["attempted"] == 4 * 2 and out["failed"] == 0
    assert out["ranks"] == [{"rank": 0, "cudnn_allow_tf32": False, "matmul_allow_tf32": False}]
