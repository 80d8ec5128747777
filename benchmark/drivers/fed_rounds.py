"""The federated-rounds traffic: FedICRA's rounds through the port's sharded
route, one client a card.

The port's ``--sharded`` loop, ``ShardedFederation.run_round``, on a
(client, data) mesh of ranks (the traffic's ``mesh``): on the card one
process a rank, started by ``parallel/launch.spawn_ranks`` over the
traffic's ``backend`` with the traffic's ``timeout_s``; on the CPU, in this
process, a (1, 1) mesh that holds every client, so a test's patches of the
port reach the round. Each rank holds its clients' splits on its device:
``train_batches`` batches of the cell's batch size, the local-rounds
traffic's images and weak labels in the client's supervision form, every
split the same size, so ALA draws its epochs from the split arrays as the
host client's ``EpochBatcher`` does. Each rank sets the precision file's
TF32 switches itself (a spawned process starts at PyTorch's defaults) and
checks that no forbidden module is loaded, before it runs the port.

Set-up: the federation (the port draws the weights from the seed), one
round at ``iter_global <= ala_skip_iters`` (plain FedAvg, so each client's
state leaves the global), then the round counter past ALA's first run
(``ala_skip_iters + iters``): every later round runs ALA's steady state,
one gate-learning epoch a client. The first run (epochs until converged)
happens once in a job and is left out. Then the checked round, and the
window: whole rounds, every rank in step, until rank 0's clock has passed
``seconds`` (rank 0 decides after each round and tells the others), with
no evaluation and no checkpoint. A traced run profiles one more round on
every rank.

The check, on every client each rank holds (one a rank on the cards),
each stage started from the program's own inputs to it, taken where the
round uses them (the merge's weights and dropout stream at ALA's
``learn_gates``, each epoch's sampling stream at ``materialize_epoch``, the
merged weights at ``load_state_dict``): ``precision``, the ranks whose TF32
switches differ from the precision file; ``ala``, the merged weights
against ``reference.fed_round.ala_merge``; ``loss``, ``grad`` and
``change``, the local round against ``reference_round`` from the
program's merged weights, as the local-rounds check reads them;
``fedavg``, the all-reduced global against the float64 weighted mean of
every client's returned state. The reference draws each client's split
from the traffic itself and builds its epochs with
``reference.fed_round.epoch_batches`` from the stream the program names,
so a client given another's data, labels or shard reads wrong. Each rank
runs the reference for its own clients on its own card after the window;
rank 0 gathers the readings (the worst over clients), the returned states
and the switches.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import tempfile
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..harness import check, env, inputs, trace
from ..harness.readers import load as load_reader
from ..reference import models
from ..reference.fed_round import ala_merge, epoch_batches, fedavg, image_cval, is_gated
from ..reference.fedicra_round import reference_round
from . import local_rounds

FED_SPANS = ("fedicra.fed.ala", "fedicra.fed.local_round", "fedicra.fed.aggregate")
ROUND_SPAN = "bench.fed.round"  # the traced round, on every rank


def port_config(config: dict, precision: dict, seed: int):
    """The port's ``TrainConfig`` of the cell; its seed (which draws the
    weights, the batchers' epochs and the dropout streams) is 31 bits of the
    run's seed's hash."""
    from fedicra_torch.engine.config import TrainConfig

    task, t = config["task"], config["train"]
    if precision["autocast"] not in (None, "bfloat16"):
        raise ValueError(f"the port autocasts to bfloat16 or not at all: {precision}")
    return TrainConfig.for_task(
        task["img_class"], model=config["model"], amp=precision["autocast"] == "bfloat16",
        seed=inputs.sub_seed(seed, "federation") >> 32,
        **{k: task[k] for k in ("img_size", "in_chns", "num_classes", "num_clients")},
        **{k: t[k] for k in ("procedure", "strategy", "batch_size", "tree_loss_weight", "gatecrf_weight",
                             "gatecrf_radius", "alpha", "iters", "rep_iters", "base_lr", "max_iterations")})


def split_size(config: dict, traffic: dict) -> int:
    return traffic["train_batches"] * config["train"]["batch_size"]


def client_data(config: dict, traffic: dict, seed: int, cid: int, device):
    """Client ``cid``'s training images and weak labels, as the traffic
    draws them on ``device``."""
    return inputs.client_pool(seed, cid, split_size(config, traffic), config["task"], traffic, device)


def client_split(config: dict, traffic: dict, seed: int, cid: int, device):
    """Client ``cid``'s training split, on ``device``."""
    from fedicra_torch.data.h5io import ClientSplit

    images, labels = client_data(config, traffic, seed, cid, device)
    return ClientSplit(images, labels.to(torch.uint8), [f"client{cid}_{i}" for i in range(len(images))])


def sized_split(n: int):
    """A split of ``n`` images that holds none: a client another rank
    holds, whose size alone this rank reads (FedAvg's weights)."""
    from fedicra_torch.data.h5io import ClientSplit

    return ClientSplit(torch.empty(n, 0), torch.empty(n, 0, dtype=torch.uint8), [])


def switches() -> Dict[str, bool]:
    return {"cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32)}


def off_precision(read: Dict[str, bool], precision: dict) -> bool:
    return any(v != bool(precision["allow_tf32"]) for v in read.values())


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in tree.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank0_says(value: bool) -> bool:
    import torch.distributed as dist

    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@contextlib.contextmanager
def _tapped(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


class Program:
    """One rank's side: the port's ``ShardedFederation`` over this rank's
    clients, set up as the module's docstring says; ``marks``: the wall
    clock at the end of each step of its set-up."""

    def __init__(self, config: dict, precision: dict, traffic: dict, seed: int, device):
        from fedicra_torch.federation.sharded_experiment import ShardedFederation
        from fedicra_torch.parallel.mesh import make_mesh

        self.device = torch.device(device)
        self.cfg = cfg = port_config(config, precision, seed)
        K, n = cfg.num_clients, split_size(config, traffic)
        mesh = make_mesh(num_clients=K)
        self.splits = {cid: {"train": client_split(config, traffic, seed, cid, self.device)
                             if cid in mesh.clients else sized_split(n), "val": sized_split(0)}
                       for cid in range(K)}
        self.fed = ShardedFederation(cfg, mesh=mesh, splits=self.splits, device=self.device)
        if self.fed.ala_raw is None:
            raise ValueError("the cell needs every split the same size, so ALA draws from the split arrays")
        want = {name: tuple(shape) for name, shape, _ in models.load(config["model"]).param_specs(config)}
        got = {name: tuple(p.shape) for name, p in self.fed.model.named_parameters()}
        if got != want:
            raise ValueError(f"the port's parameters differ from the reference's: "
                             f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
        self.phases = local_rounds.round_phases(config)
        _sync(self.device)
        self.marks = [("states and splits", time.time())]
        self.fed.run_round()  # iter_global <= ala_skip_iters: FedAvg alone
        _sync(self.device)
        self.marks.append(("FedAvg round", time.time()))
        self.fed.current_round = cfg.ala_skip_iters + cfg.iters  # past ALA's first run

    @property
    def mesh(self):
        return self.fed.mesh

    def checked_round(self) -> dict:
        """One round, with the program's inputs to each stage of every
        client this rank holds, taken where the round uses them, and what
        the program made of them: {"clients": {cid: {"program", "stages"}},
        "global": the aggregate, "held": each client's returned state}."""
        from fedicra_torch.data import batcher
        from fedicra_torch.federation import sharded

        fed, held = self.fed, list(self.mesh.clients)
        owner = {self.splits[c]["train"].images.data_ptr(): c for c in held}
        stages = {c: {"cid": c, "start_iter": fed.states[c].current_iter,
                      "generator": fed.states[c].generator.get_state(), "ala_draws": [], "draws": []}
                  for c in held}

        def draws(key):
            def wrap(real):
                def materialize_epoch(images, labels, seed, epoch, *args, **kwargs):
                    cid = owner.get(images.data_ptr())
                    if cid is None:
                        raise RuntimeError("the round drew an epoch from a split the driver did not make")
                    stages[cid][key].append((seed, epoch))
                    return real(images, labels, seed, epoch, *args, **kwargs)

                return materialize_epoch

            return wrap

        def gates(real):
            def learn_gates(model, cfg, local, glob, stats, provider, generator, cid, first_run):
                stages[cid].update({"local": _cpu(local), "global": _cpu(glob),
                                    "ala_generator": generator.get_state()})
                return real(model, cfg, local, glob, stats, provider, generator, cid, first_run)

            return learn_gates

        names = [n for n, _ in fed.model.named_parameters()]
        loaded = []

        def on_load(module, state_dict, prefix, *rest):
            if prefix == "":
                loaded.append({n: state_dict[n].detach().clone() for n in names})

        first = {lo: live for _, live, lo, _ in self.phases}
        losses, grads = {c: [] for c in held}, {c: {} for c in held}

        def on_step(c, j, metrics):
            losses[c].append(metrics["total_loss"])
            if j in first:
                params = dict(fed.model.named_parameters())
                grads[c][j] = {n: params[n].grad.norm() for n in first[j] if params[n].grad is not None}

        hook = fed.model.register_load_state_dict_pre_hook(on_load)
        try:
            with _tapped(batcher, "materialize_epoch", draws("draws")), \
                    _tapped(sharded, "materialize_epoch", draws("ala_draws")), \
                    _tapped(sharded, "learn_gates", gates):
                fed.run_round(on_step=on_step)
        finally:
            hook.remove()
        if len(loaded) != len(held) or any("local" not in stages[c] for c in held):
            raise RuntimeError(f"the round loaded {len(loaded)} client states and merged "
                               f"{sum('local' in stages[c] for c in held)} on a rank of {len(held)} clients")
        clients = {}
        for c, merged in zip(held, loaded):
            returned = fed.states[c].params
            program = {"merged": _cpu({n: t for n, t in merged.items() if is_gated(n)}),
                       "losses": [float(x) for x in losses[c]],
                       "grads": {j: {n: float(v) for n, v in g.items()} for j, g in grads[c].items()},
                       "change": {n: float((returned[n] - merged[n]).norm()) for n in names}}
            clients[c] = {"program": program, "stages": {**stages[c], "merged": _cpu(merged)}}
        return {"clients": clients,
                "global": _cpu({**fed.global_payload["params"], **fed.global_payload["batch_stats"]}),
                "held": {c: _cpu({**fed.states[c].params, **fed.states[c].batch_stats}) for c in held}}

    def window(self, seconds: float) -> dict:
        """Whole rounds until rank 0's clock passes ``seconds``; each step's
        loss is kept to count the steps that failed."""
        from fedicra_torch.federation.sharded_experiment import _gather

        fed, dev = self.fed, self.device
        losses = []
        _gather(None)  # every rank starts together
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0_wall, t0 = time.time(), time.perf_counter()
        rounds = 0
        while True:
            fed.run_round(on_step=lambda c, j, m: losses.append(m["total_loss"]))
            rounds += 1
            _sync(dev)
            t_end = time.perf_counter()
            if not _rank0_says(t_end - t0 < seconds):
                break
        steps = torch.stack([x.float().reshape(()) for x in losses])
        return {"t0_wall": t0_wall, "window_s": t_end - t0, "rounds": rounds,
                "attempted": int(steps.numel()), "failed": int((~torch.isfinite(steps)).sum()),
                "peak": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}

    def traced_round(self) -> dict:
        """One more round under the profiler: device ms in each federation
        span, the all-reduces counted, and this rank's trace summary (its
        steps: every local step of the round on this rank). The port's
        span table (``utils/profiling``) then holds this round alone."""
        from fedicra_torch.utils import profiling

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        profiling.reset()
        _sync(self.device)
        with profile(activities=acts) as prof:
            with record_function(ROUND_SPAN):
                self.fed.run_round()
                _sync(self.device)
        spans = profiling.spans()
        span_ms = {}
        for name in FED_SPANS:
            ms = [s["device_ms"] for s in spans if s["name"] == name]
            if ms and all(m is not None for m in ms):
                span_ms[name] = sum(ms)
        by_span = profiling.counters().get("collectives")
        device, host = trace.reduce_profile(prof)
        summary = trace.summarise(device, host, trace.span_window(host, ROUND_SPAN))
        summary["steps"] = self.cfg.iters * len(self.mesh.clients)
        return {"span_ms": span_ms, "collectives": None if by_span is None else sum(by_span.values()),
                "summary": summary}


def seed_stages(config: dict, traffic: dict, seed: int, device) -> dict:
    """Every stage's inputs drawn from the seed alone, for the reference
    without a program (the pins, the control): a global and a local tree
    drawn apart, client 0's streams, and four client trees to average."""
    specs = models.load(config["model"]).param_specs(config)
    K = config["task"]["num_clients"]
    return {"cid": 0, "start_iter": 0,
            "local": inputs.draw_weights(specs, seed, device),
            "global": inputs.draw_weights(specs, inputs.sub_seed(seed, "global"), device),
            "ala_generator": inputs.generator(device, seed, "ala", 0).get_state(),
            "generator": inputs.generator(device, seed, "dropout", 0).get_state(),
            "ala_draws": [(inputs.sub_seed(seed, "ala_epochs"), 1)],
            "draws": [(inputs.sub_seed(seed, "epochs"), 0)],
            "held": [inputs.draw_weights(specs, inputs.sub_seed(seed, "client", c), device)
                     for c in range(K)]}


def _generator(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def reference_readings(config: dict, traffic: dict, seed: int, device, round_bits: Optional[int] = None,
                       fault: Optional[str] = None, stages: Optional[dict] = None) -> dict:
    """The reference's stages of one client from ``stages`` (the program's
    inputs, one client's of ``Program.checked_round``), or from the seed
    alone (``seed_stages``), where the local round starts from the
    reference's own merge and the aggregate is the mean of trees drawn
    apart. The client's split comes from the traffic, its epochs from
    ``epoch_batches`` over the streams the stages name. ``fault``: as
    ``reference_round`` takes it."""
    model = models.load(config["model"])
    t, task = config["train"], config["task"]
    standalone = stages is None
    if standalone:
        stages = seed_stages(config, traffic, seed, device)
    cid = stages["cid"]
    images, labels = client_data(config, traffic, seed, cid, device)
    epochs = {}

    def epoch(seed_epoch):
        if seed_epoch not in epochs:
            epochs[seed_epoch] = epoch_batches(images, labels, *seed_epoch, t["batch_size"], task["num_classes"],
                                               image_cval(task["img_class"]))
        return epochs[seed_epoch]

    def on(tree):
        return {n: v.to(device) for n, v in tree.items()}

    if len(stages["ala_draws"]) != 1:
        raise ValueError(f"ALA's steady state draws one epoch a merge, not {len(stages['ala_draws'])}")
    glob = on(stages["global"])
    merged = ala_merge(model, config, on(stages["local"]), glob, *epoch(tuple(stages["ala_draws"][0])), cid,
                       _generator(stages["ala_generator"], device), round_bits=round_bits)
    streams = {e: s for s, e in stages["draws"]}
    at = [divmod(stages["start_iter"] + i, traffic["train_batches"]) for i in range(t["iters"])]
    if any(e not in streams for e, _ in at):
        raise ValueError(f"the round's epochs {sorted({e for e, _ in at})} were not all drawn: {sorted(streams)}")
    batches = [torch.stack([epoch((streams[e], e))[part][i] for e, i in at]) for part in (0, 1)]
    epochs.clear()
    start = merged if standalone else on(stages["merged"])
    out = reference_round(model, config, start, *batches, cid, _generator(stages["generator"], device),
                          start_iter=stages["start_iter"], round_bits=round_bits, fault=fault,
                          record_grads=[lo for _, _, lo, _ in local_rounds.round_phases(config)])
    out["change"] = {n: float((p - start[n]).norm()) for n, p in out.pop("params").items()}
    out["merged"] = {n: v.detach().cpu() for n, v in merged.items() if is_gated(n)}
    if standalone:  # the program's side, where a reference takes its place
        out["fedavg"] = out["global"] = fedavg(stages["held"], [traffic["train_batches"]] * len(stages["held"]))
        out["precision"] = 0
    return out


def worst_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's norm of the difference over the larger of its
    reference norm and the median leaf's, in float64; 1 where a leaf is
    missing or not finite."""
    norms = {n: float(r.double().norm()) for n, r in reference.items()}
    med = statistics.median(norms.values())
    worst = 0.0
    for n, ref in reference.items():
        got = program.get(n)
        if got is None or got.shape != ref.shape:
            return 1.0
        gap = float((got.double().cpu() - ref.double().cpu()).norm()) / max(norms[n], med)
        worst = max(worst, gap if gap == gap else 1.0)
    return worst


def client_checks(program: dict, reference: dict) -> Dict[str, float]:
    """One client's: ala, the worst gated leaf's merge gap; loss, grad,
    change: ``local_rounds.compare``'s."""
    out = local_rounds.compare(program, reference)
    out["ala"] = worst_gap(program["merged"], reference["merged"])
    return out


def compare(program: dict, reference: dict) -> Dict[str, float]:
    """``client_checks``, and precision: the ranks off the precision file;
    fedavg: the worst leaf's gap between the aggregate and the float64
    mean."""
    out = client_checks(program, reference)
    out["fedavg"] = worst_gap(program["global"], reference["fedavg"])
    out["precision"] = float(program["precision"])
    return out


def federation_checks(client: Dict[int, dict], global_: dict, held: Dict[int, dict], off_ranks: int,
                      traffic: dict) -> Dict[str, float]:
    """The cell's readings: each client check's worst over ``client``,
    fedavg (``global_`` against the float64 mean of ``held``, every client's
    returned state, weighted by the traffic's batch counts) and precision
    (``off_ranks``)."""
    out = {k: max(c[k] for c in client.values()) for k in next(iter(client.values()))}
    out["fedavg"] = worst_gap(global_, fedavg([held[c] for c in sorted(held)],
                                              [traffic["train_batches"]] * len(held)))
    out["precision"] = float(off_ranks)
    return out


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rank_run(cell: dict, seed: int, seconds: float, traced: bool, device, metrics=()) -> dict:
    """One rank's run: set-up, the checked round, the window, the traced
    round; then, with the program freed, the reference for this rank's
    clients. Rank 0 gathers every rank's checks, returned states,
    switches and span times, and gives the readings and, traced, the
    per-layer ``metrics`` (read in this process, whose span table holds
    its traced round)."""
    import torch.distributed as dist

    from fedicra_torch.federation.sharded_experiment import _gather

    config, precision, traffic = cell["config"], cell["precision"], cell["traffic"]
    marks = [("rank's start", time.time())]
    env.set_precision(precision)
    rank = dist.get_rank() if dist.is_initialized() else 0
    prog = Program(config, precision, traffic, seed, device)
    before = switches()
    checked = prog.checked_round()
    marks += prog.marks + [("checked round", time.time())]
    out = {"rank": rank, **prog.window(seconds), "marks": marks}
    traced_round = prog.traced_round() if traced else None
    out["switches"] = after = switches()
    del prog
    _free(device)
    mine = {c: client_checks(v["program"], reference_readings(config, traffic, seed, device, stages=v["stages"]))
            for c, v in checked["clients"].items()}
    parts = _gather({"checks": mine, "held": checked.pop("held"),
                     "off": off_precision(before, precision) or off_precision(after, precision),
                     "span_ms": traced_round and traced_round["span_ms"]})
    if rank != 0:
        return out
    client = {c: v for p in parts for c, v in p["checks"].items()}
    out["client_readings"] = client
    out["readings"] = federation_checks(client, checked["global"], {c: v for p in parts for c, v in p["held"].items()},
                                        sum(p["off"] for p in parts), traffic)
    if traced:
        record = {"trace": traced_round["summary"], "fed_collectives": traced_round["collectives"],
                  "fed_span_ms": {name: max(p["span_ms"][name] for p in parts)
                                  for name in FED_SPANS if all(name in p["span_ms"] for p in parts)}}
        out["trace"] = traced_round["summary"]
        out["per_layer"] = {}
        for name in metrics:
            reader = load_reader(name)
            value = reader.read(record)
            if value is not None:
                out["per_layer"][name] = (value, reader.UNIT)
    return out


def _rank_target(rank: int, device: str, cell: dict, seed: int, seconds: float, traced: bool,
                 out_dir: str, metrics=()) -> None:
    """A spawned rank: no forbidden module before the port runs, and the
    ones loaded by its end in its result."""
    loaded = env.forbidden_modules()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded in rank {rank}: {loaded}")
    torch.set_num_threads(4 if torch.device(device).type == "cuda" else 1)  # CPU ranks share the cores
    out = rank_run(cell, seed, seconds, traced, device, metrics)
    out["forbidden"] = env.forbidden_modules()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(cell: dict, seed: int, seconds: float, traced: bool, device, metrics=()):
    """Every rank's result and the wall clock at the spawn: on CUDA, one
    spawned process a card of the traffic's mesh; elsewhere this process
    alone, a (1, 1) mesh (no spawn: None)."""
    traffic = cell["traffic"]
    n = traffic["mesh"][0] * traffic["mesh"][1]
    if torch.device(device).type != "cuda" or n == 1:
        return [rank_run(cell, seed, seconds, traced, device, metrics)], None
    from fedicra_torch.ops._build import build_all
    from fedicra_torch.parallel.launch import spawn_ranks

    build_all()  # once here, not four times at once in the ranks
    spawned = time.time()
    with tempfile.TemporaryDirectory(prefix="bench_fed_") as tmp:
        spawn_ranks(_rank_target, (cell, seed, seconds, traced, tmp, tuple(metrics)), traffic["backend"],
                    [f"cuda:{i}" for i in range(n)], timeout=traffic["timeout_s"])
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)], spawned


def _print_setup(start_wall: float, spawned: Optional[float], ranks: list) -> None:
    """Each rank's set-up, step by step, on standard error."""
    if spawned is not None:
        print(f"setup: {spawned - start_wall:.3f} s to the spawn (imports, nvcc's build or load)",
              file=sys.stderr)
    for r in ranks:
        at, steps = spawned if spawned is not None else start_wall, []
        for name, t in r["marks"] + [("wait for every rank", r["t0_wall"])]:
            steps.append(f"{t - at:.3f} s {name}")
            at = t
        print(f"setup, rank {r['rank']}: " + ", ".join(steps), file=sys.stderr)


def run(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        readers: dict) -> dict:
    """One run of a federated-rounds cell (as ``run.load_cell`` gives it);
    returns the result (without device). The per-layer metrics are read in
    rank 0 by the names of ``readers``."""
    start_wall = time.time() - (time.perf_counter() - t_start)
    ranks, spawned = run_ranks(cell, seed, seconds, traced, device, list(readers))
    loaded = sorted({m for r in ranks for m in r.get("forbidden", [])})
    if loaded:
        raise SystemExit(f"benchmark: forbidden modules loaded in a rank: {loaded}")
    lead = ranks[0]
    config = cell["config"]
    per_round = config["task"]["num_clients"] * config["train"]["iters"] * config["train"]["batch_size"]
    setup_s = lead["t0_wall"] - start_wall
    _print_setup(start_wall, spawned, ranks)
    print(f"setup: {setup_s:.3f} s to the window; window: {lead['rounds']} rounds in "
          f"{lead['window_s']:.3f} s on rank 0", file=sys.stderr)
    for c, checks in sorted(lead["client_readings"].items()):
        print(f"client {c}: " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(checks.items())), file=sys.stderr)
    readings = lead["readings"]
    peak = max(r["peak"] for r in ranks)
    result = {
        "correct": check.judge(readings, cell["limits"]),
        "attempted": sum(r["attempted"] for r in ranks),
        "failed": sum(r["failed"] for r in ranks),
        "end_to_end": {
            "train_img_per_s": (lead["rounds"] * per_round / lead["window_s"], "images/s"),
            "peak_mem_gib": (peak / 2**30, "GiB"),
            "setup_s": (setup_s, "s"),
        },
        "memory_peak_bytes": peak,
        "ranks": [{"rank": r["rank"], **r["switches"], **({"forbidden": r["forbidden"]} if "forbidden" in r else {})}
                  for r in ranks],
        "checks": check.report(readings, cell["limits"]),
    }
    if traced:
        result["per_layer"] = lead["per_layer"]
        result["busy_s"] = lead["trace"]["busy_s"]
        result["window_s"] = lead["trace"]["window_s"]
        result["breakdown"] = lead["trace"]["breakdown"]
    return result
