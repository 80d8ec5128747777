"""The local-rounds traffic: a strategy's local rounds, client after client.

What a federated run's fits do, without the merges. The model is the
configuration's ``model``, found as ``reference/models/<model>.py``: its
parameters, the port's widths, the reference's forward and the work count
all come from that module, and the round's phases from the configuration's
strategy (``reference.fedicra_round.phases``). Each client has its
own ``ClientState`` (weights, BatchNorm statistics, iteration count and
dropout generator) and its own pool of one round's batches (``iters`` x
``batch_size`` distinct images in its supervision form), made on the device
from the seed. The port's entry point is
``engine.trainer.make_round_fn(model, cfg)``'s ``round_fn``, called for
client 0, 1, ..., K - 1, 0, ...

Every round starts from its client's state as set-up made it, dropout
generator included, as a federated fit starts each round from the weights
it was handed: a run's work is then fixed by its seed. (Carried from round
to round, the states would drift with training, the trees of the tree
chain would deepen, and the work of a run would depend on how far its
window got.)

Set-up builds the states and pools and runs client 0's first round: it
compiles and warms every shape, and it is the round the reference follows
once the window has closed. The window then runs whole cycles, one round of
each client, until ``seconds`` have passed, synchronising at each step's
``on_step``: the clients' pools differ, and so do their trees, so a run
that stopped part-way through a cycle would train another mix of rounds. A
traced run profiles one more round after the window, the cycle's first.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..harness import check, inputs, trace, work
from ..reference import models
from ..reference.fedicra_round import phases, reference_round


def cycle(num_clients: int):
    """The window's order of clients: client 0's round, checked in set-up,
    last."""
    return [*range(1, num_clients), 0]


def round_phases(config: dict):
    """(label, leaves it trains, first step, end) of each phase of a round."""
    model = models.load(config["model"])
    return phases(model, config, [n for n, _, _ in model.param_specs(config)])


def pool(config: dict, traffic: dict, seed: int, cid: int, device):
    t = config["train"]
    n = t["iters"] * t["batch_size"]
    images, labels = inputs.client_pool(seed, cid, n, config["task"], traffic, device)
    shape = (t["iters"], t["batch_size"])
    return {"image": images.view(shape + images.shape[1:]), "label": labels.view(shape + labels.shape[1:])}


class Program:
    """The port's side: the model, its round function and every client's
    state and pool, built from the seed."""

    def __init__(self, config: dict, precision: dict, traffic: dict, seed: int, device):
        from fedicra_torch.engine.config import TrainConfig
        from fedicra_torch.engine.trainer import ClientState, make_round_fn
        from fedicra_torch.models import net_factory

        task, t = config["task"], config["train"]
        family = models.load(config["model"])
        if precision["autocast"] not in (None, "bfloat16"):
            raise ValueError(f"the port autocasts to bfloat16 or not at all: {precision}")
        self.cfg = TrainConfig.for_task(task["img_class"], model=config["model"],
                                        amp=precision["autocast"] == "bfloat16", **{
            k: task[k] for k in ("img_size", "in_chns", "num_classes", "num_clients")}, **{
            k: t[k] for k in ("procedure", "strategy", "batch_size", "tree_loss_weight",
                              "gatecrf_weight", "gatecrf_radius", "alpha", "iters", "rep_iters",
                              "base_lr", "max_iterations")})
        self.model = net_factory(config["model"], in_chns=task["in_chns"], class_num=task["num_classes"],
                                 **family.port_kwargs(config)).to(device)
        ref_specs = family.param_specs(config)
        got = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        want = {n: tuple(s) for n, s, _ in ref_specs}
        if got != want:
            raise ValueError(f"the port's parameters differ from the reference's: "
                             f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
        self.weights = inputs.draw_weights(ref_specs, seed, device)
        buffers = {n: b.detach().clone() for n, b in self.model.named_buffers()}
        self.states = [
            ClientState({n: w.clone() for n, w in self.weights.items()},
                        {n: b.clone() for n, b in buffers.items()}, 0,
                        inputs.generator(device, seed, "dropout", cid))
            for cid in range(task["num_clients"])]
        self.starts = [s.generator.get_state() for s in self.states]
        self.pools = [pool(config, traffic, seed, cid, device) for cid in range(task["num_clients"])]
        self.round_fn = make_round_fn(self.model, self.cfg, device=device)
        self.phases = round_phases(config)
        self.labels = [label for label, _, lo, hi in self.phases for _ in range(lo, hi)]

    def next_round(self, cid: int, on_step):
        """Client ``cid``'s round from its set-up state: the state it
        returns is read and dropped."""
        state = self.states[cid]
        state.generator.set_state(self.starts[cid])
        return self.round_fn(state, self.pools[cid], cid, on_step=on_step)[0]

    def checked_round(self) -> dict:
        """Client 0's first round, read as the reference reads its own: each
        step's loss, the gradient each phase's first step hands its
        optimizer (leaf norms), and each leaf's change over the round, from
        the state the round returns."""
        losses, grads = [], {}
        first = {lo: live for _, live, lo, _ in self.phases}

        def on_step(j, metrics):
            losses.append(metrics["total_loss"])
            if j in first:
                params = dict(self.model.named_parameters())
                grads[j] = {n: params[n].grad.norm() for n in first[j] if params[n].grad is not None}

        new = self.next_round(0, on_step).params
        return {"losses": [float(x) for x in losses],
                "grads": {j: {n: float(v) for n, v in g.items()} for j, g in grads.items()},
                "change": {n: float((new[n] - w).norm()) for n, w in self.weights.items()}}


def reference_readings(config: dict, traffic: dict, seed: int, device, round_bits: Optional[int] = None,
                       fault: Optional[str] = None) -> dict:
    """The reference's client 0 first round on the same seed's inputs."""
    model = models.load(config["model"])
    weights = inputs.draw_weights(model.param_specs(config), seed, device)
    data = pool(config, traffic, seed, 0, device)
    out = reference_round(model, config, weights, data["image"], data["label"], 0,
                          inputs.generator(device, seed, "dropout", 0), round_bits=round_bits,
                          fault=fault, record_grads=[lo for _, _, lo, _ in round_phases(config)])
    out["change"] = {n: float((p - weights[n]).norm()) for n, p in out.pop("params").items()}
    return out


def compare(program: dict, reference: dict) -> Dict[str, float]:
    """loss: the worst loss gap over the steps up to the last phase's first
    step (FedICRA: the head steps and the body phase's first step; one full
    phase: its first step); grad: the worst leaf's gradient gap at each
    phase's first step; change: the worst moving leaf's change gap over the
    round.

    The losses after the last phase's first update are not compared: AdamW's
    first step in a phase moves each weight by about the rate times the sign
    of its gradient, and the weights whose gradients are near zero take
    either sign on float32 rounding, so the later losses differ by ~1e-2
    between two sound runs (0.6% at 32^2 on the CPU)."""
    last_first = max(reference["grads"])  # the grads are recorded at each phase's first step
    grad = max(check.worst_leaf(program["grads"].get(j, {}), ref)
               for j, ref in reference["grads"].items())
    moving = check.moving_leaves(list(reference["grads"].values()))
    change = check.worst_leaf({n: program["change"][n] for n in moving},
                              {n: reference["change"][n] for n in moving})
    return {"loss": check.loss_gap(program["losses"][:last_first + 1],
                                   reference["losses"][:last_first + 1]),
            "grad": grad, "change": change}


def _stamp_round(prog: "Program", cid: int, stamps: list, sync, after_step=None) -> None:
    """Client ``cid``'s next round; each step appends (time, phase, loss),
    taken after a synchronise."""
    def on_step(j, metrics):
        sync()
        stamps.append((time.perf_counter(), prog.labels[j], float(metrics["total_loss"])))
        if after_step is not None:
            after_step(j)

    prog.next_round(cid, on_step)


def run(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        readers: dict) -> dict:
    """One run of a local-rounds cell (as ``run.load_cell`` gives it);
    returns the result (without device)."""
    config, precision, traffic = cell["config"], cell["precision"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_build = time.perf_counter()
    prog = Program(config, precision, traffic, seed, device)
    sync()
    t_first = time.perf_counter()
    checked = prog.checked_round()
    sync()
    K, batch = config["task"]["num_clients"], config["train"]["batch_size"]

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"setup: {t_build - t_start:.3f} s imports, {t_first - t_build:.3f} s model, states and "
          f"pools (the card's first use), {t0 - t_first:.3f} s client 0's first round (kernels built "
          f"or loaded)", file=sys.stderr)
    stamps = []
    while not stamps or stamps[-1][0] - t0 < seconds:
        for cid in cycle(K):
            _stamp_round(prog, cid, stamps, sync)
    window_end = stamps[-1][0]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = len(stamps)
    failed = sum(1 for s in stamps if not math.isfinite(s[2]))
    times = [b[0] - a[0] for a, b in zip([(t0, None, None)] + stamps[:-1], stamps)]
    record = {
        "step_s": {label: [t for t, s in zip(times, stamps) if s[1] == label]
                   for label, _, _, _ in prog.phases},
        "flops": work.step_flops(models.load(config["model"]), config),
        "peak_flops": precision["peak_flops"],
        "batch": batch, "img_size": config["task"]["img_size"],
        "num_classes": config["task"]["num_classes"],
    }
    if traced:
        record["trace"] = _traced_round(prog, cycle(K)[0], config, sync, cuda)

    # the reference runs once the window is closed and the program freed
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(config, traffic, seed, device)
    readings = compare(checked, ref)
    checks = check.report(readings, cell["limits"])
    if ref.get("depths") is not None:
        record["tree_levels"] = int((ref["depths"] + 1).sum())
    result = {
        "correct": check.judge(readings, cell["limits"]),
        "attempted": steps, "failed": failed,
        "end_to_end": {
            "train_img_per_s": (steps * batch / (window_end - t0), "images/s"),
            "peak_mem_gib": (peak / 2**30, "GiB"),
            "setup_s": (setup_s, "s"),
        },
        "memory_peak_bytes": peak,
        "checks": checks,
    }
    if traced:
        result["per_layer"] = {}
        for name, reader in readers.items():
            value = reader.read(record)
            if value is not None:
                result["per_layer"][name] = (value, reader.UNIT)
        result["busy_s"] = record["trace"]["busy_s"]
        result["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    return result


def _traced_round(prog: Program, cid: int, config: dict, sync, cuda: bool) -> dict:
    """One more round, of the next client, under the profiler: the spans
    are the benchmark's own, one for the round and one for each step."""
    open_spans = []

    def enter(name):
        span = record_function(name)
        span.__enter__()
        open_spans.append(span)

    def next_step(j):
        open_spans.pop().__exit__(None, None, None)
        if j + 1 < config["train"]["iters"]:
            enter(f"bench.client{cid}.step{j + 1}")

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(f"bench.client{cid}.round"):
            enter(f"bench.client{cid}.step0")
            _stamp_round(prog, cid, [], sync, next_step)
            sync()
    device, host = trace.reduce_profile(prof)
    summary = trace.summarise(device, host, trace.span_window(host, f"bench.client{cid}.round"))
    summary["steps"] = config["train"]["iters"]
    return summary
