"""The port's federation on the card: two FedICRA rounds of each task's
clients with ALA, aggregation, evaluation, checkpoints and a resume; FedAdam;
the SPMD federation on its meshes; and the entry points a user starts (the
train and test CLIs, the runner, its ``--distributed`` route).

Every test here is marked ``cuda`` and skips without a card. This file
imports no JAX (the card's machine has none); the README names the command
that runs every card test.
"""

import contextlib
import io
import json
import math
import os
import signal
import struct
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from torch_card import (BATCH, IMG, ZERO_COUNTS, cuda_device, free_the_card, full_fp32,  # noqa: F401
                        kernel_counts, reset_kernel_counts, tree_on_counts)

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
LIMIT = 12  # images a client


def federation_config(task: str = "odoc"):
    """FedICRA "ours" for ``task`` at full width, its own clients and image
    size, batch 12, 2 local steps a round (1 head, 1 body), ALA from
    iteration 3 on (the reference waits until 51), evaluation at iteration 4.

    Not ``eval_iters=2``: an evaluate runs the client's whole set_weights
    (the reference's), so at iteration 2, where ALA is still skipped, each
    client would adopt the global weights, and round 2's fit would find
    them equal to its own and skip ALA too."""
    from fedicra_torch.engine.config import TrainConfig

    return TrainConfig.for_task(task, procedure="ours", strategy="FedICRA", model="unet_lc_multihead",
                                batch_size=BATCH, iters=2, rep_iters=1, eval_iters=4, ala_skip_iters=2)


def _federation(dev, snap: str, task: str):
    """Two federated rounds of ``task``'s synthetic clients (of its
    supervision types) through ``build_experiment`` and
    ``FederatedServer.run``, every client's fit and evaluate recorded with
    its ALA report. Round 1 (iteration 2): each client adopts the global
    weights (they equal its own) and trains; the server averages. Round 2
    (iteration 4): each client's ALA merge runs its first-run loop, it
    trains, and the evaluation merges once more and validates."""
    from fedicra_torch.federation import build_experiment

    cfg = federation_config(task)
    server = build_experiment(cfg, synthetic=True, limit_per_client=LIMIT, snapshot_dir=snap, device=dev)
    fits, evals = [], []  # per call: (iteration, cid, ALA report[, FitRes])
    for c in server.clients:
        def fit(ins, _c=c, _fit=c.fit):
            res = _fit(ins)
            fits.append((ins.config["iter_global"], _c.cid, dict(_c.ala_report), res))
            return res

        def evaluate(ins, _c=c, _evaluate=c.evaluate):
            res = _evaluate(ins)
            evals.append((ins.config["iter_global"], _c.cid, dict(_c.ala_report)))
            return res

        c.fit, c.evaluate = fit, evaluate
    reset_kernel_counts()
    history = server.run(num_rounds=2 * cfg.iters, progress=False)
    return types.SimpleNamespace(cfg=cfg, server=server, history=history, fits=fits, evals=evals,
                                 counts=kernel_counts(), snap=snap)


@pytest.fixture(scope="module")
def odoc_federation(cuda_device, tmp_path_factory):
    """``_federation`` of ODOC's 5 clients, whose snapshot the test CLI reads
    and whose losses the SPMD federation is held to."""
    return _federation(cuda_device, str(tmp_path_factory.mktemp("odoc") / "federation"), "odoc")


@pytest.mark.parametrize("task", ["odoc", "faz", "polyp"])
def test_two_federated_rounds(cuda_device, request, tmp_path, task):
    """``_federation``'s two rounds: ALA skipped in round 1, its first-run
    loop (11-50 epochs) in round 2's fit and one epoch at its evaluate,
    ``start_phase`` cleared; the global payload the weighted mean of round
    2's fit payloads, recomputed in float64; each evaluated client's weights
    the global ones where ALA does not gate them, and between the global and
    its own fit result where it does; every loss and metric finite (hd95
    aside: NaN where a mask is empty); ``best_client_<c>`` written when a
    client's val dice beats 0 and ``best_global`` when the weighted mean does
    (under ODOC at least one client); a resume from the snapshot finds the
    same round, phases, iterations and weights; one gated-CRF, MST and
    rooting launch and four filter launches each way a local step."""
    from fedicra_torch.federation import build_experiment
    from fedicra_torch.models.params_filters import is_ala_gated

    if task == "odoc":
        run = request.getfixturevalue("odoc_federation")
    else:
        run = _federation(cuda_device, str(tmp_path / "federation"), task)
    cfg, server, history, snap = run.cfg, run.server, run.history, run.snap
    K = cfg.num_clients
    for it, cid, rep, _ in run.fits:
        if it == cfg.iters:
            assert not rep, f"client {cid}: ALA ran in round 1"
        if it == 2 * cfg.iters:
            assert rep and 11 <= rep["epochs"] <= 50, (cid, rep)
    assert [(it, rep.get("epochs")) for it, _, rep in run.evals] == [(2 * cfg.iters, 1)] * K
    assert [c.start_phase for c in server.clients] == [False] * K

    last = [f for f in run.fits if f[0] == 2 * cfg.iters]
    weights = torch.tensor([float(f[3].num_examples) for f in last], dtype=torch.float64)
    weights /= weights.sum()
    for part, tree in server.global_payload.items():
        for name, got in tree.items():
            want = sum(w * f[3].payload[part][name].double() for w, f in zip(weights, last))
            torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-7)
    glob = server.global_payload["params"]
    for c, (*_, res) in zip(server.clients, last):
        for name, value in c.state.params.items():
            if not is_ala_gated(name):
                assert torch.equal(value, glob[name]), (c.cid, name)
                continue
            own = res.payload["params"][name]
            lo, hi = torch.minimum(glob[name], own), torch.maximum(glob[name], own)
            assert ((value >= lo - 1e-6) & (value <= hi + 1e-6)).all(), (c.cid, name)

    final = history[-1]
    nonfinite = [k for k, v in final.items() if isinstance(v, float) and "val_" in k and not math.isfinite(v)]
    assert all("hd95" in k for k in nonfinite), nonfinite
    for rec in history:
        for k, v in rec.items():
            assert not ("loss" in k and isinstance(v, float) and not math.isfinite(v)), (k, v)
    wrote = {n: os.path.exists(os.path.join(snap, n))
             for n in ["metrics.jsonl", "best_global"] + [f"best_client_{c}" for c in range(K)]}
    expect = {"metrics.jsonl": True, "best_global": final["val_mean_dice"] > 0,
              **{f"best_client_{c}": final[f"client_{c}_val_mean_dice"] > 0 for c in range(K)}}
    assert wrote == expect
    # a 2-class task's val dice may still be 0 everywhere after 2 rounds
    assert task != "odoc" or any(wrote[f"best_client_{c}"] for c in range(K))

    server.ckpt.save_resume(server._resume_state())
    again = build_experiment(cfg, synthetic=True, limit_per_client=LIMIT, snapshot_dir=snap,
                             device=cuda_device)
    assert again.try_resume() and again.current_round == server.current_round
    for a, b in zip(again.clients, server.clients):
        assert a.start_phase == b.start_phase and a.state.current_iter == b.state.current_iter
        assert all(torch.equal(a.state.params[k], v) for k, v in b.state.params.items()), a.cid
    assert run.counts == tree_on_counts(K * 2 * cfg.iters)


def test_a_fedadam_round_against_float64(cuda_device):
    """One FedAdam round of 2 clients x 1 step of "ours" at full width
    (FedAdam is not personalised: no ALA, no contrast term): finite losses;
    the global payload, both parts, against FedAdam's update recomputed in
    float64 from the clients' fit payloads (flwr's defaults, moments from
    zero), x + eta m / (sqrt(v) + tau), at rtol 1e-5 wherever the weighted
    mean moved by more than 1e-4, and within eta everywhere; one step's
    launches a client."""
    from fedicra_torch.federation import build_experiment

    cfg = federation_config().replace(strategy="FedAdam", num_clients=2, iters=1, rep_iters=1,
                                      eval_iters=2)
    server = build_experiment(cfg, synthetic=True, limit_per_client=LIMIT, device=cuda_device)
    start = {part: {k: v.clone() for k, v in tree.items()} for part, tree in server.global_payload.items()}
    fits = []
    for c in server.clients:
        def fit(ins, _fit=c.fit):
            fits.append(_fit(ins))
            return fits[-1]

        c.fit = fit
    reset_kernel_counts()
    history = server.run(num_rounds=cfg.iters, progress=False)
    assert kernel_counts() == tree_on_counts(2)
    losses = [history[-1][f"client_{c}_total_loss"] for c in range(2)]
    assert all(math.isfinite(v) for v in losses), losses
    s = server.strategy
    weights = torch.tensor([float(f.num_examples) for f in fits], dtype=torch.float64)
    weights /= weights.sum()
    for part, tree in server.global_payload.items():
        for name, got in tree.items():
            x, got = start[part][name].double(), got.double()
            delta = sum(w * f.payload[part][name].double() for w, f in zip(weights, fits)) - x
            m, v = (1 - s.beta_1) * delta, (1 - s.beta_2) * delta * delta
            want = x + s.eta * m / (torch.sqrt(v) + s.tau)
            # the step is eta * d / (|d| + 1e-8): ill-conditioned where the
            # mean moved by little more than float32 resolves on x
            sure = delta.abs() > 1e-4
            torch.testing.assert_close(got[sure], want[sure], rtol=1e-5, atol=1e-6)
            assert ((got - x).abs() <= s.eta * (1 + 1e-5)).all(), f"FedAdam moved {part}/{name} by more than eta"


# ---- the SPMD federation ----------------------------------------------------


def _sharded_rank(rank: int, device: str, cfg, out: str) -> None:
    """A rank of the sharded federation's first round on this rank's mesh:
    its first step's loss and BatchNorm statistics per client, the round's
    record, global payload and launches, saved to ``out.<rank>``."""
    import torch.distributed as dist

    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    full_fp32()  # as the test's own process
    fed = ShardedFederation(cfg, synthetic=True, limit_per_client=LIMIT, device=device)
    first = {}
    reset_kernel_counts()
    record = fed.run_round(on_step=_first_steps(fed, first))
    torch.save(dict(mesh=fed.mesh.shape, backend=dist.get_backend(), launches=kernel_counts(),
                    first=first, record=record, payload=_cpu_payload(fed.global_payload)), f"{out}.{rank}")


def _first_steps(fed, first: dict):
    """An ``on_step`` that records into ``first`` each client's first-step
    loss and the model's BatchNorm statistics after it."""
    def on_step(cid, j, metrics):
        if j == 0:
            first[cid] = (metrics["total_loss"].item(),
                          {n: b.detach().cpu().clone() for n, b in fed.model.named_buffers()})

    return on_step


def _cpu_payload(payload: dict) -> dict:
    return {part: {k: v.detach().cpu().clone() for k, v in tree.items()} for part, tree in payload.items()}


def _one_round(dev, cfg):
    """The sharded federation's first round on mesh (1, 1) in this process:
    each client's first-step loss and BatchNorm statistics, and the global
    payload."""
    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    fed = ShardedFederation(cfg, synthetic=True, limit_per_client=LIMIT, device=dev)
    first = {}
    fed.run_round(on_step=_first_steps(fed, first))
    return first, _cpu_payload(fed.global_payload)


def _ranks(cfg, backend: str, devices: list, tmp_path) -> list:
    from fedicra_torch.parallel import spawn_ranks

    out = str(tmp_path / f"rank_{backend}_{len(devices)}")
    spawn_ranks(_sharded_rank, (cfg, out), backend, devices, timeout=900)
    return [torch.load(f"{out}.{r}") for r in range(len(devices))]


def _hold_first_steps(ranks: list, first: dict, mesh: tuple, cfg) -> None:
    """Each rank of a (1, n) mesh holds every client: its first step per
    client against (1, 1)'s ``first``, the loss at rtol 1e-4, the BatchNorm
    statistics at atol 5e-5 + rtol 5e-5; every rank's record the same."""
    for res in ranks:
        held = sorted(res["first"])
        assert res["mesh"] == mesh and held == list(range(cfg.num_clients)), (res["mesh"], held)
        assert res["launches"] == tree_on_counts(len(held) * cfg.iters)
        for c, (loss, stats) in res["first"].items():
            loss0, stats0 = first[c]
            assert math.isclose(loss, loss0, rel_tol=1e-4), (c, loss, loss0)
            for n, b in stats.items():
                torch.testing.assert_close(b, stats0[n], rtol=5e-5, atol=5e-5, msg=f"client {c} {n}")
    assert all(res["record"] == ranks[0]["record"] for res in ranks)


def _hold_payloads(ranks: list, want: dict, cfg) -> None:
    """The round's global payload on every rank against (1, 1)'s ``want``,
    after one local step a client: the ranks equal bit for bit; the
    BatchNorm statistics at atol 5e-5 + rtol 5e-5; the weights within one
    Adam step's envelope (2 lr: a gradient of rounding noise turns into a
    step of +-lr) with each tensor's median element at 1e-6, but for the conv
    biases before a BatchNorm and the DSN heads, whose gradients are such
    noise, held to the envelope only (as tests/test_torch_sharded_data.py)."""
    from fedicra_torch.engine.trainer import poly_lr

    got = ranks[0]["payload"]
    for r, res in enumerate(ranks):
        for part, tree in res["payload"].items():
            assert all(torch.equal(v, got[part][k]) for k, v in tree.items()), (r, part)
    for k, w in want["batch_stats"].items():
        torch.testing.assert_close(got["batch_stats"][k], w, rtol=5e-5, atol=5e-5, msg=k)
    envelope = 2 * poly_lr(cfg.base_lr, 0, cfg.max_iterations)
    for k, w in want["params"].items():
        d = (got["params"][k] - w).abs().flatten()
        assert d.max().item() <= envelope, (k, d.max().item(), envelope)
        if not (k.endswith(".conv.bias") or ".dsn_head" in k):
            assert d.median().item() <= 1e-6, (k, d.median().item())


@pytest.mark.parametrize("mesh", ["(1, 1)", "gloo (1, 2)", "nccl"])
def test_the_sharded_federation(cuda_device, request, tmp_path, mesh):
    """The SPMD federation (``--sharded``'s library route) on the card.

    (1, 1), in this process: ``ShardedFederation.run`` for
    ``_federation``'s 2 ODOC rounds from the same weights and batches: each
    round's losses within rtol 1e-3 of the in-process federation's (the
    card's backward adds in no fixed order), ALA's first run 11-50 epochs a
    client, the launches of every local step, a finite val dice.
    gloo (1, 2): two ranks on one card (NCCL refuses two ranks on one
    device), batch 6 each, a first round of one step a client: each
    client's first-step loss (rtol 1e-4) and BatchNorm statistics against
    the same round on (1, 1) in this process, the two ranks equal; the
    round's global payload, after the data group's gradient all-reduce, the
    AdamW step and the FedAvg all-reduce, against (1, 1)'s.
    nccl, with two cards or more: the mesh of every card (5 clients: (1, n))
    held as gloo's is, and mesh (2, 1) with 4 clients, finite losses and
    the payload held to its (1, 1) round."""
    from fedicra_torch.federation.sharded_experiment import ShardedFederation

    cfg = federation_config()
    one_step = cfg.replace(iters=1, rep_iters=1)
    if mesh == "(1, 1)":
        want = [[rec[f"client_{c}_total_loss"] for c in range(5)]
                for rec in request.getfixturevalue("odoc_federation").history]
        fed = ShardedFederation(cfg, synthetic=True, limit_per_client=LIMIT, device=cuda_device)
        reset_kernel_counts()
        history = fed.run(num_rounds=2 * cfg.iters, progress=False)
        assert fed.mesh.shape == (1, 1) and len(history) == 2
        got = [[rec[f"client_{c}_total_loss"] for c in range(5)] for rec in history]
        gaps = [abs(g - w) / abs(w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
        assert max(gaps) <= 1e-3, (got, want)
        assert all(11 <= fed.ala_counters[c] <= 50 for c in range(5)), fed.ala_counters
        assert kernel_counts() == tree_on_counts(cfg.num_clients * 2 * cfg.iters)
        assert math.isfinite(history[-1]["val_mean_dice"])
    elif mesh == "gloo (1, 2)":
        first, want = _one_round(cuda_device, one_step)
        ranks = _ranks(one_step, "gloo", ["cuda:0"] * 2, tmp_path)
        _hold_first_steps(ranks, first, (1, 2), one_step)
        _hold_payloads(ranks, want, one_step)
    else:
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            pytest.skip(f"NCCL meshes over cards need two cards or more; this machine has {n_cards}")
        cards = [f"cuda:{i}" for i in range(n_cards)]
        first, want = _one_round(cuda_device, one_step)
        ranks = _ranks(one_step, "nccl", cards, tmp_path)
        _hold_first_steps(ranks, first, ranks[0]["mesh"], one_step)
        _hold_payloads(ranks, want, one_step)
        four = one_step.replace(num_clients=4)
        ranks = _ranks(four, "nccl", cards[:2], tmp_path)
        losses = [v for res in ranks for v, _ in res["first"].values()]
        assert ranks[0]["mesh"] == (2, 1) and all(math.isfinite(v) for v in losses), losses
        _hold_payloads(ranks, _one_round(cuda_device, four)[1], four)


# ---- the entry points -------------------------------------------------------


def federated_round_flags() -> list:
    """The flags of FedICRA "ours" rounds of 5 full-width ODOC clients x 2
    steps (1 head, 1 body) with evaluation every round, 2 rounds in all,
    which both the train CLI and the runner take."""
    return ["--img_class", "odoc", "--strategy", "FedICRA", "--procedure", "ours",
            "--model", "unet_lc_multihead", "--img_size", str(IMG), "--batch_size", str(BATCH),
            "--iters", "2", "--rep_iters", "1", "--eval_iters", "2", "--max_iterations", "4"]


def _route(fn):
    """(result, printed lines, kernel launches) of one entry point's call."""
    reset_kernel_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue().splitlines(), kernel_counts()


def _printed_json(lines, result) -> bool:
    return bool(lines) and json.loads(lines[-1]) == json.loads(json.dumps(result))


def _finite_losses(final: dict, clients: int) -> bool:
    return all(math.isfinite(final[f"client_{c}_total_loss"]) for c in range(clients))


@pytest.fixture(scope="module")
def train_cli_round(cuda_device, tmp_path_factory):
    """The federated train CLI as a user runs it, in process: 1 round of 5
    full-width ODOC clients, 2 steps each, on the synthetic splits' default
    24 images a client. Returns (result, printed lines, launches, snapshot
    root)."""
    from fedicra_torch.cli import train as train_cli

    snap_root = str(tmp_path_factory.mktemp("cli") / "model")
    argv = ["--synthetic", "--snapshot_root", snap_root, "--exp", "fed", *federated_round_flags(),
            "--stop_after", "2"]
    return (*_route(lambda: train_cli.main(argv)), snap_root)


@pytest.mark.parametrize("route", ["federated train", "test", "centralized", "runner"])
def test_an_entry_point_on_the_card(cuda_device, request, tmp_path, monkeypatch, route):
    """The user's entry points on the card, in process, each printing the
    JSON it returns as its last line.

    federated train (``train_cli_round``): finite losses, one gated-CRF,
    MST and rooting launch and four filter launches each way a local step;
    ``best_global`` written exactly when the weighted val dice beats 0.
    test: the test CLI's loader, inference, CSVs and PNGs on
    ``_federation``'s ODOC snapshot (2 rounds with ALA, where some clients
    beat dice 0 and wrote their own best) for client 0's synthetic val
    split: the weights by the own-best rule, the metric columns, finite
    metrics, ``result.csv``'s header, ``mean_std_result.csv`` and a 384^2
    PNG pair a case; no kernel launch.
    centralized: the ``unet`` baseline at FAZ's 256^2, 4 iterations, then
    again inside a profiler trace, whose one file holds the
    ``cli.centralized`` span; no kernel launch.
    runner: ``cli.runner`` at its defaults (FAZ, ``unet``, FedAvg, pCE,
    256^2, batch 12) from a working directory whose ../model lies in the
    test's: finite losses, ``../model/<exp>/metrics.jsonl`` written, no
    kernel launch."""
    from fedicra_torch.cli import runner as runner_cli
    from fedicra_torch.cli import test as test_cli
    from fedicra_torch.cli import train as train_cli

    if route == "federated train":
        result, lines, counts, snap_root = request.getfixturevalue("train_cli_round")
        assert _printed_json(lines, result)
        assert _finite_losses(result["final"], 5)
        assert counts == tree_on_counts(5 * 2)
        # best_global is written when the weighted val dice beats 0 (the
        # reference's rule); after 1 round from random weights it may not
        assert os.path.exists(os.path.join(snap_root, "fed", "best_global")) == (result["best_dice"] > 0)
    elif route == "test":
        from fedicra_torch.data import make_synthetic_split
        from fedicra_torch.models import net_factory

        # the card's machine has no h5py: the cases are client 0's synthetic
        # val split, as the federation made it
        snap = request.getfixturevalue("odoc_federation").snap
        split = make_synthetic_split(4, IMG, IMG, 3, 3, seed=100, sparse=False)
        model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5).to(cuda_device)
        out_dir = str(tmp_path / "fed_test" / "client0")
        expect = "best_client_0" if os.path.exists(os.path.join(snap, "best_client_0")) else "best_global"

        def test_route():
            payload, source = test_cli.load_test_weights(snap, "client0", cuda_device)
            rows = test_cli.run_inference(
                model, payload["params"], payload["batch_stats"], split.images, split.case_names,
                split.labels, "odoc", out_dir, emb_idx=0, device=cuda_device)
            test_cli.write_csvs(rows, out_dir)
            return source, rows

        (source, rows), _, counts = _route(test_route)
        assert source == expect
        metrics = [f"{m}{g}" for g in ("_cup", "_disc")
                   for m in ("dice", "jaccard", "HD95", "ASSD", "SE", "SP", "Rec", "Pre")]
        assert list(rows) == ["name"] + metrics and all(len(v) == len(split) for v in rows.values())
        assert all(math.isfinite(v) for k in metrics for v in rows[k])
        assert counts == ZERO_COUNTS
        with open(os.path.join(out_dir, "result.csv")) as f:
            assert f.readline().strip().split(",") == list(rows)
        pngs = sorted(os.listdir(os.path.join(out_dir, "pre")))
        assert len(pngs) == 2 * len(split) and os.path.exists(os.path.join(out_dir, "mean_std_result.csv"))
        for name in pngs:
            with open(os.path.join(out_dir, "pre", name), "rb") as f:
                head = f.read(24)
            assert head[:8] == test_cli.PNG_SIGNATURE and head[12:16] == b"IHDR", name
            assert struct.unpack(">II", head[16:24]) == (IMG, IMG), name
    elif route == "centralized":
        from fedicra_torch.utils.profiling import annotate, trace

        argv = ["--centralized", "--synthetic", "--img_class", "faz", "--model", "unet",
                "--max_iterations", "4", "--eval_iters", "2", "--limit_per_client", "24",
                "--img_size", "256", "--batch_size", str(BATCH),
                "--snapshot_root", str(tmp_path / "model"), "--exp", "central"]
        trace_dir = str(tmp_path / "trace")

        def traced():
            with trace(trace_dir), annotate("cli.centralized"):
                return train_cli.main(argv)

        for fn in (lambda: train_cli.main(argv), traced):
            rec, lines, counts = _route(fn)
            assert _printed_json(lines, rec)
            assert rec["iter"] == 4 and math.isfinite(rec["loss"]), rec
            assert counts == ZERO_COUNTS
        traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
        assert len(traces) == 1
        with open(traces[0]) as f:
            assert any(e.get("name") == "cli.centralized" for e in json.load(f)["traceEvents"])
    else:
        run_dir = tmp_path / "run"
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        result, lines, counts = _route(lambda: runner_cli.main(
            ["--procedure", "flower_pCE_2D", "--exp", "smoke", "--synthetic",
             "--max_iterations", "2", "--iters", "2"]))
        assert _printed_json(lines, result)
        assert _finite_losses(result["final"], 5)
        assert counts == ZERO_COUNTS
        assert (tmp_path / "model" / "smoke" / "metrics.jsonl").exists()


@pytest.mark.parametrize("model_type", ["pnet", "efficient_unet"])
def test_a_model_type_through_the_train_cli_under_amp(cuda_device, tmp_path, monkeypatch, model_type):
    """``pnet`` and ``efficient_unet`` through the federated train CLI under
    ``--amp 1``: FedAvg, pCE, ODOC at 384^2, 1 round of 5 clients x 2 steps,
    evaluation at iteration 2. The last printed line is the returned JSON;
    finite losses; no kernel launch; training logits in JAX's AMP dtypes
    (its AMP reaches ``pnet``'s bare convolutions nowhere: fp32;
    ``efficient_unet``'s classifier computes in bf16). ``efficient_unet``
    loads a synthetic efficientnet-pytorch B3 file as ``--encoder_weights``:
    every encoder leaf equals the file's."""
    import torch.nn.modules.module as module_hooks

    import fedicra_torch.federation.experiment as experiment
    from fedicra_torch.cli import train as train_cli
    from fedicra_torch.models.efficientunet import EffiUNet, convert_torch_encoder_state_dict
    from fedicra_torch.models.pnet import PNet2D
    from torch_efficientnet_mirror import make_b3_state_dict

    cls = PNet2D if model_type == "pnet" else EffiUNet
    extra = []
    if model_type == "efficient_unet":
        b3 = make_b3_state_dict(in_chns=3, seed=0)
        torch.save(b3, tmp_path / "efficientnet-b3.pth")
        extra = ["--encoder_weights", str(tmp_path / "efficientnet-b3.pth")]
    argv = ["--synthetic", "--img_class", "odoc", "--strategy", "FedAvg", "--procedure", "pce",
            "--model", model_type, "--amp", "1", "--img_size", str(IMG), "--batch_size", str(BATCH),
            "--iters", "2", "--eval_iters", "2", "--stop_after", "2", "--limit_per_client", "12",
            "--snapshot_root", str(tmp_path / "model"), "--exp", model_type,
            "--device", str(cuda_device)] + extra
    logits, states = set(), []

    def hook(module, args, out):
        if isinstance(module, cls) and module.training:
            logits.add(str(out["logits"].dtype).replace("torch.", ""))

    init = experiment.init_client_state

    def recording_init(*args, **kwargs):
        states.append(init(*args, **kwargs))
        return states[-1]

    monkeypatch.setattr(experiment, "init_client_state", recording_init)
    handle = module_hooks.register_module_forward_hook(hook)
    try:
        result, lines, counts = _route(lambda: train_cli.main(argv))
    finally:
        handle.remove()
    assert _printed_json(lines, result)
    assert _finite_losses(result["final"], 5)
    assert counts == ZERO_COUNTS
    assert logits == ({"float32"} if model_type == "pnet" else {"bfloat16"})
    if model_type == "efficient_unet":
        loaded = {**states[0].params, **states[0].batch_stats}
        for k, v in convert_torch_encoder_state_dict(b3).items():
            assert torch.equal(loaded[f"encoder.{k}"].cpu(), v), k


def test_the_distributed_runner_matches_the_in_process_round(cuda_device, tmp_path, train_cli_round):
    """The runner's ``--distributed`` route as a user starts it, from a
    working directory of its own: 1 server and 5 client processes on the
    card, over TCP, for 2 rounds whose first is ``train_cli_round``'s. Every
    process exits 0 (the runner raises otherwise) and reports its peak
    memory; ``metrics.jsonl`` holds both rounds' fit and evaluate records;
    each client's first-round fit loss lies within rtol 1e-3 of the
    in-process round's; every metric is finite (hd95 aside, NaN where a mask
    is empty, as in JAX). The processes' kernel launches cannot be counted
    from here; their CUDA tensors have no route but the kernels."""
    from fedicra_torch.parallel.launch import free_port

    route1 = train_cli_round[0]
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    cmd = [sys.executable, "-m", "fedicra_torch.cli.runner", "--exp", "dist", "--synthetic",
           "--distributed", "--port", str(free_port()), *federated_round_flags()]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(cmd, cwd=run_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:  # stop the runner and every process it started
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    lines = out.splitlines()
    assert proc.returncode == 0, "\n".join(lines[-40:])
    assert len([line for line in lines if "peak memory" in line]) == 6, lines
    with open(tmp_path / "model" / "dist" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [2, 2, 4, 4]
    for c in range(5):
        got, want = records[0][f"client_{c}_total_loss"], route1["final"][f"client_{c}_total_loss"]
        assert abs(got - want) <= 1e-3 * abs(want), (c, got, want)
    nonfinite = {k for r in records for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)}
    assert all("hd95" in k for k in nonfinite), nonfinite
