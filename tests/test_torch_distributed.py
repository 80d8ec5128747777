"""The runner's ``--distributed`` route (1 server + N client processes over
TCP) against its in-process route, and two faults of JAX's distributed
runner that the port does not inherit (CPU).

Each run starts from its own temporary working directory, since both
routes write to ``../model/<exp>``. The spawned processes take one torch
thread each (``OMP_NUM_THREADS=1``), as the in-process route does here, so
that the two routes run the same arithmetic.
"""

import argparse
import json
import multiprocessing

import pytest

from fedicra_torch.cli import runner as port_runner
from fedicra_tpu.cli import runner as jax_runner
from torch_port_helpers import free_port, one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = ["--synthetic", "--img_size", "16", "--batch_size", "2", "--iters", "2",
         "--max_iterations", "4", "--eval_iters", "2", "--rep_iters", "1"]
CASES = {
    "pce-FedAvg": ["--procedure", "flower_pCE_2D", "--strategy", "FedAvg", "--model", "unet",
                   "--img_class", "faz"],
    "ours-FedICRA": ["--procedure", "ours", "--strategy", "FedICRA",
                     "--model", "unet_lc_multihead", "--img_class", "odoc"],
}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run(tmp_path, monkeypatch, exp, argv):
    work = tmp_path / f"work_{exp}"
    work.mkdir()
    monkeypatch.chdir(work)
    port_runner.main(argv + ["--exp", exp], device="cpu")
    return _records(tmp_path / "model" / exp / "metrics.jsonl")


@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_route_equals_the_in_process_route(tmp_path, monkeypatch, case):
    """The same flags through both routes log the same per-client losses and
    val metrics, and the same aggregates of them, bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = CASES[case] + SMALL
    local = _run(tmp_path, monkeypatch, "local", argv)
    dist = _run(tmp_path, monkeypatch, "dist", argv + ["--distributed", "--port", str(free_port())])

    # per round: the fit record, then the evaluation's; the in-process
    # FedAvg server also logs its central evaluation (JAX's distributed
    # server has none)
    local = [r for r in local if not any(k.startswith("central_") for k in r)]
    assert [r["step"] for r in dist] == [r["step"] for r in local] == [2, 2, 4, 4]
    compared = 0
    for got, want in zip(dist, local):
        keys = {k for k in want if k.startswith(("client_", "val_"))}
        assert keys == {k for k in got if k.startswith(("client_", "val_"))}
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        compared += len(keys)
    losses = [k for k in local[0] if k.endswith("_total_loss")]
    assert len(losses) == 5 and compared > 100


def _namespace(**kw):
    base = dict(model="unet_lc_multihead", strategy="FedICRA", max_iterations=4, iters=2,
                eval_iters=2, batch_size=2, base_lr=0.01, alpha=0.5, rep_iters=1,
                tree_loss_weight=0.1, amp=0, img_class="odoc", img_size=16, encoder_weights=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_build_cfg_trains_the_in_process_configuration():
    """JAX's distributed route drops --img_size (ODOC trains at 384^2 there,
    at --img_size in-process); the port's passes it, and --encoder_weights."""
    args = _namespace()
    assert jax_runner._build_cfg(args, "ours").img_size == 384
    cfg = port_runner._build_cfg(args, "ours")
    assert cfg.img_size == 16 and cfg.encoder_weights is None
    cfg = port_runner._build_cfg(_namespace(model="efficient_unet", strategy="FedAvg",
                                           encoder_weights="b3.pth"), "pce")
    assert cfg.encoder_weights == "b3.pth" and cfg.model == "efficient_unet"


def test_a_crashing_client_makes_the_runner_raise(tmp_path, monkeypatch):
    """Clients without data exit with code 1; the runner stops the
    processes still running (the server would wait for them to register)
    and raises, naming each process by role, cid and exit code."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    argv = CASES["pce-FedAvg"] + ["--exp", "crash", "--root_path", str(tmp_path / "no_data"),
                                  "--distributed", "--port", str(free_port())]
    with pytest.raises(RuntimeError, match=r"^distributed run failed: client \d exited with code 1") as err:
        port_runner.main(argv, device="cpu")
    assert "stopped server" in str(err.value)


class _FailingProcess:
    """A process that exits with code 1 as soon as it starts."""

    def __init__(self, target, args):
        self.target, self.exitcode, self.pid = target, None, None

    def start(self):
        self.exitcode, self.pid = 1, 0

    def is_alive(self):
        return False

    def join(self, timeout=None):
        pass

    def terminate(self):
        pass


class _FailingContext:
    Process = _FailingProcess


def test_jax_runner_ignores_exit_codes_and_the_port_raises(monkeypatch):
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: _FailingContext)
    args = _namespace(port=free_port(), procedure="ours", exp="x")
    task = {"sup_types": {f"client{c}": "scribble" for c in range(5)}}
    assert jax_runner._run_distributed(args, "ours", task) is None
    with pytest.raises(RuntimeError) as err:
        port_runner._run_distributed(args, "ours", task, device="cpu")
    assert str(err.value).startswith("distributed run failed: server exited with code 1; client 0")

