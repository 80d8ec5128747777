"""The port stands alone: no JAX stack in its imports (package, chip_smoke.py
and the port's profiling tool), no silent CPU runs."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedicra_tpu")
PORT_FILES = sorted((ROOT / "fedicra_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_round.py",
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_stack(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 10 and (ROOT / "chip_smoke.py").exists()


def test_port_files_include_every_package_of_the_port():
    found = {p.parent.name for p in PORT_FILES}
    assert {"federation", "data", "evaluation", "utils", "engine", "ops", "cli", "models",
            "parallel"} <= found
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"fedicra_torch/models/pnet.py", "fedicra_torch/models/efficientunet.py",
            "fedicra_torch/ops/activations.py", "fedicra_torch/federation/transport.py",
            "fedicra_torch/evaluation/uncertainty.py", "fedicra_torch/ops/permutohedral.py",
            "fedicra_torch/losses/gated_crf.py", "fedicra_torch/losses/dense_crf.py",
            "fedicra_torch/parallel/mesh.py", "fedicra_torch/parallel/data_axis.py",
            "fedicra_torch/parallel/launch.py", "fedicra_torch/federation/sharded.py",
            "fedicra_torch/federation/sharded_experiment.py"} <= names


def _entry_calls(tmp_path):
    """Each entry point of the port, called as a user would, without ``device``."""
    import numpy as np

    import socket

    from fedicra_torch.cli import runner as runner_cli
    from fedicra_torch.cli import test as test_cli
    from fedicra_torch.cli import train as train_cli
    from fedicra_torch.data import EpochBatcher, make_synthetic_split
    from fedicra_torch.engine import trainer
    from fedicra_torch.engine.centralized import train_centralized
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.evaluation import evaluate_client, evaluate_uncertainty
    from fedicra_torch.federation import build_experiment
    from fedicra_torch.federation.sharded_experiment import run_sharded
    from fedicra_torch.federation.transport import RemoteClientProxy, accept_clients
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, tree_loss_weight=0.0)
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3)
    amp_cfg = cfg.replace(amp=True)
    eff_cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, model="efficient_unet",
                                   strategy="FedAvg", procedure="pce")
    split = make_synthetic_split(2, 32, 32, 3, 3, seed=0, sparse=False)
    sd = model.state_dict()
    names = {n for n, _ in model.named_parameters()}
    return model, {
        "make_round_fn": lambda: trainer.make_round_fn(model, cfg),
        "make_round_fn amp": lambda: trainer.make_round_fn(model, amp_cfg),
        "init_client_state": lambda: trainer.init_client_state(model, cfg),
        "init_client_state pnet": lambda: trainer.init_client_state(
            net_factory("pnet", in_chns=3, class_num=3), cfg.replace(model="pnet")),
        "init_client_state efficient_unet": lambda: trainer.init_client_state(
            net_factory("efficient_unet", in_chns=3, class_num=3), eff_cfg),
        "build_experiment": lambda: build_experiment(cfg, synthetic=True, limit_per_client=2),
        "EpochBatcher": lambda: EpochBatcher(split, 2, 3, "odoc"),
        "evaluate_client": lambda: evaluate_client(
            model, {k: v for k, v in sd.items() if k in names},
            {k: v for k, v in sd.items() if k not in names},
            split.images, split.labels.astype(np.int64), 3),
        "train_centralized": lambda: train_centralized(
            model, cfg.replace(strategy="FedAvg", procedure="pce"), split, split, max_iterations=1),
        "cli.train": lambda: train_cli.main(
            ["--synthetic", "--img_size", "32", "--batch_size", "2", "--limit_per_client", "2",
             "--snapshot_root", str(tmp_path)]),
        "cli.train amp": lambda: train_cli.main(
            ["--synthetic", "--img_size", "32", "--batch_size", "2", "--limit_per_client", "2",
             "--amp", "1", "--snapshot_root", str(tmp_path)]),
        "cli.train pnet": lambda: train_cli.main(
            ["--synthetic", "--img_size", "32", "--batch_size", "2", "--limit_per_client", "2",
             "--model", "pnet", "--strategy", "FedAvg", "--procedure", "pce",
             "--snapshot_root", str(tmp_path)]),
        "cli.train efficient_unet": lambda: train_cli.main(
            ["--synthetic", "--img_size", "32", "--batch_size", "2", "--limit_per_client", "2",
             "--model", "efficient_unet", "--strategy", "FedAvg", "--procedure", "pce",
             "--snapshot_root", str(tmp_path)]),
        "cli.test.load_test_weights": lambda: test_cli.load_test_weights(
            str(tmp_path / "exp"), "client0"),
        "evaluate_uncertainty": lambda: evaluate_uncertainty(
            model, {k: v for k, v in sd.items() if k in names},
            {k: v for k, v in sd.items() if k not in names}, [split.images]),
        "RemoteClientProxy": lambda: RemoteClientProxy(socket.socket(), 0, 1),
        "accept_clients": lambda: accept_clients("127.0.0.1", 0, 1, timeout=0.1),
        "cli.runner --distributed": lambda: runner_cli.main(
            ["--procedure", "pce", "--exp", "x", "--synthetic", "--distributed"]),
        "run_sharded": lambda: run_sharded(cfg, synthetic=True, limit_per_client=2,
                                           snapshot_dir=str(tmp_path / "sharded")),
        "cli.train --sharded": lambda: train_cli.main(
            ["--synthetic", "--sharded", "--img_size", "32", "--batch_size", "2",
             "--limit_per_client", "2", "--snapshot_root", str(tmp_path)]),
    }


@pytest.mark.parametrize(
    "entry", ["make_round_fn", "init_client_state", "build_experiment", "EpochBatcher",
              "evaluate_client", "train_centralized", "cli.train", "cli.test.load_test_weights",
              "make_round_fn amp", "init_client_state pnet", "init_client_state efficient_unet",
              "cli.train amp", "cli.train pnet", "cli.train efficient_unet",
              "evaluate_uncertainty", "RemoteClientProxy", "accept_clients",
              "cli.runner --distributed", "cli.train --sharded", "run_sharded"]
)
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, calls = _entry_calls(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert next(model.parameters()).device.type == "cpu"
