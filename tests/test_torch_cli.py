"""The port's CLIs (runner, train, test) against fedicra_tpu's (CPU)."""

import csv
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from fedicra_torch.cli import runner as port_runner
from fedicra_torch.cli import test as port_test
from fedicra_torch.cli import train as port_train
from fedicra_torch.convert import flax_to_state_dict
from fedicra_torch.engine.trainer import ClientState
from fedicra_torch.utils.checkpoint import CheckpointManager
from fedicra_tpu.cli import runner as jax_runner
from fedicra_tpu.cli import test as jax_test
from torch_port_helpers import one_torch_thread  # noqa: F401

TASK_NAMES = ("odoc", "faz", "polyp")


@pytest.mark.parametrize("task", TASK_NAMES)
@pytest.mark.parametrize("alias", sorted(jax_runner.PROCEDURE_ALIASES))
def test_runner_debug_output_equals_jax(alias, task, capsys):
    argv = ["--procedure", alias, "--exp", "x", "--img_class", task, "--debug", "1"]
    jax_runner.main(argv)
    want = capsys.readouterr().out
    assert port_runner.main(argv) is None
    assert capsys.readouterr().out == want
    assert f"--procedure {jax_runner.PROCEDURE_ALIASES[alias]}" in want


def test_runner_aliases_equal_jax():
    assert port_runner.PROCEDURE_ALIASES == jax_runner.PROCEDURE_ALIASES


@pytest.mark.parametrize("argv", [
    ["--procedure", "nope", "--exp", "x", "--img_class", "odoc", "--debug", "1"],
    ["--procedure", "pce", "--exp", "x", "--img_class", "brains", "--debug", "1"],
], ids=["procedure", "img_class"])
def test_runner_rejects_unknown_values(argv):
    with pytest.raises(AssertionError):
        port_runner.main(argv)


@pytest.mark.parametrize("task,n_clients", [("odoc", 5), ("faz", 5), ("polyp", 4)])
def test_task_tables_match_jax(task, n_clients):
    from fedicra_torch.engine.config import TASKS
    from fedicra_tpu.engine.config import TASKS as JAX_TASKS

    assert TASKS[task] == JAX_TASKS[task]
    assert len(TASKS[task]["sup_types"]) == n_clients


def _refuse_models(monkeypatch):
    """Make every way the CLI builds a model fail loudly."""
    import fedicra_torch.federation.experiment as experiment
    import fedicra_torch.models as models
    import fedicra_torch.models.factory as factory

    def boom(*a, **k):
        raise AssertionError("net_factory called before the data-root check")

    for mod in (models, factory, experiment):
        monkeypatch.setattr(mod, "net_factory", boom)


@pytest.mark.parametrize("centralized", [False, True], ids=["federated", "centralized"])
def test_missing_data_root_refuses_before_any_model(tmp_path, monkeypatch, centralized):
    _refuse_models(monkeypatch)
    argv = ["--img_class", "odoc", "--exp", "guard", "--procedure", "pce",
            "--snapshot_root", str(tmp_path), "--stop_after", "2",
            "--limit_per_client", "2", "--img_size", "16", "--batch_size", "2",
            "--iters", "1", "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        port_train.main(argv + (["--centralized"] if centralized else []))
    with pytest.raises(FileNotFoundError):
        port_train.main(argv + ["--root_path", str(tmp_path / "nope")])


def test_sharded_and_distributed_are_refused(tmp_path, monkeypatch):
    """--sharded (TPU mesh only) is refused. --distributed runs 1 server and
    N client processes (tests/test_torch_distributed.py); without a card,
    and no device named, it is refused before any model or process."""
    import multiprocessing

    _refuse_models(monkeypatch)
    with pytest.raises(NotImplementedError, match="sharded"):
        port_train.main(["--synthetic", "--sharded", "--device", "cpu",
                         "--snapshot_root", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_runner.main(["--procedure", "pce", "--exp", "x", "--synthetic", "--distributed"])


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


def test_train_cli_federated_on_cpu(tmp_path, capsys):
    result = port_train.main([
        "--synthetic", "--device", "cpu", "--img_class", "odoc", "--strategy", "FedICRA",
        "--procedure", "pce", "--model", "unet_lc_multihead", "--img_size", "16",
        "--batch_size", "2", "--iters", "2", "--rep_iters", "1", "--eval_iters", "2",
        "--stop_after", "2", "--limit_per_client", "2", "--snapshot_root", str(tmp_path),
        "--exp", "fed",
    ])
    printed = _last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(result))
    assert set(printed) == {"final", "best_dice"}
    losses = [printed["final"][f"client_{c}_total_loss"] for c in range(5)]
    assert np.isfinite(losses).all()
    assert (tmp_path / "fed" / "metrics.jsonl").exists()


def test_train_cli_centralized_on_cpu(tmp_path, capsys):
    port_train.main([
        "--centralized", "--synthetic", "--device", "cpu", "--img_class", "faz",
        "--model", "unet", "--img_size", "16", "--batch_size", "2",
        "--max_iterations", "4", "--eval_iters", "2", "--limit_per_client", "4",
        "--snapshot_root", str(tmp_path), "--exp", "central",
    ])
    rec = _last_json(capsys.readouterr().out)
    assert rec["iter"] == 4 and np.isfinite(rec["loss"]) and "mean_dice" in rec
    lines = (tmp_path / "central" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [2, 4]


def _blobs(seed, h=48, w=48):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(2):
        cy, cx, r = rng.integers(12, 36), rng.integers(12, 36), rng.integers(5, 11)
        out.append(((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.int64))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_case_metrics_match_jax_on_blobs(seed):
    pred, gt = _blobs(seed)
    got, want = port_test.case_metrics(pred, gt), jax_test.case_metrics(pred, gt)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)


def test_case_metrics_with_the_fallback_dot_match_jax():
    empty = np.zeros((256, 256), np.int64)
    _, gt = _blobs(3, 256, 256)
    dot_p, dot_j = port_test._draw_fallback_dot(empty), jax_test._draw_fallback_dot(empty)
    np.testing.assert_array_equal(dot_p, dot_j)
    assert dot_p.sum() == 5 and dot_p[192, 192] == 1
    got, want = port_test.case_metrics(dot_p, gt), jax_test.case_metrics(dot_j, gt)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)
    assert port_test.case_metrics(empty, gt) == jax_test.case_metrics(empty, gt)


def test_case_metrics_odoc_cup_and_disc_groups_match_jax():
    a, b = _blobs(4)
    pred, gt = a + (np.roll(a, 3, 1) > 0), np.clip(b + a, 0, 2)  # labels 0..2
    for p, g in ((pred == 1, gt == 1), (pred >= 1, gt >= 1)):
        got, want = port_test.case_metrics(p, g), jax_test.case_metrics(p, g)
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_csvs_equal(got_path, want_path):
    head_g, rows_g = _read_csv(got_path)
    head_w, rows_w = _read_csv(want_path)
    assert head_g == head_w
    assert len(rows_g) == len(rows_w)
    for rg, rw in zip(rows_g, rows_w):
        assert rg[0] == rw[0]  # name
        g = np.array([float(v) if v else np.nan for v in rg[1:]])
        w = np.array([float(v) if v else np.nan for v in rw[1:]])
        np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True)


def _jax_lc_weights(in_chns, classes, img, seed=0):
    from fedicra_tpu.models import net_factory

    jm = net_factory("unet_lc_multihead", in_chns=in_chns, class_num=classes, num_clients=5)
    v = jm.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
                np.zeros((1, img, img, in_chns), np.float32), train=False)
    return jm, jax.tree.map(np.asarray, dict(v))


def _port_payload(v, model):
    names = {n for n, _ in model.named_parameters()}
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    return ({k: t for k, t in sd.items() if k in names},
            {k: t for k, t in sd.items() if k not in names})


@pytest.mark.parametrize("img_class", ["odoc", "faz"])
def test_inference_csvs_and_pngs_equal_jax(tmp_path, img_class):
    from fedicra_torch.models import net_factory as port_net_factory

    in_chns, classes = (3, 3) if img_class == "odoc" else (1, 2)
    jm, v = _jax_lc_weights(in_chns, classes, 32)
    pm = port_net_factory("unet_lc_multihead", in_chns=in_chns, class_num=classes)
    params, stats = _port_payload(v, pm)
    rng = np.random.default_rng(9)
    images = rng.normal(size=(3, 32, 32, in_chns)).astype(np.float32)
    labels = rng.integers(0, classes, size=(3, 32, 32)).astype(np.uint8)
    names = [f"Domain1/test/case{i}.h5" for i in range(3)]
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    rows_p = port_test.run_inference(pm, params, stats, images, names, labels, img_class,
                                     str(out_p), emb_idx=0, device="cpu")
    rows_j = jax_test.run_inference(jm, v["params"], v["batch_stats"], images, names, labels,
                                    img_class, str(out_j), emb_idx=0)
    assert list(rows_p) == list(rows_j)
    assert len(rows_p) == 1 + (16 if img_class == "odoc" else 8)
    port_test.write_csvs(rows_p, str(out_p))
    jax_test.write_csvs(rows_j, str(out_j))
    for name in ("result.csv", "mean_std_result.csv"):
        _assert_csvs_equal(out_p / name, out_j / name)
    pngs = sorted(p.name for p in (out_j / "pre").glob("*.png"))
    assert pngs == sorted(p.name for p in (out_p / "pre").glob("*.png")) and len(pngs) == 6
    for name in pngs:
        got = cv2.imread(str(out_p / "pre" / name), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(out_j / "pre" / name), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.shape == (32, 32)
        np.testing.assert_array_equal(got, want)


def test_png_writer_round_trips_through_cv2(tmp_path):
    a = np.random.default_rng(0).integers(0, 256, size=(7, 13)).astype(np.uint8)
    port_test.write_png(str(tmp_path / "a.png"), a)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED), a)


def _write_faz_h5(root):
    """Small FAZ-shaped HDF5 files (5 domains, 1 channel, 2 classes)."""
    import h5py

    rng = np.random.default_rng(0)
    for d in range(1, 6):
        for sub in ("train", "test"):
            ddir = root / f"Domain{d}" / sub
            ddir.mkdir(parents=True)
            for i in range(3):
                with h5py.File(ddir / f"case{i}.h5", "w") as f:
                    img = rng.random((16, 16), np.float32)
                    f["image"] = img
                    f["mask"] = (img > 0.5).astype(np.uint8)


@pytest.mark.parametrize("own_best", [True, False], ids=["best_client_0", "best_global"])
def test_test_cli_main_end_to_end(tmp_path, capsys, own_best):
    from fedicra_torch.models import net_factory as port_net_factory

    _write_faz_h5(tmp_path / "FAZ_h5")
    _, v = _jax_lc_weights(1, 2, 16)
    pm = port_net_factory("unet_lc_multihead", in_chns=1, class_num=2)
    params, stats = _port_payload(v, pm)
    ckpt = CheckpointManager(str(tmp_path / "model" / "exp1"))
    ckpt.save_best({"params": params, "batch_stats": stats}, 2, 0.5)
    if own_best:
        own = {k: t * 0.5 for k, t in params.items()}
        ckpt.save_client_best(0, ClientState(own, stats, 2, torch.Generator()), 2, 0.6)
    rows = port_test.main([
        "--root_path", str(tmp_path), "--img_class", "faz", "--client", "client0",
        "--exp", "exp1", "--snapshot_root", str(tmp_path / "model"),
        "--model", "unet_lc_multihead", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    source = "best_client_0" if own_best else "best_global"
    assert f"init weight from {source}" in out and "avg dice:" in out
    res = tmp_path / "model" / "exp1_test" / "client0"
    head, body = _read_csv(res / "result.csv")
    assert head == list(rows) and len(body) == 3
    assert [r[0] for r in body] == [f"Domain1/test/case{i}.h5" for i in range(3)]
    assert (res / "mean_std_result.csv").exists()
    assert len(list((res / "pre").glob("*.png"))) == 6
