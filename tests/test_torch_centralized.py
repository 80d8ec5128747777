"""The port's centralized pCE baseline against the torch golden and JAX (CPU).

The "SGD tight" class of ``tests/test_reference_parity.py``: the batches are
``tests/gen_reference_trajectory.py``'s (client 0's 15 batches), the start is
JAX's initial ``unet`` weights carried through the weight bridge. Step 1 at
atol 2e-5, every step within 0.02, the final parameter abs-sum at rtol 1e-3;
against JAX's own run also the final weights' median absolute difference
within 1e-6. Both runs evaluate at iterations 7 and 14 on one val split.
"""

import json

import jax
import numpy as np
import pytest
import torch

import gen_reference_trajectory as gen
from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.data import make_synthetic_split
from fedicra_torch.engine.centralized import train_centralized
from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.engine.trainer import ClientState
from fedicra_torch.models import net_factory as port_net_factory
from torch_port_helpers import NO_DROPOUT, one_torch_thread  # noqa: F401

ITERS = gen.CONFIG["rounds"] * gen.CONFIG["iters"]
EVAL_ITERS = 7


class ArrayBatcher:
    """``batch_at(it)`` over fixed numpy arrays."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def batch_at(self, it):
        return {"image": self.images[it], "label": self.labels[it]}


@pytest.fixture(scope="module")
def runs():
    """(golden, port run, JAX run) on the same batches, weights and val split."""
    with open(gen.GOLDEN_PATH) as f:
        golden = json.load(f)
    assert golden["config"] == gen.CONFIG
    model_j, tc, state_j = gen.make_jax_model_and_state()
    b = gen.make_batches()[0]
    flat = {k: b[k].reshape(-1, *b[k].shape[2:]) for k in ("image", "label")}
    cfg = gen.CONFIG
    val = make_synthetic_split(2, cfg["img_size"], cfg["img_size"], cfg["in_chns"],
                               cfg["num_classes"], seed=1, sparse=False)

    from fedicra_tpu.engine.centralized import train_centralized as jax_train_centralized

    losses_j = []
    state_dict_j, history_j = jax_train_centralized(
        model_j, tc, train_split=None, val_split=val, max_iterations=ITERS,
        eval_iters=EVAL_ITERS, batcher=gen.InjectedBatcher(flat["image"], flat["label"]),
        loss_log=losses_j,
    )

    params = jax.tree.map(np.asarray, state_j.params)
    stats = jax.tree.map(np.asarray, state_j.batch_stats)
    model_p = port_net_factory("unet", in_chns=cfg["in_chns"], class_num=cfg["num_classes"],
                               dropout=NO_DROPOUT)
    names = {n for n, _ in model_p.named_parameters()}
    sd = flax_to_state_dict(params, stats)
    init = ClientState(
        {k: v for k, v in sd.items() if k in names},
        {k: v for k, v in sd.items() if k not in names},
        0, torch.Generator().manual_seed(0),
    )
    cfg_p = PortConfig.for_task(
        "odoc", img_size=cfg["img_size"], batch_size=cfg["batch_size"],
        max_iterations=cfg["max_iterations"], base_lr=cfg["base_lr"], strategy="FedAvg",
        procedure="pce", model="unet",
    )
    losses_p = []
    state_p, history_p = train_centralized(
        model_p, cfg_p, None, val, max_iterations=ITERS, eval_iters=EVAL_ITERS,
        batcher=ArrayBatcher(flat["image"], flat["label"]), loss_log=losses_p,
        init_state=init, device="cpu",
    )
    port = {"losses": np.asarray(losses_p), "history": history_p,
            "params": state_dict_to_flax({**state_p["params"], **state_p["batch_stats"]})[0]}
    jax_run = {"losses": np.asarray(losses_j), "history": history_j,
               "params": jax.tree.map(np.asarray, state_dict_j["params"])}
    return golden, port, jax_run


def _abssum(params):
    return float(sum(np.abs(a).sum() for a in jax.tree.leaves(params)))


def test_against_the_torch_golden(runs):
    golden, port, _ = runs
    ref, got = np.asarray(golden["sgd_losses"]), port["losses"]
    assert got.shape == ref.shape == (ITERS,)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=0)
    assert np.abs(got - ref).max() < 0.02, np.abs(got - ref).max()
    np.testing.assert_allclose(_abssum(port["params"]), golden["sgd_final_param_abssum"], rtol=1e-3)


def test_against_jax_train_centralized(runs):
    _, port, ref = runs
    got, want = port["losses"], ref["losses"]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    assert np.abs(got - want).max() < 0.02, np.abs(got - want).max()
    np.testing.assert_allclose(_abssum(port["params"]), _abssum(ref["params"]), rtol=1e-3)
    diffs = np.concatenate([
        np.abs(a - b).ravel()
        for a, b in zip(jax.tree.leaves(port["params"]), jax.tree.leaves(ref["params"]))
    ])
    assert jax.tree.structure(port["params"]) == jax.tree.structure(ref["params"])
    assert np.median(diffs) <= 1e-6, np.median(diffs)


def test_eval_cadence_and_history_records(runs):
    _, port, ref = runs
    assert [r["iter"] for r in port["history"]] == [r["iter"] for r in ref["history"]] == [7, 14]
    for rec_p, rec_j in zip(port["history"], ref["history"]):
        assert list(rec_p) == list(rec_j)
        assert rec_p["loss"] == pytest.approx(rec_j["loss"], abs=0.02)
