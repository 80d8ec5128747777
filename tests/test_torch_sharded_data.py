"""The data axis of the sharded federation over gloo ranks on the CPU:
meshes with one to four ranks against the single-process round, and the
federation's loop over ranks against its one-process run.

Every rank is a spawned process with one torch thread (``OMP_NUM_THREADS=1``,
as in this process), in a process group over gloo on a free local port.
"""

import numpy as np
import pytest
import torch

from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.engine.trainer import poly_lr
from fedicra_torch.federation.sharded_experiment import run_sharded
from torch_port_helpers import (  # noqa: F401 (fixtures: autouse)
    data_axis_round, data_axis_round_rank, one_thread_per_rank, one_torch_thread, spawned,
)

# mesh: (clients, ranks, batch); the client axis is the largest divisor of
# the ranks that divides the clients, so 3 clients over 2 ranks give (1, 2)
DATA_AXIS_CASES = {
    "(2,1)": (2, 2, 2),
    "(1,2)": (3, 2, 2),
    "(2,2)": (2, 4, 4),
    "(1,2) uneven, batch 3": (3, 2, 3),
}


@pytest.mark.parametrize("case", sorted(DATA_AXIS_CASES))
def test_ranks_equal_the_single_process_round(tmp_path, case):
    """FedICRA "ours" with the tree term and dropout on, one step after ALA's
    epoch drawn afresh: each mesh against the same round on (1, 1). The
    losses at atol 5e-5 (a first step), the ALA epochs exactly, the global
    BatchNorm statistics at the train-mode tolerance of
    tests/test_torch_model_family.py (atol 5e-5 + rtol 5e-5), the global
    weights to one Adam step's envelope with the median element at 1e-6. Two
    groups are held to the envelope only: a conv bias before a BatchNorm,
    whose gradient is rounding noise that Adam turns into a step of +-lr, and
    the DSN heads, whose gradients from the tree term lie near Adam's eps
    (1e-8) at this size, so that the step follows their rounding (ROADMAP.md
    section 3 holds them so after a tree-on round)."""
    num_clients, world_size, batch_size = DATA_AXIS_CASES[case]
    want_clients, want = data_axis_round(num_clients, batch_size)
    ranks = spawned(tmp_path, data_axis_round_rank, (num_clients, batch_size), world_size)
    got_clients = {}
    for per_client, payload in ranks:
        # the ranks of a data group hold the same clients, equal bit for bit,
        # and every rank the same global payload
        for cid, value in per_client.items():
            assert got_clients.setdefault(cid, value) == value
        for part in payload:
            assert all(np.array_equal(payload[part][k], ranks[0][1][part][k]) for k in payload[part])
    assert sorted(got_clients) == list(range(num_clients))
    np.testing.assert_allclose([got_clients[c][0] for c in range(num_clients)],
                               [want_clients[c][0] for c in range(num_clients)], atol=5e-5, rtol=0)
    assert [got_clients[c][1] for c in range(num_clients)] == [4] * num_clients
    got = ranks[0][1]
    for k, w in want["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], w, atol=5e-5, rtol=5e-5, err_msg=k)
    envelope = 2 * poly_lr(0.01, 9, 100)
    for k, w in want["params"].items():
        d = np.abs(got["params"][k] - w)
        assert d.max() <= envelope, k
        if not (k.endswith(".conv.bias") or ".dsn_head" in k):
            assert np.median(d) <= 1e-6, (k, float(np.median(d)))


def test_federation_over_ranks_equals_its_one_process_run(tmp_path):
    """The sharded federation's loop (batchers, ALA epochs from the split
    arrays, evaluation on each client's rank, the records gathered to rank 0)
    over two gloo ranks, one client each, equals the same run in one
    process bit for bit: each client's arithmetic is the same on either
    mesh. Rank 0 alone writes metrics.jsonl."""
    cfg = TrainConfig.for_task("odoc", img_size=16, batch_size=2, iters=1, rep_iters=1,
                               eval_iters=1, max_iterations=8, ala_skip_iters=0,
                               tree_loss_weight=0.0).replace(num_clients=2)
    kw = dict(synthetic=True, limit_per_client=2, num_rounds=2)
    one = run_sharded(cfg, devices=["cpu"], snapshot_dir=str(tmp_path / "one"), **kw)
    two = run_sharded(cfg, devices=["cpu", "cpu"], backend="gloo",
                      snapshot_dir=str(tmp_path / "two"), **kw)
    assert one["mesh"] == (1, 1) and two["mesh"] == (2, 1)
    assert [r["round"] for r in two["history"]] == [1, 2]
    for a, b in zip(one["history"], two["history"]):
        a, b = dict(a), dict(b)
        a.pop("round_duration"), b.pop("round_duration")
        assert list(a) == list(b)
        assert {k: v for k, v in a.items()} == pytest.approx(b, rel=0, abs=0, nan_ok=True)
    assert one["best_dice"] == two["best_dice"]
    for part, tree in one["global_payload"].items():
        assert all(torch.equal(v, two["global_payload"][part][k]) for k, v in tree.items())
    with open(tmp_path / "two" / "metrics.jsonl") as f:
        assert [int(line.split(",")[0].split(":")[1]) for line in f] == [1, 2]
