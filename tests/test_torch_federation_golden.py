"""The FedICRA golden trajectory through the port's server (CPU, ~25 s).

``tests/reference_trajectory.json`` holds ``fedicra_losses``: 3 clients, 8
rounds of 5 steps of "ours" (tree term off) with ALA from iteration 15, run
by a PyTorch mirror of the reference (``tests/gen_reference_trajectory.py``,
``FEDICRA_CONFIG``) from flax's initial weights on seed-fixed batches. Here
the same weights and batches go through ``build_experiment`` and
``FederatedServer.run``, and the losses are held under the classes of
``tests/test_reference_parity.py``.
"""

import json
from functools import partial

import jax
import numpy as np
import torch

import fedicra_torch.federation.experiment as port_exp
import gen_reference_trajectory as gen
from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.data.batcher import EpochBatcher
from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.engine.trainer import ClientState
from torch_port_helpers import NO_DROPOUT, one_torch_thread  # noqa: F401 (autouse fixture)


def test_fedicra_golden_through_the_ports_server(monkeypatch):
    g = gen.FEDICRA_CONFIG
    with open(gen.GOLDEN_PATH) as f:
        golden = json.load(f)
    assert golden["fedicra_config"] == g
    _, _, jstate = gen.make_jax_fedicra_model_and_state()
    train_b, ala_b = gen.make_fedicra_batches()
    iters, seed = g["iters"], g["seed"]

    # the batchers hand out the golden's batches: a train batcher's seed is
    # seed*1000 + cid, an ALA batcher's seed*1000 + 500 + cid
    def round_batches(b, start, n):
        cid, r = b.seed - seed * 1000, start // iters
        return {k: torch.as_tensor(train_b[cid][k][r]) for k in ("image", "label")}

    def ala_epoch(b, _epoch):
        cid = b.seed - seed * 1000 - 500
        return tuple(torch.as_tensor(ala_b[cid][k]) for k in ("image", "label"))

    monkeypatch.setattr(EpochBatcher, "batches_for_round", round_batches)
    monkeypatch.setattr(EpochBatcher, "epoch_arrays", ala_epoch)
    monkeypatch.setattr(port_exp, "net_factory", partial(port_exp.net_factory, dropout=NO_DROPOUT))
    cfg = TrainConfig.for_task(
        "odoc", img_size=g["img_size"], batch_size=g["batch_size"], iters=iters,
        rep_iters=g["rep_iters"], max_iterations=g["max_iterations"], base_lr=g["base_lr"],
        strategy="FedICRA", procedure="ours", model="unet_lc_multihead",
        num_clients=g["num_clients"], seed=seed, tree_loss_weight=0.0, alpha=g["alpha"],
        gatecrf_weight=g["gatecrf_weight"], gatecrf_radius=g["gatecrf_radius"],
        ala_skip_iters=g["ala_skip_iters"], eval_iters=10_000,
    )
    # 2 batches a client, so FedAvg's batch-count weights are equal, as in
    # the golden's loop
    server = port_exp.build_experiment(cfg, limit_per_client=2 * g["batch_size"], synthetic=True,
                                       device="cpu")
    v = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    model = server.clients[0].model
    params = {n: sd[n] for n, _ in model.named_parameters()}
    stats = {n: sd[n] for n, _ in model.named_buffers()}
    server.global_payload = {"params": params, "batch_stats": stats}
    losses = {}
    for c in server.clients:
        assert c.num_batches == 2
        c.state = ClientState(params, stats, 0, c.state.generator)

        def logged(state, batches, cid, _orig=c.round_fn):
            new, metrics = _orig(state, batches, cid)
            losses.setdefault(cid, []).extend(metrics["total_loss"].tolist())
            return new, metrics

        c.round_fn = logged

    history = server.run(num_rounds=g["rounds"] * iters, progress=False)
    assert len(history) == g["rounds"] and not any(h.get("aborted") for h in history)
    # ALA's first run came at iteration 15, the first after ala_skip_iters
    assert [c.start_phase for c in server.clients] == [False] * g["num_clients"]

    got = np.asarray([losses[c] for c in range(g["num_clients"])])
    ref = np.asarray(golden["fedicra_losses"])
    assert got.shape == ref.shape == (g["num_clients"], g["rounds"] * iters)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=5e-5, rtol=0)
    assert np.abs(got - ref).max() < 0.08, np.abs(got - ref).max()
    assert np.abs(got - ref).mean() < 0.02, np.abs(got - ref).mean()
    assert abs(got.mean() - ref.mean()) < 0.01
    final = state_dict_to_flax({**server.global_payload["params"], **server.global_payload["batch_stats"]})[0]
    np.testing.assert_allclose(gen._mirrored_param_abssum(final), golden["fedicra_final_param_abssum"],
                               rtol=2e-2)
