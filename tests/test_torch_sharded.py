"""The SPMD federation's pieces against fedicra_tpu's, in one process (CPU):
the mesh's shape rule, ``stacked_weighted_mean``, the SPMD ALA merge against
the host one and the round that takes its first run, the sharded round on a
(1, 1) mesh against JAX's ``make_sharded_round_fn``, and two faults of JAX's
sharded route.

The (2, 1) mesh over gloo ranks is in ``tests/test_torch_sharded_ranks.py``,
the data axis in ``tests/test_torch_sharded_data.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.data import EpochBatcher as PortBatcher
from fedicra_torch.data import make_synthetic_split
from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.engine.trainer import init_client_state as port_init
from fedicra_torch.federation.ala import ALA_SKIP_ITERS, ala_set_weights
from fedicra_torch.federation.sharded import _ala_merge_spmd, make_sharded_round_fn
from fedicra_torch.federation.sharded_experiment import ShardedFederation as PortFederation
from fedicra_torch.federation.strategies import stacked_weighted_mean
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.parallel import DataShard, make_mesh, mesh_shape
from fedicra_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse fixture)
    assert_sharded_rounds_agree, jax_sharded_round, one_torch_thread, port_sharded_round,
    sharded_configs, sharded_inputs, sharded_net,
)


@pytest.mark.parametrize("num_clients", [2, 4, 5])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_mesh_shape_equals_jax(n_devices, num_clients):
    want = jax_make_mesh(n_devices=n_devices, num_clients=num_clients).devices.shape
    assert mesh_shape(n_devices, num_clients) == want


def test_make_mesh_without_a_process_group_is_one_rank():
    mesh = make_mesh(num_clients=5)
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    assert list(mesh.clients) == [0, 1, 2, 3, 4]
    assert mesh.data_shard(12) is None
    assert mesh.client_group is None and mesh.data_group is None
    with pytest.raises(ValueError, match="2 devices over 1 ranks"):
        make_mesh(n_devices=2, num_clients=5)


@pytest.mark.parametrize("batch,size", [(2, 2), (3, 2), (4, 2), (12, 2), (5, 4), (4, 4)])
def test_data_shard_rows_follow_tensor_split(batch, size):
    x = torch.arange(batch)
    want = torch.tensor_split(x, size)
    got = [DataShard(None, i, size, batch).rows(x) for i in range(size)]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    with pytest.raises(ValueError, match="cannot be split"):
        DataShard(None, 0, batch + 1, batch)


def test_stacked_weighted_mean_equals_jax():
    from fedicra_tpu.federation.strategies import stacked_weighted_mean as jax_mean

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    weights = np.asarray([12, 3, 7, 1, 9], np.float32)
    got = stacked_weighted_mean({k: torch.as_tensor(v) for k, v in tree.items()},
                                torch.as_tensor(weights))
    want = jax_mean({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(weights))
    for k in tree:
        assert got[k].dtype == torch.float32 and got[k].shape == tree[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def _ala_setup():
    """ODOC at 16^2, batch 2, 2 clients, FedICRA pCE; local params the
    global ones plus 0.01, as tests/test_ala_spmd.py sets JAX up."""
    cfg = PortConfig.for_task("odoc", img_size=16, batch_size=2, iters=5, rep_iters=2,
                              max_iterations=100, strategy="FedICRA", procedure="pce",
                              model="unet_lc_multihead").replace(num_clients=2)
    model = port_net_factory(cfg.model, in_chns=3, class_num=3, num_clients=2, client_id=0)
    base = port_init(model, cfg, device="cpu")
    local = {k: v + 0.01 for k, v in base.params.items()}
    rng = np.random.default_rng(0)
    batches = {
        "image": torch.as_tensor(rng.uniform(size=(2, 2, 16, 16, 3)).astype(np.float32)),
        "label": torch.as_tensor(rng.integers(0, 4, size=(2, 2, 16, 16))),
    }
    return cfg, model, base, local, batches


@pytest.mark.parametrize("first_run", [False, True], ids=["steady", "first-run"])
@pytest.mark.parametrize("source", ["replayed", "resampled"])
def test_spmd_ala_equals_host_ala(source, first_run):
    """The SPMD merge against ala_set_weights with the client's
    batch_provider: the same merged weights (rtol 1e-6, as
    tests/test_ala_spmd.py holds JAX to its own host path) after the same
    number of epochs, from a replayed epoch or from epochs drawn afresh off
    the split arrays by the ALA stream's seed and counter."""
    cfg, model, base, local, batches = _ala_setup()
    iter_global = ALA_SKIP_ITERS + (cfg.iters if first_run else 10 * cfg.iters)
    counter = {"n": 0}
    if source == "replayed":
        raw = seed = None

        def provider(_epoch):
            counter["n"] += 1
            return batches
    else:
        split = make_synthetic_split(5, 16, 16, 3, 3, seed=4)
        batcher = PortBatcher(split, cfg.batch_size, cfg.num_classes, cfg.img_class, seed=99,
                              device="cpu")
        raw, seed = {"image": batcher._images_dev, "label": batcher._labels_dev}, 99

        def provider(_epoch):
            counter["n"] += 1
            imgs, labs = batcher.epoch_arrays(counter["n"])
            return {"image": imgs, "label": labs}

    report = {}
    host, _, start_phase = ala_set_weights(
        model, cfg, local, base.params, base.batch_stats, provider,
        torch.Generator().manual_seed(7), 1, iter_global, first_run, report=report)
    assert start_phase is False
    spmd, count = _ala_merge_spmd(
        model, cfg, local, base.params, base.batch_stats, batches if raw is None else None,
        torch.Generator().manual_seed(7), 1, first_run, ala_raw=raw, ala_seed=seed)
    assert count == counter["n"] == report["epochs"]
    assert (11 <= count <= 50) if first_run else count == 1
    assert list(spmd) == list(host)
    for k in host:
        np.testing.assert_allclose(spmd[k].numpy(), host[k].numpy(), rtol=1e-6, atol=1e-7)
    gated = [k for k in host if not torch.equal(host[k], base.params[k])]
    assert gated and any(not torch.equal(host[k], local[k]) for k in gated)


@pytest.mark.parametrize("case", ["pce-FedAvg", "ours-FedICRA"])
def test_sharded_round_equals_jax_on_one_device(case):
    """The port's round on the (1, 1) mesh against JAX's
    make_sharded_round_fn on a (1, 1) virtual mesh, from JAX's weights through
    convert.py, with the same batches and (under FedICRA) the same replayed
    ALA epoch: last-step losses at atol 5e-5, the ALA epochs, the global
    weights to the Adam envelope with the median element at 1e-6, and the
    global BatchNorm statistics at atol 5e-5 + rtol 5e-5."""
    inputs = sharded_inputs(case)
    port = port_sharded_round(case, inputs)
    assert_sharded_rounds_agree(case, port, jax_sharded_round(case, inputs, n_devices=1))


def test_jax_sharded_round_ignores_its_strategy_and_the_port_refuses_it():
    """Reference fault: JAX's sharded round aggregates by the weighted mean
    whatever cfg.strategy says. Its program under FedAdam is the program
    under FedAvg, character for character (lowered, not compiled). The port
    refuses a FedOpt strategy instead of averaging under its name."""
    from fedicra_tpu.engine.trainer import ClientState
    from fedicra_tpu.federation.sharded import make_sharded_round_fn as jax_round_fn

    case = "pce-FedAvg"
    inputs = sharded_inputs(case)
    v = inputs["variables"]
    states = ClientState(
        params=jax.tree.map(lambda *a: jnp.stack(a), *inputs["local"]),
        batch_stats=jax.tree.map(lambda a: jnp.stack([a, a]), v["batch_stats"]),
        current_iter=jnp.zeros((2,), jnp.int32),
        rng=jnp.stack([jax.random.PRNGKey(k) for k in range(2)]),
    )
    mesh = jax_make_mesh(n_devices=1, num_clients=2)
    texts = []
    for strategy in ("FedAvg", "FedAdam"):
        jcfg = sharded_configs(case)[0].replace(strategy=strategy)
        fn, _ = jax_round_fn(sharded_net(case, port=False), jcfg, mesh)
        with mesh:
            texts.append(fn.lower(states, jax.tree.map(jnp.asarray, v),
                                  jax.tree.map(jnp.asarray, inputs["batches"]), None,
                                  jnp.asarray(1, jnp.int32),
                                  jnp.asarray(inputs["weights"])).as_text())
    assert texts[0] == texts[1]

    pcfg = sharded_configs(case)[1]
    for strategy in ("FedAdagrad", "FedAdam", "FedYogi"):
        with pytest.raises(ValueError, match=f"strategy '{strategy}' is not supported"):
            make_sharded_round_fn(sharded_net(case, port=True), pcfg.replace(strategy=strategy),
                                  make_mesh(num_clients=2), device="cpu")
        with pytest.raises(ValueError, match=strategy):
            PortFederation(pcfg.replace(strategy=strategy), synthetic=True, limit_per_client=2,
                           device="cpu")


def test_jax_sharded_run_round_stops_on_the_ours_objectives_vis_pred(monkeypatch):
    """Reference fault: under "ours" JAX's round returns ``vis_pred`` ([K, H,
    W] after the sharded round's last step; its shape by ``jax.eval_shape``),
    and ``ShardedFederation.run_round`` converts every metric with
    ``float()``, so ``--sharded`` stops in its first round under the default
    procedure. The port's records keep the scalar metrics (the CLI test runs
    "ours" through ``--sharded``)."""
    from fedicra_tpu.engine import TrainConfig as JaxConfig
    from fedicra_tpu.engine.trainer import make_round_fn
    from fedicra_tpu.federation.sharded_experiment import ShardedFederation

    cfg = JaxConfig.for_task("odoc", img_size=16, batch_size=2, iters=2, rep_iters=1,
                             strategy="FedICRA", procedure="ours",
                             tree_loss_weight=0.0).replace(num_clients=2)
    fed = ShardedFederation(cfg, mesh=jax_make_mesh(n_devices=1, num_clients=2),
                            limit_per_client=2, synthetic=True)
    state = jax.tree.map(lambda x: x[0], fed.states)
    batches = jax.tree.map(lambda x: x[0], fed._stack_round_batches(np.zeros(2, np.int32)))
    _, shapes = jax.eval_shape(make_round_fn(fed.model, cfg), state, batches,
                               jnp.asarray(0, jnp.int32))
    assert shapes["vis_pred"].shape == (cfg.iters, 16, 16)
    assert shapes["total_loss"].shape == (cfg.iters,)
    last = {k: jnp.zeros((2, *s.shape[1:]), s.dtype) for k, s in shapes.items()}

    def round_fn(states, payload, *args):  # the sharded round's outputs, per client
        return states, payload, last, jnp.zeros((2,), jnp.int32)

    monkeypatch.setattr(fed, "round_fn", round_fn)
    with pytest.raises(TypeError, match="only"):
        fed.run_round()


@pytest.mark.parametrize("iters,skip", [(2, 2), (3, 50), (10, 50)])
def test_sharded_first_run_is_the_host_clients_start_phase(monkeypatch, iters, skip):
    """JAX's host client takes ALA's first-run loop at its first merge past
    ``ala_skip_iters`` (``start_phase`` until then); the sharded round
    derives it from ``iter_global``. Round by round, with a stand-in epoch
    of constant loss (the first run then stops after 11 epochs), JAX's host
    merge, the port's host merge and the port's sharded round run the same
    epochs: none up to the horizon, 11 in the first round past it, 1 after."""
    import fedicra_torch.federation.ala as port_ala
    import fedicra_torch.federation.sharded as port_sharded
    from fedicra_torch.engine.trainer import ClientState
    from fedicra_tpu.engine import TrainConfig as JaxConfig
    from fedicra_tpu.federation.ala import ala_set_weights as jax_ala_set_weights

    rounds = [r * iters for r in range(1, skip // iters + 4)]
    calls = []

    def jax_epoch(gates, *args):
        calls.append(1)
        return gates, jnp.asarray(0.5)

    jcfg = JaxConfig.for_task("odoc", iters=iters, ala_skip_iters=skip)
    local = {"decoder": {"out_conv": {"kernel": jnp.ones((3,))}}}
    glob = {"decoder": {"out_conv": {"kernel": jnp.zeros((3,))}}}
    jax_epochs, start_phase = [], True
    for ig in rounds:
        calls.clear()
        _, _, start_phase = jax_ala_set_weights(
            None, jcfg, jax_epoch, local, glob, {}, lambda e: None, jax.random.PRNGKey(0), 0,
            ig, start_phase)
        jax_epochs.append(len(calls))

    def port_epoch(model, cfg, gates, *args):
        calls.append(1)
        return gates, 0.5

    monkeypatch.setattr(port_ala, "ala_epoch", port_epoch)
    pcfg = PortConfig.for_task("odoc", iters=iters, ala_skip_iters=skip).replace(num_clients=1)
    local_t = {"decoder.out_conv.weight": torch.ones(3)}
    glob_t = {"decoder.out_conv.weight": torch.zeros(3)}
    host_epochs, start_phase = [], True
    for ig in rounds:
        calls.clear()
        _, _, start_phase = ala_set_weights(None, pcfg, local_t, glob_t, {}, lambda e: None,
                                            None, 0, ig, start_phase)
        host_epochs.append(len(calls))

    def round_fn(state, batches, cid, on_step=None):
        return (ClientState(state.params, state.batch_stats, state.current_iter + iters,
                            state.generator), {"total_loss": torch.zeros(iters)})

    monkeypatch.setattr(port_sharded, "make_round_fn", lambda model, cfg, device: round_fn)
    fn = make_sharded_round_fn(None, pcfg, make_mesh(num_clients=1), device="cpu")
    states = {0: ClientState(local_t, {}, 0, None)}
    batches = {0: {"image": torch.zeros(iters, 1), "label": torch.zeros(iters, 1)}}
    sharded_epochs, counters = [], {0: 0}
    for ig in rounds:
        before = counters[0]
        states, _, _, counters = fn(states, {"params": glob_t, "batch_stats": {}}, batches,
                                    batches, ig, [1.0], ala_counters=counters)
        states = {0: ClientState(local_t, {}, ig, None)}
        sharded_epochs.append(counters[0] - before)

    first = next(i for i, ig in enumerate(rounds) if ig > skip)
    want = [0] * first + [11] + [1] * (len(rounds) - first - 1)
    assert jax_epochs == host_epochs == sharded_epochs == want
