"""Shared set-up of the port's parity tests: one model in both packages.

The JAX model is initialised by ``fedicra_tpu`` and its weights are carried
into ``fedicra_torch`` through the port's weight bridge, so both hold the
same numbers. Dropout is 0 everywhere: dropout streams cannot match across
frameworks.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import flax_to_state_dict, state_dict_to_flax
from fedicra_torch.engine.config import TrainConfig as PortConfig
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.parallel.launch import free_port  # noqa: F401 (the tests import it from here)
from fedicra_tpu.engine import TrainConfig
from fedicra_tpu.models import net_factory
from fedicra_tpu.models.blocks import set_compute_dtype

NO_DROPOUT = (0.0,) * 5
IMG = 32
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread, as autouse where imported.

    These tests issue many small ops. With pytest-xdist workers side by side,
    each with a thread per core, the workers' OpenMP teams oversubscribe the
    cores and every parallel region waits on descheduled threads: two such
    files that take ~45 s each alone took more than 400 s side by side, and
    ~50-65 s with one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(img_size=IMG, **kw):
    base = dict(
        img_size=img_size, batch_size=BATCH, strategy="FedICRA", procedure="ours",
        model="unet_lc_multihead", tree_loss_weight=0.0,
    )
    base.update(kw)
    return TrainConfig.for_task("odoc", **base), PortConfig.for_task("odoc", **base)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def models(client_id=0, img_size=IMG, seed=0):
    """(jax_model, jax_variables, port_model) holding the same weights."""
    jm = net_factory(
        "unet_lc_multihead", in_chns=3, class_num=3, num_clients=5,
        client_id=client_id, dropout=NO_DROPOUT, dsn_dropout=0.0,
    )
    x = jnp.zeros((1, img_size, img_size, 3))
    variables = jm.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        x, train=False,
    )
    variables = to_numpy(dict(variables))
    pm = port_net_factory(
        "unet_lc_multihead", in_chns=3, class_num=3, num_clients=5,
        client_id=client_id, dropout=NO_DROPOUT, dsn_dropout=0.0,
    )
    pm.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return jm, variables, pm


def batch(seed=0, b=BATCH, img_size=IMG, num_classes=3):
    """Standardised images and sparse labels (value num_classes = unlabelled).

    Zero-mean inputs keep the reference's fp32 error small: flax BatchNorm
    takes the variance as E[x^2] - E[x]^2, whose rounding grows with the
    mean of its input, and at 32^2 that alone reaches the 2e-5 tolerances.
    """
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(b, img_size, img_size, 3)).astype(np.float32)
    label = rng.integers(0, num_classes, size=(b, img_size, img_size))
    label = np.where(rng.uniform(size=label.shape) < 0.7, num_classes, label).astype(np.int32)
    return image, label


def port_stats(model):
    return state_dict_to_flax(model.state_dict())[1]


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_close(got, want, **tol):
    g, w = dict(flat(got)), dict(flat(want))
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg="/".join(k), **tol)


def t(a, **kw):
    return torch.tensor(np.array(a), **kw)


@contextlib.contextmanager
def jax_amp():
    """JAX's AMP (bf16 convolutions) within the block."""
    set_compute_dtype(jnp.bfloat16)
    try:
        yield
    finally:
        set_compute_dtype(None)


def compile_exact(fn, *args):
    """``jax.jit(fn)`` compiled to round every bf16 operation as written."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})


def output_leaves(out):
    """(name, leaf) of a model's output dict, in a fixed order; None kept."""
    for key in sorted(out):
        val = out[key]
        if isinstance(val, (list, tuple)):
            for i, a in enumerate(val):
                yield f"{key}[{i}]", a
        else:
            yield key, val


def dtype_name(a):
    if a is None:
        return None
    return str(a.dtype).replace("torch.", "")


def as_float32(a):
    """A torch or JAX array as a float32 numpy array."""
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


# --- The sharded round in both packages (tests/test_torch_sharded*.py) ---

SHARDED_CASES = {
    # FedAvg with pCE: every client adopts the global weights and takes one
    # step, round 1. (A second step of the same phase would start from
    # weights that Adam moved by +-lr where a gradient is rounding noise, and
    # hold only to the trajectory envelope.)
    "pce-FedAvg": dict(model="unet", strategy="FedAvg", procedure="pce", iters=1,
                       iter_global=1),
    # FedICRA "ours" (tree term off): round 2, past ala_skip_iters=2, so each
    # client's ALA merge runs its first-run loop, then 1 head and 1 body step
    "ours-FedICRA": dict(model="unet_lc_multihead", strategy="FedICRA", procedure="ours",
                         iters=2, iter_global=4),
}
SHARDED_K = 2


def sharded_configs(case):
    """(jax cfg, port cfg) of a SHARDED_CASES entry: ODOC at 32^2, batch 2,
    2 clients."""
    c = SHARDED_CASES[case]
    base = dict(img_size=IMG, batch_size=BATCH, iters=c["iters"], rep_iters=1, max_iterations=8,
                model=c["model"], strategy=c["strategy"], procedure=c["procedure"],
                tree_loss_weight=0.0, ala_skip_iters=2)
    return (TrainConfig.for_task("odoc", **base).replace(num_clients=SHARDED_K),
            PortConfig.for_task("odoc", **base).replace(num_clients=SHARDED_K))


def sharded_net(case, port: bool):
    c = SHARDED_CASES[case]
    factory = port_net_factory if port else net_factory
    kw = dict(num_clients=SHARDED_K, client_id=0, dsn_dropout=0.0) if "lc" in c["model"] else {}
    return factory(c["model"], in_chns=3, class_num=3, dropout=NO_DROPOUT, **kw)


def sharded_inputs(case, seed=0):
    """The round's inputs as numpy: JAX's initial variables, each client's
    local params (the global ones plus a client's own offset, so that ALA has
    something to merge), the round's batches and the ALA epoch, [K, 2, B, ...]."""
    from fedicra_tpu.engine import init_client_state

    jcfg, _ = sharded_configs(case)
    base = init_client_state(sharded_net(case, port=False), jcfg)
    variables = to_numpy({"params": base.params, "batch_stats": base.batch_stats})
    rng = np.random.default_rng(seed)
    local = [jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(a.dtype),
                          variables["params"]) for _ in range(SHARDED_K)]
    parts = [batch(seed=seed + 1 + i) for i in range(SHARDED_K * 4)]
    images = np.stack([p[0] for p in parts]).reshape(SHARDED_K, 2, 2, BATCH, IMG, IMG, 3)
    labels = np.stack([p[1] for p in parts]).reshape(SHARDED_K, 2, 2, BATCH, IMG, IMG)
    iters = SHARDED_CASES[case]["iters"]
    return dict(variables=variables, local=local,
                batches={"image": images[:, 0, :iters], "label": labels[:, 0, :iters]},
                ala={"image": images[:, 1], "label": labels[:, 1]},
                weights=np.asarray([2.0, 3.0], np.float32))


def jax_sharded_round(case, inputs, n_devices):
    """JAX's make_sharded_round_fn on a virtual (n_devices, 1) mesh. Returns
    numpy (global flax params, global flax stats, last-step total losses [K],
    ALA counters [K])."""
    from fedicra_tpu.engine.trainer import ClientState
    from fedicra_tpu.federation.sharded import make_sharded_round_fn
    from fedicra_tpu.parallel.mesh import make_mesh

    jcfg, _ = sharded_configs(case)
    c = SHARDED_CASES[case]
    stacked = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)  # noqa: E731
    v = inputs["variables"]
    states = ClientState(
        params=stacked(inputs["local"]),
        batch_stats=stacked([v["batch_stats"]] * SHARDED_K),
        current_iter=jnp.full((SHARDED_K,), c["iter_global"] - jcfg.iters, jnp.int32),
        rng=jnp.stack([jax.random.PRNGKey(k) for k in range(SHARDED_K)]),
    )
    mesh = make_mesh(n_devices=n_devices, num_clients=SHARDED_K)
    assert mesh.devices.shape == (n_devices, 1)
    fn, _ = make_sharded_round_fn(sharded_net(case, port=False), jcfg, mesh)
    ala = jax.tree.map(jnp.asarray, inputs["ala"]) if jcfg.fedicra else None
    with mesh:
        _, glob, metrics, counters = fn(
            states, jax.tree.map(jnp.asarray, v), jax.tree.map(jnp.asarray, inputs["batches"]),
            ala, jnp.asarray(c["iter_global"], jnp.int32), jnp.asarray(inputs["weights"]))
    glob = to_numpy(glob)
    return (glob["params"], glob["batch_stats"], np.asarray(metrics["total_loss"]),
            np.asarray(counters))


def port_sharded_round(case, inputs, device="cpu"):
    """The port's make_sharded_round_fn on this process's mesh (the default
    process group's ranks, or (1, 1) without one), from the same weights
    (through convert.py) and batches. Returns {cid: (last-step total loss,
    ALA counter)} for this rank's clients and the global (flax params, flax
    stats) as numpy."""
    from fedicra_torch.engine.trainer import ClientState
    from fedicra_torch.federation.sharded import make_sharded_round_fn
    from fedicra_torch.parallel import make_mesh

    _, pcfg = sharded_configs(case)
    c = SHARDED_CASES[case]
    model = sharded_net(case, port=True)
    names = {n for n, _ in model.named_parameters()}

    def split(params):
        sd = flax_to_state_dict(params, inputs["variables"]["batch_stats"])
        return ({k: v for k, v in sd.items() if k in names},
                {k: v for k, v in sd.items() if k not in names})

    mesh = make_mesh(num_clients=SHARDED_K)
    fn = make_sharded_round_fn(model, pcfg, mesh, device=device)
    gp, gs = split(inputs["variables"]["params"])
    states = {cid: ClientState(*split(inputs["local"][cid]), c["iter_global"] - pcfg.iters,
                               torch.Generator().manual_seed(cid))
              for cid in mesh.clients}
    pick = lambda arrays, cid: {k: torch.as_tensor(a[cid]) for k, a in arrays.items()}  # noqa: E731
    ala = ({cid: pick(inputs["ala"], cid) for cid in mesh.clients} if pcfg.fedicra else None)
    _, glob, metrics, counters = fn(
        states, {"params": gp, "batch_stats": gs},
        {cid: pick(inputs["batches"], cid) for cid in mesh.clients}, ala, c["iter_global"],
        inputs["weights"])
    flat_params, flat_stats = state_dict_to_flax({**glob["params"], **glob["batch_stats"]})
    per_client = {cid: (float(metrics[cid]["total_loss"][-1]), counters.get(cid, 0))
                  for cid in mesh.clients}
    return per_client, to_numpy(flat_params), to_numpy(flat_stats)


def port_sharded_round_rank(rank, device, case, inputs, out):
    """``port_sharded_round`` in a spawned rank; writes its result to
    ``out.<rank>``."""
    import pickle

    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(port_sharded_round(case, inputs, device), f)


def assert_sharded_rounds_agree(case, port, want):
    """The port's round (per_client, params, stats) against JAX's (params,
    stats, losses, counters), at the tolerances of
    tests/test_torch_federation_rounds.py."""
    from fedicra_torch.engine.trainer import poly_lr

    per_client, p_params, p_stats = port
    j_params, j_stats, j_losses, j_counters = want
    c = SHARDED_CASES[case]
    assert sorted(per_client) == list(range(SHARDED_K))
    losses = np.asarray([per_client[k][0] for k in range(SHARDED_K)])
    np.testing.assert_allclose(losses, j_losses, atol=5e-5, rtol=0)
    assert [per_client[k][1] for k in range(SHARDED_K)] == j_counters.tolist()
    if c["strategy"] == "FedICRA":  # ALA's first-run loop ran its 11 to 50 epochs
        assert all(11 <= n <= 50 for n in j_counters)
    start = c["iter_global"] - c["iters"]
    envelope = 2 * sum(poly_lr(0.01, it, 8) for it in range(start, c["iter_global"]))
    g, w = dict(flat(p_params)), dict(flat(j_params))
    assert g.keys() == w.keys()
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= envelope, ("/".join(k), float(d.max()))
        # each phase takes one Adam step: a step of lr whatever the
        # gradient's size, so the median element agrees but where the
        # gradient is rounding noise (a conv bias before a BatchNorm)
        if k[-3:] != ("conv", "conv", "bias"):
            assert np.median(d) <= 1e-6, ("/".join(k), float(np.median(d)))
    assert_trees_close(p_stats, j_stats, atol=5e-5, rtol=5e-5)


# --- The sharded round over gloo ranks (tests/test_torch_sharded_ranks.py,
# tests/test_torch_sharded_data.py) ---

@pytest.fixture(autouse=True)
def one_thread_per_rank(monkeypatch):
    """Spawned ranks take one torch thread each, as this process (autouse
    where imported)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def spawned(tmp_path, target, args, world_size):
    """Run ``target(rank, device, *args, out)`` on ``world_size`` gloo ranks
    on the CPU; returns each rank's result, pickled to ``out.<rank>``."""
    import pickle

    from fedicra_torch.parallel import spawn_ranks

    out = str(tmp_path / "rank")
    spawn_ranks(target, (*args, out), "gloo", ["cpu"] * world_size, timeout=300)
    results = []
    for rank in range(world_size):
        with open(f"{out}.{rank}", "rb") as f:
            results.append(pickle.load(f))
    return results


def data_axis_round(num_clients, batch_size, img_size=IMG):
    """The port's sharded round on this process's mesh: FedICRA "ours" with
    the tree term at 0.1 and the reference's dropout, ODOC at ``img_size``,
    one (body) step after ALA's steady-state epoch, drawn from each client's
    split arrays; each client's local weights offset from the global ones,
    every input made from numpy seeds. Returns ({cid: (last-step loss, ALA
    counter)} of this rank's clients, the global payload as numpy)."""
    from fedicra_torch.engine.trainer import ClientState, init_client_state
    from fedicra_torch.federation.sharded import make_sharded_round_fn
    from fedicra_torch.parallel import make_mesh

    K = num_clients
    cfg = PortConfig.for_task(
        "odoc", img_size=img_size, batch_size=batch_size, iters=1, rep_iters=1,
        max_iterations=100, strategy="FedICRA", procedure="ours", tree_loss_weight=0.1,
        ala_skip_iters=2).replace(num_clients=K)
    model = port_net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=K,
                             client_id=0)
    base = init_client_state(model, cfg, device="cpu")
    mesh = make_mesh(num_clients=K)
    fn = make_sharded_round_fn(model, cfg, mesh, device="cpu")
    rng = np.random.default_rng(0)
    states, batches, raw = {}, {}, {}
    for cid in range(K):
        params = {k: v + torch.as_tensor(0.01 * rng.standard_normal(v.shape).astype(np.float32))
                  for k, v in base.params.items()}
        image, label = batch(seed=10 + cid, b=3 * batch_size, img_size=img_size)
        if cid in mesh.clients:
            states[cid] = ClientState(params, base.batch_stats, 9, torch.Generator().manual_seed(cid))
            batches[cid] = {"image": torch.as_tensor(image[None, :batch_size]),
                            "label": torch.as_tensor(label[None, :batch_size])}
            raw[cid] = {"image": torch.as_tensor(image[batch_size:]),
                        "label": torch.as_tensor(label[batch_size:])}
    _, glob, metrics, counters = fn(
        states, {"params": base.params, "batch_stats": base.batch_stats}, batches, None, 10,
        [float(c + 1) for c in range(K)], ala_raw=raw, ala_seeds={c: 100 + c for c in raw},
        ala_counters={c: 3 for c in raw},
        ala_generators={c: torch.Generator().manual_seed(50 + c) for c in raw})
    per_client = {cid: (float(metrics[cid]["total_loss"][-1]), counters[cid]) for cid in metrics}
    return per_client, {part: {k: v.numpy() for k, v in tree.items()} for part, tree in glob.items()}


def data_axis_round_rank(rank, device, num_clients, batch_size, out):
    """``data_axis_round`` in a spawned rank; writes its result to ``out.<rank>``."""
    import pickle

    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(data_axis_round(num_clients, batch_size), f)


def barrier_or_exit(rank, device, failing_rank, code):
    """Rank ``failing_rank`` exits with ``code``; the others wait for it in a
    barrier."""
    import os

    import torch.distributed as dist

    if rank == failing_rank:
        os._exit(code)
    dist.barrier()


def sleeping_rank(rank, device, seconds):
    """A rank that outlasts a short launch timeout."""
    import time

    time.sleep(seconds)
