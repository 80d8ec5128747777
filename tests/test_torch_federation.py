"""The port's federation layer (CPU): strategies and ALA against
fedicra_tpu's, and the server's control flow on the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.convert import flax_to_state_dict
from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.federation import build_experiment, get_strategy, load_task_splits, weighted_tree_mean
from fedicra_torch.federation import ala as ala_mod
from fedicra_torch.federation.api import EvaluateIns
from fedicra_torch.federation.ala import ala_set_weights
from fedicra_torch.models.params_filters import is_ala_gated
from fedicra_tpu.federation import get_strategy as jax_get_strategy
from fedicra_tpu.federation import weighted_tree_mean as jax_weighted_tree_mean
from fedicra_tpu.federation.ala import ala_set_weights as jax_ala_set_weights
from fedicra_tpu.federation.ala import make_ala_epoch_fn
from torch_port_helpers import batch, configs, models, one_torch_thread  # noqa: F401 (autouse fixture)

# ---------------------------------------------------------------- strategies


def _random_trees(seed, n_clients=3):
    rng = np.random.default_rng(seed)
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.running_var": (5,)}

    def tree(scale=1.0):
        return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}

    return tree(), [tree() for _ in range(n_clients)], rng.uniform(1, 5, size=n_clients)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_weighted_tree_mean_matches_jax():
    _, clients, w = _random_trees(0)
    got = weighted_tree_mean([_t(c) for c in clients], list(w))
    want = jax_weighted_tree_mean([{k: jnp.asarray(v) for k, v in c.items()} for c in clients], list(w))
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["FedAvg", "FedICRA", "FedAdagrad", "FedAdam", "FedYogi"])
def test_strategy_matches_jax_over_three_rounds_per_part(name):
    """Three successive aggregations of each payload part. The port keeps a
    FedOpt's moments per part; each part's updates equal those of a fresh
    JAX strategy object fed that part alone."""
    port = get_strategy(name)
    jax_parts = {"params": jax_get_strategy(name), "batch_stats": jax_get_strategy(name)}
    globals_ = {part: _random_trees(1 + i)[0] for i, part in enumerate(jax_parts)}
    for rnd in range(3):
        for i, part in enumerate(jax_parts):
            _, clients, w = _random_trees(10 * rnd + i)
            got = port.aggregate(_t(globals_[part]), [_t(c) for c in clients], list(w), part=part)
            want = jax_parts[part].aggregate(
                {k: jnp.asarray(v) for k, v in globals_[part].items()},
                [{k: jnp.asarray(v) for k, v in c.items()} for c in clients], list(w),
            )
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{name} round {rnd} {part} {k}")
            globals_[part] = {k: np.asarray(v) for k, v in want.items()}
    if name not in ("FedAvg", "FedICRA"):
        assert set(port._m) == {"params", "batch_stats"}
    with pytest.raises(ValueError):
        get_strategy("FedNope")


# ----------------------------------------------------------------------- ALA


@pytest.fixture(scope="module")
def ala_setup():
    """The same weights in both packages; the global payload is the local
    weights plus noise (seed 0), so every gated element has a direction."""
    jcfg, pcfg = configs(ala_skip_iters=5)
    jm, v, pm = models()
    names = {n for n, _ in pm.named_parameters()}
    sd = pm.state_dict()
    local = {k: t.clone() for k, t in sd.items() if k in names}
    stats = {k: t.clone() for k, t in sd.items() if k not in names}
    rng = np.random.default_rng(0)
    gparams = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"])
    gsd = flax_to_state_dict(gparams, v["batch_stats"])
    glob = {k: gsd[k] for k in local}
    return dict(jcfg=jcfg, pcfg=pcfg, jm=jm, v=v, pm=pm, local=local, stats=stats,
                gparams=gparams, glob=glob, epoch_fn=make_ala_epoch_fn(jm, jcfg))


def _epoch(e):
    """ALA epoch ``e``: 2 batches of 2 at 32^2. Epochs 0..13 alternate
    between bright class-2 and dim class-0 scribbles, so the per-epoch loss
    swings by ~0.35; from epoch 14 on one fixed epoch repeats."""
    if e < 14:
        img, lab = batch(seed=100 + e)
        img = img * (6.0 if e % 2 else 0.3)
        lab = np.where(lab == 3, 3, (e % 2) * 2)
    else:
        img, lab = batch(seed=7)
    return np.stack([img, img[::-1]]), np.stack([lab, lab[::-1]])


def _run_both(s, start_phase, iter_global=10, cid=1):
    calls = {"jax": 0}

    def jax_provider(e):
        calls["jax"] += 1
        i, lab = _epoch(e)
        return {"image": jnp.asarray(i), "label": jnp.asarray(lab)}

    jp, js, jsp = jax_ala_set_weights(
        s["jm"], s["jcfg"], s["epoch_fn"], s["v"]["params"], s["gparams"], s["v"]["batch_stats"],
        jax_provider, jax.random.PRNGKey(0), cid, iter_global, start_phase,
    )
    report = {}
    pp, ps, psp = ala_set_weights(
        s["pm"], s["pcfg"], s["local"], s["glob"], s["stats"],
        lambda e: {k: torch.as_tensor(a) for k, a in zip(("image", "label"), _epoch(e))},
        None, cid, iter_global, start_phase, report=report,
    )
    want = flax_to_state_dict(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    return want, jsp, calls["jax"], pp, ps, psp, report


def test_ala_one_epoch_matches_jax(ala_setup):
    s = ala_setup
    stats_before = {k: t.clone() for k, t in s["stats"].items()}
    buffers_before = {k: t.clone() for k, t in s["pm"].named_buffers()}
    want, jsp, n_jax, pp, ps, psp, report = _run_both(s, start_phase=False)
    assert jsp is psp is False and n_jax == report["epochs"] == 1
    gated = [k for k in pp if is_ala_gated(k)]
    assert gated and len(gated) < len(pp)
    for k in pp:
        if is_ala_gated(k):
            np.testing.assert_allclose(pp[k].numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)
            lo = torch.minimum(s["local"][k], s["glob"][k])
            hi = torch.maximum(s["local"][k], s["glob"][k])
            assert torch.all((pp[k] >= lo - 1e-7) & (pp[k] <= hi + 1e-7)), k
        else:
            assert torch.equal(pp[k], s["glob"][k]), k  # the global value, bit for bit
    moved = sum(int((pp[k] != s["local"][k]).sum()) for k in gated)
    assert moved > 0  # some gate left 1
    # the gate forward's running-stat updates are thrown away
    assert ps is s["stats"]
    for k, t in s["stats"].items():
        assert torch.equal(t, stats_before[k]), k
    for k, t in s["pm"].named_buffers():
        assert torch.equal(t, buffers_before[k]), k


def test_ala_first_run_loop_takes_jaxs_epoch_count(ala_setup):
    """start_phase=True: epochs run until the std of the last 10 losses is
    below 0.1. With _epoch's losses the loop ends at epoch 20 in both, and
    no window's std lies within 2e-3 of 0.1, far outside the two packages'
    float32 difference (~1e-5)."""
    want, jsp, n_jax, pp, ps, psp, report = _run_both(ala_setup, start_phase=True)
    assert jsp is psp is False
    assert report["epochs"] == n_jax == 20
    losses = report["losses"]
    stds = [float(np.std(losses[i - 10:i])) for i in range(11, len(losses) + 1)]
    assert all(s > 0.1 for s in stds[:-1]) and stds[-1] < 0.1
    assert min(abs(s - 0.1) for s in stds) > 2e-3
    # After 40 gate steps the float32 gradients' differences have added up
    # in the gates, and a few gates sit where one package's step crossed the
    # clip at 0 or 1 and the other's did not: the median element agrees to
    # 1e-7, under 1% of a tensor's elements lie outside rtol 1e-4 / atol
    # 1e-6, and none is 1e-4 away (a gate moves its weight by up to
    # |local - global|, ~0.15 here).
    for k in pp:
        d = np.abs(pp[k].numpy() - want[k].numpy())
        outside = d > 1e-6 + 1e-4 * np.abs(want[k].numpy())
        assert np.median(d) <= 1e-7 and outside.mean() < 0.01 and d.max() < 1e-4, k


@pytest.mark.parametrize("case", ["identical", "early"])
def test_ala_skip_paths_adopt_the_global_weights(ala_setup, case):
    s = ala_setup
    local = s["glob"] if case == "identical" else s["local"]
    iter_global = 10 if case == "identical" else 5  # ala_skip_iters = 5

    def never(_e):
        raise AssertionError("ALA ran")

    report = {}
    params, stats, sp = ala_set_weights(s["pm"], s["pcfg"], local, s["glob"], s["stats"], never,
                                        None, 1, iter_global, True, report=report)
    assert params is s["glob"] and stats is s["stats"] and sp is True and report == {}


# ------------------------------------------------------- server control flow


def _cfg(**kw):
    base = dict(img_size=16, batch_size=2, iters=2, rep_iters=1, eval_iters=4, max_iterations=8,
                strategy="FedAvg", procedure="pce", model="unet_lc_multihead")
    base.update(kw)
    return TrainConfig.for_task("odoc", **base)


def _build(cfg=None, **kw):
    return build_experiment(cfg or _cfg(), limit_per_client=4, synthetic=True, device="cpu", **kw)


def _snapshot(payload):
    return {part: {k: t.clone() for k, t in tree.items()} for part, tree in payload.items()}


def test_fit_fault_aborts_round_without_contamination():
    server = _build()
    assert server.fit_round(2) is not None
    snap = _snapshot(server.global_payload)
    victim = server.clients[2]
    real_fit = victim.fit

    def crashing_fit(ins):
        victim.state.current_iter += 1  # a genuinely mid-fit failure
        raise RuntimeError("simulated mid-fit crash")

    victim.fit = crashing_fit
    assert server.fit_round(4) is None
    for part, tree in snap.items():
        for k, t in tree.items():
            assert torch.equal(server.global_payload[part][k], t), k
    victim.fit = real_fit
    assert server.fit_round(6) is not None
    assert not torch.equal(server.global_payload["params"]["decoder.out_conv.weight"],
                           snap["params"]["decoder.out_conv.weight"])


def test_evaluate_fault_skips_the_eval_and_continues():
    server = _build()
    victim = server.clients[1]
    calls = {"n": 0}
    real_evaluate = victim.evaluate

    def flaky_evaluate(ins):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated mid-evaluate crash")
        return real_evaluate(ins)

    victim.evaluate = flaky_evaluate
    history = server.run(num_rounds=8, progress=False)
    assert len(history) == 4 and not any(h.get("aborted") for h in history)
    evals = [h for h in history if "val_mean_dice" in h]
    assert [h["round"] for h in evals] == [8] and calls["n"] == 2
    assert server.best_dice == pytest.approx(evals[0]["val_mean_dice"])
    for name in ("val_1_hd95", "val_2_dice", "val_avg_mean_dice", "client_3_val_mean_jc"):
        assert name in evals[0]


def test_max_consecutive_failures_stops_the_run():
    from fedicra_torch.federation.server import FederatedServer

    class DeadClient:
        cid = 0

        def fit(self, ins):
            raise RuntimeError("device lost (simulated)")

    server = FederatedServer(_cfg(max_iterations=100, max_consecutive_failures=3), [DeadClient()],
                             strategy=None, initial_payload=None)
    server.run(progress=False)
    assert [r["round"] for r in server.history if r.get("aborted")] == [2, 4, 6]


def test_stop_fn_writes_a_resume_snapshot(tmp_path):
    d = str(tmp_path / "snap")
    server = _build(_cfg(ckpt_iters=1000), snapshot_dir=d)
    calls = {"n": 0}

    def stop_after_one():
        calls["n"] += 1
        return calls["n"] > 1

    server.run(num_rounds=100, progress=False, stop_fn=stop_after_one)
    assert server.current_round == 2
    again = _build(_cfg(ckpt_iters=1000), snapshot_dir=d)
    assert again.try_resume() and again.current_round == 2


def test_resume_continues_identically(tmp_path, monkeypatch):
    """4 iterations, a snapshot, a fresh experiment resumed to 8: the same
    losses and weights as 8 iterations straight (ALA included, its first run
    cut to 2 epochs)."""
    monkeypatch.setattr(ala_mod, "ALA_MAX_EPOCHS", 2)
    mk = lambda: _cfg(strategy="FedICRA", iters=2, eval_iters=1000, ckpt_iters=4, max_iterations=1000,
                      ala_skip_iters=0)
    full = _build(mk())
    h_full = full.run(num_rounds=8, progress=False)
    d = str(tmp_path / "snap")
    _build(mk(), snapshot_dir=d).run(num_rounds=4, progress=False)
    resumed = _build(mk(), snapshot_dir=d)
    assert resumed.try_resume() and resumed.current_round == 4
    assert [c.start_phase for c in resumed.clients] == [False] * 5  # ALA ran at iteration 4
    h_b = resumed.run(num_rounds=8, progress=False)
    losses = {k: v for k, v in h_full[-1].items() if isinstance(v, float) and "loss" in k}
    assert losses and losses == {k: h_b[-1][k] for k in losses}
    for k, t in full.global_payload["params"].items():
        assert torch.equal(resumed.global_payload["params"][k], t), k


def test_client_side_own_best_checkpoints(tmp_path, monkeypatch):
    from fedicra_torch.federation import client as client_mod

    d = tmp_path / "snap"
    server = _build(snapshot_dir=str(d))
    cl = server.clients[0]
    scripted = {"dice": 0.0}
    monkeypatch.setattr(client_mod, "evaluate_client", lambda *a, **k: {"mean_dice": scripted["dice"]})

    def payload_const(c):
        return {"params": {k: torch.full_like(t, c) for k, t in server.global_payload["params"].items()},
                "batch_stats": server.global_payload["batch_stats"]}

    for dice, value, it in ((0.3, 1.0, 20), (0.2, 2.0, 40)):
        scripted["dice"] = dice
        cl.evaluate(EvaluateIns(payload_const(value), {"iter_global": it}))
    got = cl.ckpt.restore_best_client(0)
    assert all(torch.all(t == 1.0) for t in got["params"].values())
    scripted["dice"] = 0.5
    cl.evaluate(EvaluateIns(payload_const(3.0), {"iter_global": 60}))
    got = cl.ckpt.restore_best_client(0)
    assert all(torch.all(t == 3.0) for t in got["params"].values())
    assert got["current_iter"] == 0 and isinstance(got["generator"], torch.Tensor)
    assert (d / "best_client_0_info.txt").read_text().splitlines() == [
        "iter=20 dice=0.300000", "iter=60 dice=0.500000"]
    server.ckpt.save_best(server.global_payload, 60, 0.5)
    restored = server.ckpt.restore_best_global()
    for k, t in server.global_payload["params"].items():
        assert torch.equal(restored["params"][k], t)
    assert (d / "best_info.txt").read_text() == "round=60 dice=0.500000\n"
    assert not (d / "best_client_1").exists()


def test_load_task_splits_needs_synthetic_or_a_root(tmp_path):
    cfg = _cfg()
    with pytest.raises(FileNotFoundError, match="synthetic"):
        load_task_splits(cfg, None)
    with pytest.raises(FileNotFoundError):
        load_task_splits(cfg, str(tmp_path))
    splits = load_task_splits(cfg, None, limit_per_client=6, synthetic=True)
    assert sorted(splits) == [0, 1, 2, 3, 4]
    assert len(splits[0]["train"]) == 6 and len(splits[0]["val"]) == 2


def test_personalised_strategy_has_no_central_eval():
    assert _build(_cfg(strategy="FedICRA")).central_eval_fn is None
    assert _build().central_eval_fn is not None
    assert ala_mod.ALA_SKIP_ITERS == TrainConfig().ala_skip_iters == 50 and ala_mod.ALA_MAX_EPOCHS == 50
