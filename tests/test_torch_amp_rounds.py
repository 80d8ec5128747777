"""Mixed precision (``--amp 1``): forwards, rounds and the entry points (CPU).

The flagship's AMP forward against JAX's, each output's distance a share of
JAX's AMP-to-fp32 gap as in ``tests/test_torch_amp.py``. Two FedICRA rounds under AMP in both packages, held to the trajectory class
of ``tests/test_reference_parity.py`` (losses within 0.08 at most and 0.02 on
average, weights within Adam's 2 * sum(lr)); the train CLI's ``--amp 1``
and the runner's; the centralized baseline ignores ``amp``, as JAX's does.
The first step and the dtype map are in ``tests/test_torch_amp.py``.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.cli import runner as port_runner
from fedicra_torch.cli import train as port_train
from fedicra_torch.convert import state_dict_to_flax
from fedicra_torch.engine.centralized import train_centralized
from fedicra_torch.engine.trainer import ClientState, make_round_fn
from fedicra_torch.models import net_factory as port_net_factory
from fedicra_torch.models.blocks import compute_dtype
from fedicra_tpu.engine.trainer import ClientState as JaxState
from fedicra_tpu.engine.trainer import make_round_fn as jax_make_round_fn
from test_torch_amp import CID, GAP_SHARE
from torch_port_helpers import (  # noqa: F401
    as_float32, batch, compile_exact, configs, dtype_name, flat, jax_amp, models, one_torch_thread,
    output_leaves, t)

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_forward_of_the_flagship(train):
    """unet_lc_multihead on the same converted weights and inputs: each
    output's distance to JAX's AMP output as a share of JAX's AMP-to-fp32
    gap, printed: under half of it everywhere."""
    jm, v, pm = models()
    image, _ = batch(seed=CID)
    emb = jnp.full((2,), CID, jnp.int32)
    outs = {}
    for amp in (False, True):
        with jax_amp() if amp else contextlib.nullcontext():
            if train:
                fn = lambda v, x: jm.apply(v, x, train=True, emb_idx=emb,  # noqa: E731
                                           rngs={"dropout": jax.random.PRNGKey(0)},
                                           mutable=["batch_stats"])[0]
            else:
                fn = lambda v, x: jm.apply(v, x, train=False, emb_idx=emb)  # noqa: E731
            outs[amp] = compile_exact(fn, v, jnp.asarray(image))(v, jnp.asarray(image))
    pm.train(train)
    with torch.no_grad(), compute_dtype(torch.bfloat16):
        port = pm(t(image), emb_idx=torch.full((2,), CID))
    want = [(n, a) for n, a in output_leaves(outs[True]) if a is not None]
    got = [(n, a) for n, a in output_leaves(port) if a is not None]
    assert [(n, dtype_name(a)) for n, a in got] == [(n, dtype_name(a)) for n, a in want]
    for (name, p), (_, j), (_, f) in zip(got, want, [(n, a) for n, a in output_leaves(outs[False]) if a is not None]):
        d, gap = np.linalg.norm(as_float32(p) - as_float32(j)), np.linalg.norm(as_float32(j) - as_float32(f))
        print(f"{'train' if train else 'eval'} {name}: |port - jax_amp| / |jax_amp - jax_fp32| = {d / gap:.4f}")
        assert d < GAP_SHARE * gap, name


ITERS, REP, MAX_ITERATIONS = 3, 1, 12


def test_two_amp_rounds_stay_in_the_adam_envelope():
    """Two FedICRA rounds (3 steps each, tree term off) under AMP in both
    packages: losses within the trajectory class (max 0.08, mean 0.02), the
    weights within Adam's 2 * sum(lr) of JAX's, the frozen PCS bit-identical."""
    jcfg, pcfg = configs(iters=ITERS, rep_iters=REP, max_iterations=MAX_ITERATIONS, amp=True)
    jm, v, pm = models()
    rounds = [batch(seed=s) for s in (0, 2, 3, 4, 5, 6)]
    data = [{"image": np.stack([b[0] for b in rounds[r:r + ITERS]]),
             "label": np.stack([b[1] for b in rounds[r:r + ITERS]])} for r in (0, ITERS)]

    jround = jax.jit(jax_make_round_fn(jm, jcfg))
    jstate = JaxState(params=v["params"], batch_stats=v["batch_stats"],
                      current_iter=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    names = {n for n, _ in pm.named_parameters()}
    sd = pm.state_dict()
    state = ClientState({n: x.clone() for n, x in sd.items() if n in names},
                        {n: x.clone() for n, x in sd.items() if n not in names},
                        0, torch.Generator().manual_seed(0))
    start = {n: x.clone() for n, x in state.params.items()}
    round_fn = make_round_fn(pm, pcfg, device="cpu")
    got, want, lrs = [], [], []
    for d in data:
        jstate, jm_ = jround(jstate, {k: jnp.asarray(x) for k, x in d.items()}, jnp.asarray(CID, jnp.int32))
        state, m = round_fn(state, d, CID)
        assert m["loss_ce"].dtype == torch.bfloat16 and m["total_loss"].dtype == torch.float32
        got += m["total_loss"].tolist()
        want += np.asarray(jm_["total_loss"]).tolist()
        lrs += np.asarray(jm_["lr"]).tolist()
    diff = np.abs(np.asarray(got) - np.asarray(want))
    print(f"AMP rounds: total_loss |port - jax| per step {np.round(diff, 5).tolist()}")
    assert diff.max() < 0.08 and diff.mean() < 0.02
    envelope = 2 * sum(lrs)
    mine = dict(flat(state_dict_to_flax({**state.params, **state.batch_stats})[0]))
    theirs = dict(flat(jax.tree.map(np.asarray, jstate.params)))
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert np.abs(mine[k] - theirs[k]).max() <= envelope, "/".join(k)
    for n in start:
        if ".pcs" in n:
            assert torch.equal(start[n], state.params[n]), n
    assert state.current_iter == int(jstate.current_iter) == 2 * ITERS


def test_train_cli_runs_amp_on_cpu(tmp_path, capsys):
    """``--amp 1`` reaches the trainer: the training forwards give bf16
    logits, ALA's and the evaluation's stay fp32; the run ends on its JSON."""
    seen = []

    def hook(module, args, out):
        if isinstance(out, dict) and "logits" in out:
            seen.append((module.training, out["logits"].dtype))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        result = port_train.main([
            "--synthetic", "--device", "cpu", "--img_class", "odoc", "--strategy", "FedICRA",
            "--procedure", "pce", "--model", "unet_lc_multihead", "--img_size", "16",
            "--batch_size", "2", "--iters", "2", "--rep_iters", "1", "--eval_iters", "2",
            "--stop_after", "2", "--limit_per_client", "2", "--amp", "1",
            "--snapshot_root", str(tmp_path), "--exp", "amp",
        ])
    finally:
        handle.remove()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    losses = [result["final"][f"client_{c}_total_loss"] for c in range(5)]
    assert np.isfinite(losses).all() and result["final"]["val_mean_dice"] >= 0.0
    assert (True, torch.bfloat16) in seen and (False, torch.float32) in seen
    assert (False, torch.bfloat16) not in seen


def test_runner_passes_amp_on(capsys):
    port_runner.main(["--procedure", "ours", "--exp", "x", "--img_class", "odoc",
                      "--strategy", "FedICRA", "--model", "unet_lc_multihead", "--amp", "1",
                      "--debug", "1"])
    assert "--amp 1" in capsys.readouterr().out.splitlines()[0]


def test_centralized_ignores_amp():
    """``engine/centralized.py`` ignores ``cfg.amp``, as JAX's does."""
    from fedicra_torch.data import make_synthetic_split
    from fedicra_torch.engine.config import TrainConfig

    split = make_synthetic_split(4, 16, 16, 1, 2, seed=0)
    runs = []
    for amp in (False, True):
        cfg = TrainConfig.for_task("faz", img_size=16, batch_size=2, model="unet",
                                   strategy="FedAvg", procedure="pce", eval_iters=2, amp=amp)
        model = port_net_factory("unet", in_chns=1, class_num=2)
        runs.append(train_centralized(model, cfg, split, split, max_iterations=2, device="cpu"))
    (w0, h0), (w1, h1) = runs
    assert h0 == h1
    for part in ("params", "batch_stats"):
        for k in w0[part]:
            assert torch.equal(w0[part][k], w1[part][k]), k
