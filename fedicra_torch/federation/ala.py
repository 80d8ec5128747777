"""ALA-style adaptive local aggregation (the FedICRA client-side merge).

Counterpart of ``fedicra_tpu/federation/ala.py``; reference
MyModel.set_weights (flower_common.py:491-633). On receiving the server's
global weights, a FedICRA client:

1. adopts the global weights wholesale when (a) they equal the local weights
   or (b) ``iter_global <= cfg.ala_skip_iters`` (flower_common.py:520-526);
2. otherwise loads the global weights into the "lower" layers, and for the
   "higher" layers (``params_filters.is_ala_gated``) learns per-element
   gates w in [0, 1] blending
       merged = global + (local - global) * w
   by CE loss on the local train data: one forward/backward per batch, then
       w <- clamp(w - eta * grad_merged * (local - global), 0, 1),  eta = 1
   (flower_common.py:596-597). The first time ALA runs it loops whole epochs
   until the std of the last 10 per-epoch losses drops below 0.1 (at most
   ``ALA_MAX_EPOCHS``); afterwards a single epoch per round.

Quirks reproduced (SURVEY §2.6):
- #3 gates re-initialise to ones every round;
- #4 the blend anchors at the *local* weights (w=1 -> local);
- the gate forward runs in train mode (dropout live, BN batch statistics)
  with the *global* running statistics, and its running-stat updates are
  discarded: the forward goes through ``torch.func.functional_call`` on the
  merged parameters and a clone of the global statistics, so neither the
  model's buffers nor the payload's change;
- the client id reaches the model as a [B] tensor (JAX: broadcast_to), so
  the ``emb_idx`` quirk (PARITY #2) takes the same branch.

Dropout draws from the client's own ``torch.Generator``. The forward keeps
its activations for the backward: the JAX version rematerialises them
(``jax.checkpoint``) only to fit TPU memory, and at 384^2, batch 12, with the
CE loss alone the card does not need it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..engine.config import TrainConfig
from ..losses.partial import partial_cross_entropy
from ..models.params_filters import is_ala_gated
from ..parallel.data_axis import current_shard

ALA_SKIP_ITERS = 50  # flower_common.py:524; TrainConfig.ala_skip_iters defaults to it
ALA_ETA = 1.0
ALA_NUM_PRE_LOSS = 10
ALA_STD_THRESHOLD = 0.1
ALA_MAX_EPOCHS = 50  # safety bound for the first-run convergence loop

Tree = Dict[str, torch.Tensor]


def _split_gated(params: Tree) -> Tuple[Tree, Tree]:
    gated = {k: v for k, v in params.items() if is_ala_gated(k)}
    rest = {k: v for k, v in params.items() if not is_ala_gated(k)}
    return gated, rest


def _blend(gates: Tree, local_g: Tree, global_g: Tree) -> Tree:
    return {k: global_g[k] + (local_g[k] - global_g[k]) * gates[k] for k in gates}


def init_gates(params: Tree) -> Tree:
    gated, _ = _split_gated(params)
    return {k: torch.ones_like(v) for k, v in gated.items()}


def ala_epoch(
    model,
    cfg: TrainConfig,
    gates: Tree,
    local_g: Tree,
    global_g: Tree,
    rest: Tree,
    stats: Tree,
    batches,
    generator: Optional[torch.Generator],
    cid: int,
) -> Tuple[Tree, float]:
    """One gate-learning epoch over ``batches`` = {'image': [nb, B, H, W, C],
    'label': [nb, B, H, W]}. Returns (gates, the last batch's loss).

    Under a data shard ``batches`` hold this rank's rows; the gates'
    gradients and the loss are summed over the data group."""
    was_training = model.training
    model.train()
    shard = current_shard()
    loss = None
    try:
        for images, labels in zip(batches["image"], batches["label"]):
            merged_g = {k: v.requires_grad_(True) for k, v in _blend(gates, local_g, global_g).items()}
            buffers = {k: v.clone() for k, v in stats.items()}  # updates discarded (quirk)
            emb = torch.full((images.shape[0],), cid, dtype=torch.long, device=images.device)
            out = functional_call(
                model, {**rest, **merged_g, **buffers}, (images.float(),),
                {"emb_idx": emb, "generator": generator},
            )
            loss = partial_cross_entropy(out["logits"], labels, cfg.num_classes)
            grads = torch.autograd.grad(loss, list(merged_g.values()))
            if shard is not None:  # this rank's share of the batch's gradient and loss
                *grads, loss = shard.sum_flat([*grads, loss])
            grads = dict(zip(merged_g, grads))
            with torch.no_grad():
                gates = {
                    k: torch.clamp(w - ALA_ETA * grads[k] * (local_g[k] - global_g[k]), 0.0, 1.0)
                    for k, w in gates.items()
                }
    finally:
        model.train(was_training)
    return gates, float(loss.detach())


def learn_gates(
    model,
    cfg: TrainConfig,
    local_params: Tree,
    global_params: Tree,
    global_stats: Tree,
    batch_provider: Callable[[int], Dict[str, torch.Tensor]],
    generator: Optional[torch.Generator],
    cid: int,
    first_run: bool,
) -> Tuple[Tree, List[float], Tree]:
    """The gates learnt from all ones (quirk #3): one epoch, or under
    ``first_run`` epochs until the std of the last 10 losses is below 0.1
    (at most ``ALA_MAX_EPOCHS``). ``batch_provider(n)`` gives the n-th
    epoch's batches. Returns (the merged params in the payload's order, the
    epochs' losses, the gates)."""
    local_g, _ = _split_gated(local_params)
    global_g, global_rest = _split_gated(global_params)
    gates = init_gates(local_params)

    losses: List[float] = []
    while True:
        gates, last_loss = ala_epoch(
            model, cfg, gates, local_g, global_g, global_rest, global_stats,
            batch_provider(len(losses)), generator, cid,
        )
        losses.append(last_loss)
        if not first_run:
            break
        if (
            len(losses) > ALA_NUM_PRE_LOSS
            and float(np.std(losses[-ALA_NUM_PRE_LOSS:])) < ALA_STD_THRESHOLD
        ):
            break
        if len(losses) >= ALA_MAX_EPOCHS:
            break

    params = {**global_rest, **_blend(gates, local_g, global_g)}
    return {k: params[k] for k in global_params}, losses, gates


def ala_set_weights(
    model,
    cfg: TrainConfig,
    local_params: Tree,
    global_params: Tree,
    global_stats: Tree,
    batch_provider: Callable[[int], Dict[str, torch.Tensor]],
    generator: Optional[torch.Generator],
    cid: int,
    iter_global: int,
    start_phase: bool,
    report: Optional[dict] = None,
) -> Tuple[Tree, Tree, bool]:
    """The full client-side merge. Returns (params, batch_stats, start_phase).

    ``batch_provider(epoch_idx)`` gives a freshly shuffled and augmented
    epoch of batches, like the reference's re-iterated DataLoader. If
    ``report`` is a dict it receives the epochs run, their losses, the gates'
    mean and the seconds taken (nothing when ALA is skipped)."""
    # skip conditions (flower_common.py:520-526): identical weights or early.
    # The reference checks only its first parameter; the whole tree is
    # compared here, as in the JAX version.
    identical = all(torch.equal(global_params[k], local_params[k]) for k in global_params)
    if identical or iter_global <= cfg.ala_skip_iters:
        return global_params, global_stats, start_phase

    t0 = time.perf_counter()
    params, losses, gates = learn_gates(
        model, cfg, local_params, global_params, global_stats, batch_provider, generator,
        cid, start_phase,
    )
    if report is not None:
        n = sum(g.numel() for g in gates.values())
        report.update(
            epochs=len(losses), losses=losses, seconds=time.perf_counter() - t0,
            gate_mean=float(sum(g.sum() for g in gates.values()) / n),
        )
    return params, global_stats, False
