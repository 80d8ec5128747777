"""Centralized (non-federated) single-site baseline trainer.

Counterpart of ``fedicra_tpu/engine/centralized.py`` (the reference's
Unet_pCE.py:63-244): partial-CE loss only, SGD(momentum 0.9, weight decay
1e-4) with the poly LR set per iteration, validation every ``eval_iters``
iterations into the history and the metrics log. Like the JAX version it
saves no checkpoint and ignores ``cfg.amp``.

Every parameter takes part in every step, as in JAX, where a parameter that
no loss reaches has a zero gradient: its gradient is a zero tensor, not
None, so SGD still applies the weight decay (wd * p, added to the gradient
before the momentum) and the momentum to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.batcher import EpochBatcher
from ..data.h5io import ClientSplit
from ..device import resolve_device
from ..evaluation.evaluate import evaluate_client
from ..losses.partial import partial_cross_entropy
from ..utils.logging import MetricsWriter
from .config import TrainConfig
from .trainer import ClientState, _split_state, init_client_state, poly_lr

WEIGHT_DECAY = 1e-4


def train_centralized(
    model,
    cfg: TrainConfig,
    train_split: Optional[ClientSplit],
    val_split: Optional[ClientSplit],
    max_iterations: Optional[int] = None,
    eval_iters: Optional[int] = None,
    snapshot_dir: Optional[str] = None,
    seed: Optional[int] = None,
    batcher=None,
    loss_log: Optional[list] = None,
    init_state: Optional[ClientState] = None,
    device=None,
):
    """Run the centralized pCE baseline; returns (state, history).

    ``state`` is {"params": ..., "batch_stats": ...} (state_dict names).
    ``batcher`` overrides the EpochBatcher (any object with ``batch_at(it)``);
    ``loss_log``, when given, collects the per-iteration train losses;
    ``init_state`` replaces ``init_client_state(model, cfg, seed)``. Runs on
    the card unless ``device`` names another."""
    max_iterations = max_iterations or cfg.max_iterations
    eval_iters = eval_iters or cfg.eval_iters
    seed = cfg.seed if seed is None else seed
    device = resolve_device(device)

    state = init_state or init_client_state(model, cfg, seed, device=device)
    model.to(device)
    model.load_state_dict({**state.params, **state.batch_stats})
    model.train()
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    opt = torch.optim.SGD(
        params, lr=poly_lr(cfg.base_lr, 0, max_iterations),
        momentum=0.9, weight_decay=WEIGHT_DECAY,
    )

    if batcher is None:
        batcher = EpochBatcher(
            train_split, cfg.batch_size, cfg.num_classes, cfg.img_class, seed=seed,
            device=device,
        )
    writer = MetricsWriter(snapshot_dir)

    history = []
    for it in range(max_iterations):
        batch = batcher.batch_at(it)
        images = torch.as_tensor(batch["image"], device=device).float()
        labels = torch.as_tensor(batch["label"], device=device).long()
        for g in opt.param_groups:
            g["lr"] = poly_lr(cfg.base_lr, it, max_iterations)
        opt.zero_grad(set_to_none=False)
        out = model(images, generator=state.generator)
        loss = partial_cross_entropy(out["logits"], labels, cfg.num_classes)
        loss.backward()
        opt.step()
        if loss_log is not None:
            loss_log.append(loss.item())
        if (it + 1) % eval_iters == 0:
            p, s = _split_state(model)
            m = evaluate_client(
                model, p, s, val_split.images, val_split.labels, cfg.num_classes,
                device=device,
            )
            rec = {"iter": it + 1, "loss": loss.item(), **m}
            history.append(rec)
            writer.write(it + 1, rec)
    writer.close()
    params, stats = _split_state(model)
    return {"params": params, "batch_stats": stats}, history
