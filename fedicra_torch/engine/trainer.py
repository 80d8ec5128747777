"""Local training: one federated round of head/body phases.

Counterpart of ``fedicra_tpu/engine/trainer.py``:

- AdamW(betas (0.9, 0.999), eps 1e-8, weight decay 1e-2) is recreated for
  each phase, so the moments reset; the LR of step j of a phase is
  ``poly_lr(base_lr, start + offset + j)``.
- FedICRA: the first ``iters - rep_iters`` steps update only
  ``decoder.out_conv``; the last ``rep_iters`` steps update everything else.
- Frozen parameters are left out of the optimizer (no moment, no weight
  decay) and get ``requires_grad=False``; gradients still flow through
  them. That covers PCS always, and the DSN heads under the pCE objective or
  under "ours" with ``tree_loss_weight == 0`` (no loss reaches them).
- Under a data shard (``parallel/data_axis.py``) ``batches`` hold this
  rank's rows of the client batch; the gradients and the scalar metrics
  are summed over the data group before each step, so every rank takes
  the step of the whole batch.
- ``cfg.amp``: the objective (its forwards and the backward through them)
  runs under ``compute_dtype(torch.bfloat16)``, as JAX's ``loss_fn`` sets
  the compute dtype; parameters, gradients and AdamW's state stay fp32, and
  bf16 needs no gradient scaler.

A ``ClientState`` holds one client's weights as tensors on the device, so
one model object can serve every client in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.blocks import compute_dtype, init_torch_default
from ..models.params_filters import is_dsn_head, is_head, is_pcs
from ..parallel.data_axis import current_shard
from ..utils.profiling import HostSyncs, annotate
from .config import TrainConfig
from .objective import get_objective


@dataclass
class ClientState:
    """Per-client training state carried across federated rounds."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    current_iter: int  # global iteration count
    generator: torch.Generator  # dropout draws; advanced by every round


def poly_lr(base_lr: float, it: int, max_iterations: int) -> float:
    return base_lr * (1.0 - it / max_iterations) ** 0.9


def _split_state(model) -> tuple:
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return params, stats


def init_client_state(model, cfg: TrainConfig, seed: Optional[int] = None, device=None) -> ClientState:
    """Draw the model's weights from a generator seeded with ``seed`` (default
    ``cfg.seed``; the same for every client) and place them on ``device``.

    ``efficient_unet`` then loads ``cfg.encoder_weights``, an
    efficientnet-pytorch B3 ``.pth``, into its encoder when one is given.
    """
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    init_torch_default(model, torch.Generator().manual_seed(seed))
    if cfg.model == "efficient_unet" and cfg.encoder_weights:
        from ..models.efficientunet import load_pretrained_encoder

        load_pretrained_encoder(model, cfg.encoder_weights)
    model.to(device)
    params, stats = _split_state(model)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return ClientState(params, stats, 0, generator)


def make_round_fn(model, cfg: TrainConfig, device=None):
    """Build ``round_fn(state, batches, cid, on_step=None) -> (state, metrics)``.

    ``batches`` = {'image': [iters, B, H, W, C], 'label': [iters, B, H, W]}
    (tensors or numpy arrays). ``metrics`` maps each name to a tensor of
    shape [iters]. ``on_step(j, metrics_j)``, if given, is called after each
    optimizer step.

    Under a ``torch.profiler`` session the round emits the spans
    ``fedicra.round.load_state``, ``.phase_setup`` (each phase),
    ``.split_state``, ``fedicra.step`` (ids ``cid``, ``j``, ``phase``; closed
    before ``on_step``) and ``fedicra.step.backward``, and on a card counts its
    host syncs, ``on_step``'s left out (``utils/profiling.py``).
    """
    device = resolve_device(device)
    model.to(device)
    objective = get_objective(cfg)
    amp_dtype = torch.bfloat16 if cfg.amp else None
    names = [n for n, _ in model.named_parameters()]

    def trainable(n: str) -> bool:
        if is_pcs(n):
            return False
        dsn_idle = cfg.procedure == "pce" or (
            cfg.procedure == "ours" and cfg.tree_loss_weight == 0.0
        )
        return not (is_dsn_head(n) and dsn_idle)

    head = [n for n in names if is_head(n)]
    body = [n for n in names if not is_head(n) and trainable(n)]
    full = [n for n in names if trainable(n)]

    def round_fn(state: ClientState, batches, cid: int, on_step: Optional[Callable] = None):
        with HostSyncs(device) as syncs:
            with annotate("fedicra.round.load_state", cid=cid):
                model.load_state_dict({**state.params, **state.batch_stats})
                model.train()
                shard = current_shard()
                images = torch.as_tensor(batches["image"], device=device).float()
                labels = torch.as_tensor(batches["label"], device=device).long()
            start = state.current_iter
            if cfg.fedicra:
                n_head = cfg.iters - cfg.rep_iters
                phases = [("head", head, 0, n_head), ("body", body, n_head, cfg.iters)]
            else:
                phases = [("full", full, 0, cfg.iters)]

            history: List[Dict[str, torch.Tensor]] = []
            for phase, group, lo, hi in phases:
                with annotate("fedicra.round.phase_setup", cid=cid, phase=phase):
                    live = set(group)
                    for n, p in model.named_parameters():
                        p.requires_grad_(n in live)
                    opt = torch.optim.AdamW(
                        [p for n, p in model.named_parameters() if n in live],
                        lr=poly_lr(cfg.base_lr, start + lo, cfg.max_iterations),
                        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
                    )
                for j in range(lo, hi):
                    with annotate("fedicra.step", cid=cid, j=j, phase=phase):
                        lr = poly_lr(cfg.base_lr, start + j, cfg.max_iterations)
                        for g in opt.param_groups:
                            g["lr"] = lr
                        opt.zero_grad(set_to_none=True)
                        batch = {"image": images[j], "label": labels[j]}
                        with compute_dtype(amp_dtype):
                            loss, metrics = objective(model, batch, cid, cfg, state.generator)
                        with annotate("fedicra.step.backward"):
                            loss.backward()
                        metrics = {k: v.detach() for k, v in metrics.items()}
                        if shard is not None:
                            grads = [p.grad for n, p in model.named_parameters()
                                     if n in live and p.grad is not None]
                            for g, total in zip(grads, shard.sum_flat(grads)):
                                g.copy_(total)
                            metrics = shard.sum_scalars(metrics)
                        opt.step()
                        metrics["lr"] = torch.tensor(lr)
                        history.append(metrics)
                    if on_step is not None:
                        with syncs.paused():
                            on_step(j, metrics)

            with annotate("fedicra.round.split_state", cid=cid):
                for p in model.parameters():
                    p.requires_grad_(True)
                params, stats = _split_state(model)
                new_state = ClientState(params, stats, start + cfg.iters, state.generator)
                stacked = {k: torch.stack([h[k].to(device) for h in history]) for k in history[0]}
            return new_state, stacked

    return round_fn
