"""The federated round over a (client, data) mesh of process ranks.

Counterpart of ``fedicra_tpu/federation/sharded.py``. There the whole round
(each client's ALA merge, its K local steps, the server's weighted mean) is
one SPMD program over a device mesh. Here each device is a rank
(``parallel/mesh.py``), and every rank runs the same round over the
clients it holds (``Mesh.clients``):

- each client's ALA merge and then ``make_round_fn``'s K steps, over this
  rank's rows of the client's batches when the data axis has more than one
  rank (``parallel/data_axis.py`` keeps the whole batch's numbers, as GSPMD
  does in JAX);
- FedAvg: each rank's weighted mean of its clients, scaled by their share of
  the total weight and summed over the client group (JAX's ``psum`` over
  ``client``, :234-237). The ranks of a data group hold the same client
  states, so each client counts once in every client group.

ALA covers both regimes, as JAX's ``lax.while_loop`` does: one
gate-learning epoch in the steady state, and in the first round past
``cfg.ala_skip_iters`` epochs until the std of the last 10 losses is below
0.1 (at most ``ALA_MAX_EPOCHS``). Whether a round is that first run is
derived from ``iter_global`` (rounds advance by ``cfg.iters``). The loop is
the host client's (``ala.learn_gates``). Epoch source: with ``ala_raw`` (the
clients' split arrays, when every split has the same size) each epoch is
drawn afresh from the ALA stream's seed and its carried counter by
``data/batcher.py`` ``materialize_epoch``, the function the host client's
``EpochBatcher`` draws with, so both see the same epochs bit for bit;
otherwise every epoch replays the ``ala_batches`` tensor.

Differences from JAX:
- ALA's dropout draws come from a generator per client that the caller
  passes (the in-process client's ALA stream); JAX splits them from the
  state's key.
- The metrics keep every step ([iters]); the experiment logs the last, as
  JAX's round returns it.
- JAX's round takes the weighted mean whatever ``cfg.strategy`` says, so its
  ``--sharded`` runs FedAvg under a FedOpt strategy. The port refuses any
  strategy but FedAvg and FedICRA (``check_strategy``).
- ``place_stacked`` is not ported: a rank's clients live on its device from
  the start, and the all-reduce leaves the global payload on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..data.batcher import materialize_epoch
from ..device import resolve_device
from ..engine.config import TrainConfig
from ..engine.trainer import ClientState, make_round_fn
from ..parallel.data_axis import current_shard, data_shard
from .ala import learn_gates
from .strategies import stacked_weighted_mean

SHARDED_STRATEGIES = ("FedAvg", "FedICRA")

Tree = Dict[str, torch.Tensor]


def check_strategy(cfg: TrainConfig) -> None:
    """The sharded round aggregates by FedAvg's weighted mean only."""
    if cfg.strategy not in SHARDED_STRATEGIES:
        raise ValueError(
            f"the sharded federation aggregates by FedAvg's weighted mean only; strategy "
            f"{cfg.strategy!r} is not supported with --sharded (fedicra_tpu's sharded round "
            f"ignores it and averages). Drop --sharded to run {cfg.strategy}."
        )


def _materialize_ala_epoch(seed: int, epoch: int, images, labels, cfg: TrainConfig):
    """The ALA stream's epoch ``epoch``, as its EpochBatcher draws it."""
    imgs, labs = materialize_epoch(images, labels, seed, epoch, cfg.batch_size,
                                   cfg.num_classes, cfg.img_class)
    return {"image": imgs, "label": labs}


def _ala_merge_spmd(model, cfg: TrainConfig, local_params: Tree, global_params: Tree,
                    stats: Tree, ala_batches, generator: Optional[torch.Generator], cid: int,
                    first_run: bool, ala_raw=None, ala_seed: Optional[int] = None,
                    counter0: int = 0):
    """ALA's merge: one epoch, or the first run's epochs until converged.

    Each epoch is drawn from ``ala_raw`` by the ALA stream's seed and the
    carried counter (the host client's ``_ala_epoch_counter``), or replays
    ``ala_batches``; under a data shard this rank takes its rows. Returns
    (merged params, new counter)."""
    counter = counter0

    def epoch(_n):
        nonlocal counter
        counter += 1  # the host client counts before it draws
        if ala_raw is not None:
            batches = _materialize_ala_epoch(ala_seed, counter, ala_raw["image"],
                                             ala_raw["label"], cfg)
        else:
            batches = ala_batches
        shard = current_shard()
        if shard is not None:
            batches = {k: shard.rows(torch.as_tensor(v), dim=1) for k, v in batches.items()}
        return batches

    params, _, _ = learn_gates(model, cfg, local_params, global_params, stats, epoch,
                               generator, cid, first_run)
    return params, counter


def _fedavg(trees: Sequence[Tree], weights: torch.Tensor, total: torch.Tensor, group) -> Tree:
    """The weighted mean of every client's tree: this rank's clients'
    ``trees`` with their ``weights``, the sum of every client's weight
    ``total``, summed over the client ``group`` (None: this rank holds
    every client)."""
    if not trees[0]:
        return {}
    stacked = {name: torch.stack([t[name] for t in trees]) for name in trees[0]}
    mean = stacked_weighted_mean(stacked, weights)
    if group is None:
        return mean
    share = weights.sum() / total
    flat = torch.cat([(leaf.float() * share).reshape(-1) for leaf in mean.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = {}, 0
    for name, leaf in mean.items():
        out[name] = flat[at:at + leaf.numel()].view(leaf.shape).to(leaf.dtype)
        at += leaf.numel()
    return out


def make_sharded_round_fn(model, cfg: TrainConfig, mesh, device=None):
    """Build the sharded federated round for this rank.

    Returns fn(states, global_payload, batches, ala_batches, iter_global,
    weights, ala_raw=None, ala_seeds=None, ala_counters=None,
    ala_generators=None, on_step=None) -> (states, global_payload, metrics,
    ala_counters):

    states: {cid: ClientState} for this rank's clients
    batches: {cid: {'image': [iters, B, H, W, C], 'label': [iters, B, H, W]}}
        (the whole client batch; each rank of a data group takes its rows)
    ala_batches: the same with the ALA epoch's batch count, or None
    weights: [K], every client's batch count (the FedAvg weighting)
    ala_raw: {cid: {'image', 'label'}} the split arrays, or None;
        ala_seeds: {cid: seed of its ALA stream}
    ala_counters: {cid: ALA epochs drawn so far};
        ala_generators: {cid: ALA's dropout generator}
    on_step(cid, j, metrics_j): called after each optimizer step
    metrics: {cid: {name: tensor [iters]}}
    """
    check_strategy(cfg)
    round_fn = make_round_fn(model, cfg, device=resolve_device(device))
    shard = mesh.data_shard(cfg.batch_size)
    skip_iters = cfg.ala_skip_iters

    def fed_round(states, global_payload, batches, ala_batches, iter_global: int, weights,
                  ala_raw=None, ala_seeds=None, ala_counters=None, ala_generators=None,
                  on_step: Optional[Callable] = None):
        gp, gs = global_payload["params"], global_payload["batch_stats"]
        ala_counters = dict(ala_counters or {})
        ala_generators = ala_generators or {}
        has_ala = cfg.fedicra and (ala_batches is not None or ala_raw is not None)
        # the first ALA run is the first round past the skip horizon
        first_run = skip_iters < iter_global <= skip_iters + cfg.iters
        new_states, metrics = {}, {}
        with data_shard(shard):
            for cid in mesh.clients:
                state = states[cid]
                params = gp
                if has_ala and iter_global > skip_iters:
                    params, ala_counters[cid] = _ala_merge_spmd(
                        model, cfg, state.params, gp, gs,
                        ala_batches[cid] if ala_batches is not None else None,
                        ala_generators.get(cid), cid, first_run,
                        ala_raw=ala_raw[cid] if ala_raw is not None else None,
                        ala_seed=ala_seeds[cid] if ala_seeds is not None else None,
                        counter0=ala_counters.get(cid, 0),
                    )
                state = ClientState(params, gs, state.current_iter, state.generator)
                b = {k: torch.as_tensor(v) for k, v in batches[cid].items()}
                if shard is not None:
                    b = {k: shard.rows(v, dim=1) for k, v in b.items()}
                step = None if on_step is None else (lambda j, m, _c=cid: on_step(_c, j, m))
                new_states[cid], metrics[cid] = round_fn(state, b, cid, on_step=step)

        w_all = torch.as_tensor(weights, dtype=torch.float32)
        w = w_all[list(mesh.clients)]
        held = [new_states[c] for c in mesh.clients]
        new_global = {
            "params": _fedavg([s.params for s in held], w, w_all.sum(), mesh.client_group),
            "batch_stats": _fedavg([s.batch_stats for s in held], w, w_all.sum(),
                                   mesh.client_group),
        }
        return new_states, new_global, metrics, ala_counters

    return fed_round
