"""Data parallelism inside one client: its batch split over a data group.

JAX's SPMD round shards each client's batch over the mesh's ``data`` axis
and leaves that axis to GSPMD, which keeps the unsharded semantics: BatchNorm
statistics, loss means and gradients are the whole client batch's
(``fedicra_tpu/federation/sharded.py`` ``shard_body``). Here the ranks of a
data group each hold rows ``[lo, hi)`` of the client batch (the split of
``torch.tensor_split``), and the code of the main path reads the active
``DataShard`` to make the same numbers:

- ``BatchNorm`` reduces its sums over the group, with a gradient through
  the reduction (``models/blocks.py``);
- each loss term divides by the group's count, so a rank's term is its
  share of the whole batch's and the shares add up (``losses/partial.py``,
  ``losses/tree_energy.py``, ``losses/gated_crf.py``, ``batch_mean`` below
  for the contrast term);
- random draws with a batch dimension are drawn for the whole batch and
  cut to the rank's rows (``batch_draw``), so every rank's generator stays
  in step and the dropout masks are the unsharded step's;
- the local trainer and ALA sum their gradients, and the reported scalar
  metrics, over the group (``engine/trainer.py``, ``federation/ala.py``).

With no shard active every one of these paths is the single-process one.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class _GroupSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: the ranks
    run the same graph, so their backward reductions pair up in order."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


@dataclass(frozen=True)
class DataShard:
    """This rank's rows of a client batch of ``batch`` samples, split over
    the ``size`` ranks of ``group``; ``index`` is the rank's place in it."""

    group: Any
    index: int
    size: int
    batch: int

    def __post_init__(self):
        if self.batch < self.size:
            raise ValueError(
                f"a client batch of {self.batch} cannot be split over {self.size} data ranks"
            )

    @property
    def bounds(self) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows, as ``torch.tensor_split`` cuts them."""
        q, r = divmod(self.batch, self.size)
        lo = self.index * q + min(self.index, r)
        return lo, lo + q + (self.index < r)

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        lo, hi = self.bounds
        return x.narrow(dim, lo, hi - lo)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group; its gradient is the sum of the
        ranks' gradients, so each rank's share of a loss is differentiated
        through it."""
        return _GroupSum.apply(t, self.group)

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> list:
        """Each of ``tensors`` summed over the group (no gradient), by one
        reduction of their concatenation."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def sum_scalars(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The 0-d floating metrics summed over the group (each rank holds its
        share of the batch's value); the others are left as they are."""
        keys = [k for k, v in metrics.items() if v.ndim == 0 and v.is_floating_point()]
        summed = dict(zip(keys, self.sum_flat([metrics[k] for k in keys]))) if keys else {}
        return {k: summed.get(k, v) for k, v in metrics.items()}


_SHARD: contextvars.ContextVar[Optional[DataShard]] = contextvars.ContextVar(
    "data_shard", default=None
)


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]) -> Iterator[None]:
    """Within the block the main path computes over ``shard``'s group (None:
    this process holds the whole batch)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[DataShard]:
    return _SHARD.get()


def batch_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for a draw whose dim 0 is the batch; under a shard it
    is drawn for the whole client batch and cut to this rank's rows."""
    shard = current_shard()
    if shard is None:
        return draw(tuple(shape))
    return shard.rows(draw((shard.batch, *shape[1:])))


def batch_count(n: torch.Tensor) -> torch.Tensor:
    """A count over this rank's rows, as the whole batch's (no gradient)."""
    shard = current_shard()
    if shard is None:
        return n
    n = n.detach().clone()
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=shard.group)
    return n


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` of a batch-leading tensor over the whole client
    batch; under a shard, this rank's share of it."""
    shard = current_shard()
    if shard is None:
        return torch.mean(x)
    return x.sum() / (x[0].numel() * shard.batch)
