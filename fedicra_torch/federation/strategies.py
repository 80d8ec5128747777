"""Server aggregation strategies: FedAvg / FedAdagrad / FedAdam / FedYogi /
FedICRA.

Counterpart of ``fedicra_tpu/federation/strategies.py``. The reference's
get_strategy (flower_common.py:433-448) exposes flwr's FedAvg and the FedOpt
family; FedICRA *is* FedAvg server-side (flower_common.py:451-455), all
personalisation being client-side. Weighted aggregation uses each client's
``num_examples``, which the reference sets to the *batch count*
(flower_common.py:72, PARITY #6). The FedOpt server optimisers (Reddi et
al., Adaptive Federated Optimization; flwr 1.0 defaults eta=1e-1,
beta_1=0.9, beta_2=0.99, tau=1e-9) act on the aggregate delta.

A tree here is a flat dict {name: Tensor}. The server aggregates a payload's
two parts, "params" and "batch_stats", by two calls; a FedOpt strategy keeps
its moments per part, so each part's update is what one fresh strategy
object gives on that part alone. (The JAX version keeps one set of moments
shaped like the params and fails on the second part.)
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..engine.config import CENTRALIZED_FL, PERSONALIZED_FL  # noqa: F401  (re-exported)

Tree = Dict[str, torch.Tensor]


def weighted_tree_mean(trees: Sequence[Tree], weights: Sequence[float]) -> Tree:
    """Weighted average of trees (the FedAvg aggregate): weights normalised
    in float32, one contraction over a stacked client axis, cast back to the
    leaf's dtype."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    out = {}
    for name, leaf in trees[0].items():
        stacked = torch.stack([t[name] for t in trees])
        out[name] = torch.tensordot(w.to(stacked.device), stacked.float(), dims=1).to(leaf.dtype)
    return out


class Strategy:
    """Server strategy: aggregates client results into new global weights."""

    name = "base"

    def aggregate(self, global_tree: Tree, client_trees: Sequence[Tree],
                  weights: Sequence[float], part: str = "params") -> Tree:
        raise NotImplementedError


class FedAvg(Strategy):
    name = "FedAvg"

    def aggregate(self, global_tree, client_trees, weights, part="params"):
        return weighted_tree_mean(client_trees, weights)


class FedICRA(FedAvg):
    """Server-side identical to FedAvg (flower_common.py:451-455)."""

    name = "FedICRA"

    def __repr__(self):
        return "FedICRA(server_side=FedAvg)"


class _FedOpt(Strategy):
    def __init__(self, eta: float = 1e-1, beta_1: float = 0.9,
                 beta_2: float = 0.99, tau: float = 1e-9):
        self.eta = eta
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.tau = tau
        self._m: Dict[str, Tree] = {}  # per payload part
        self._v: Dict[str, Tree] = {}

    def _update_v(self, v, d):
        raise NotImplementedError

    def aggregate(self, global_tree, client_trees, weights, part="params"):
        y = weighted_tree_mean(client_trees, weights)
        delta = {k: y[k] - global_tree[k] for k in y}
        if part not in self._m:
            self._m[part] = {k: torch.zeros_like(d) for k, d in delta.items()}
            self._v[part] = {k: torch.zeros_like(d) for k, d in delta.items()}
        m, v = self._m[part], self._v[part]
        for k, d in delta.items():
            m[k] = self.beta_1 * m[k] + (1 - self.beta_1) * d
            v[k] = self._update_v(v[k], d)
        return {
            k: x + self.eta * m[k] / (torch.sqrt(v[k]) + self.tau)
            for k, x in global_tree.items()
        }


class FedAdagrad(_FedOpt):
    name = "FedAdagrad"

    def __init__(self, **kw):
        kw.setdefault("beta_1", 0.0)
        super().__init__(**kw)

    def _update_v(self, v, d):
        return v + d * d


class FedAdam(_FedOpt):
    name = "FedAdam"

    def _update_v(self, v, d):
        return self.beta_2 * v + (1 - self.beta_2) * d * d


class FedYogi(_FedOpt):
    name = "FedYogi"

    def _update_v(self, v, d):
        d2 = d * d
        return v - (1 - self.beta_2) * d2 * torch.sign(v - d2)


def get_strategy(name: str, **kwargs) -> Strategy:
    table = {c.name: c for c in (FedAvg, FedICRA, FedAdagrad, FedAdam, FedYogi)}
    if name not in table:
        raise ValueError(f"unknown strategy {name!r}")
    return table[name](**kwargs)
