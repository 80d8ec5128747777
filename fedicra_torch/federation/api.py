"""Transport-agnostic federated messaging types.

Counterpart of ``fedicra_tpu/federation/api.py``, shaped after Flower's
FitIns/FitRes/EvaluateIns/EvaluateRes so that a cross-site transport can be
slotted under the same server loop that drives the in-process federation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

Payload = Any  # {'params': {name: Tensor}, 'batch_stats': {name: Tensor}}, state_dict names


@dataclass
class FitIns:
    payload: Payload
    config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class FitRes:
    payload: Payload
    num_examples: int  # reference quirk: batch count, not sample count
    metrics: Dict[str, Any] = field(default_factory=dict)
    fit_duration: float = 0.0


@dataclass
class EvaluateIns:
    payload: Payload
    config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvaluateRes:
    loss: float
    num_examples: int
    metrics: Dict[str, Any] = field(default_factory=dict)
