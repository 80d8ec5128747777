"""Experiment configuration: the port's own copy of ``fedicra_tpu.engine.config``.

A typed mirror of the reference's argparse surface, with the per-task tables
(dataset root, classes, channels, per-client supervision types).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

PERSONALIZED_FL = ("FedICRA",)
CENTRALIZED_FL = ("FedAvg", "FedAdagrad", "FedAdam", "FedYogi")
STRATEGIES = PERSONALIZED_FL + CENTRALIZED_FL

PROCEDURES = ("pce", "treeenergy_add", "ours")

TASKS: Dict[str, dict] = {
    "faz": dict(
        root_subdir="FAZ_h5",
        num_classes=2,
        in_chns=1,
        img_size=256,
        sup_types={
            "client1": "scribble_noisy",
            "client2": "keypoint",
            "client3": "block",
            "client4": "box",
            "client5": "scribble",
        },
    ),
    "odoc": dict(
        root_subdir="ODOC_h5",
        num_classes=3,
        in_chns=3,
        img_size=384,
        sup_types={
            "client1": "scribble",
            "client2": "scribble_noisy",
            "client3": "scribble_noisy",
            "client4": "keypoint",
            "client5": "block",
        },
    ),
    "polyp": dict(
        root_subdir="Polypdata_h5",
        num_classes=2,
        in_chns=3,
        img_size=384,
        sup_types={
            "client1": "keypoint",
            "client2": "scribble",
            "client3": "box",
            "client4": "block",
        },
    ),
}


@dataclass(frozen=True)
class TrainConfig:
    img_class: str = "odoc"
    num_classes: int = 3
    in_chns: int = 3
    img_size: int = 384
    model: str = "unet_lc_multihead"
    procedure: str = "ours"
    strategy: str = "FedICRA"
    num_clients: int = 5
    batch_size: int = 12
    base_lr: float = 0.01
    max_iterations: int = 30000
    iters: int = 10  # local iterations per federated round
    eval_iters: int = 20
    ckpt_iters: int = 3000
    max_consecutive_failures: int = 10
    rep_iters: int = 3  # body-phase iterations per round (FedICRA)
    alpha: float = 0.5  # contrast loss weight
    tree_loss_weight: float = 0.1
    gatecrf_weight: float = 0.1
    gatecrf_radius: int = 5
    amp: bool = False
    ala_skip_iters: int = 50
    seed: int = 2022
    encoder_weights: str = None

    @property
    def fedicra(self) -> bool:
        return self.strategy in PERSONALIZED_FL

    def validate(self) -> "TrainConfig":
        if self.img_class not in TASKS:
            raise ValueError(f"unknown img_class {self.img_class!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.procedure not in PROCEDURES:
            raise ValueError(f"unknown procedure {self.procedure!r}")
        if self.procedure == "ours" and self.model not in (
            "unet_multihead",
            "unet_lc_multihead",
        ):
            raise ValueError(f"procedure 'ours' needs a multihead model, got {self.model!r}")
        if self.strategy in PERSONALIZED_FL and not self.model.startswith("unet_lc"):
            raise ValueError("FedICRA requires an LC model")
        return self

    @classmethod
    def for_task(cls, img_class: str, **overrides) -> "TrainConfig":
        t = TASKS[img_class]
        base = dict(
            img_class=img_class,
            num_classes=t["num_classes"],
            in_chns=t["in_chns"],
            img_size=t["img_size"],
            num_clients=len(t["sup_types"]),
        )
        base.update(overrides)
        return cls(**base).validate()

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
