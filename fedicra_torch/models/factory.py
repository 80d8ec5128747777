"""Model factory with the reference's ``net_factory`` model-type strings.

Slice 1 ports ``unet_lc_multihead``, the FedICRA flagship; the other model
types raise ``NotImplementedError`` until their slice lands (ROADMAP.md).
"""

from __future__ import annotations

from torch import nn

from .unet import UNetLCMultiHead

MODEL_TYPES = (
    "unet",
    "unet_cct",
    "unet_cct_3h",
    "unet_ds",
    "efficient_unet",
    "pnet",
    "unet_head",
    "unet_multihead",
    "unet_lc",
    "unet_lc_multihead",
    "unet_lc_multihead_two",
)


def net_factory(
    net_type: str = "unet",
    in_chns: int = 1,
    class_num: int = 3,
    *,
    num_clients: int = 5,
    client_id: int = 0,
    pcs_num: int = 1,
    dropout=None,
    dsn_dropout=None,
) -> nn.Module:
    """Build the model on the CPU; ``init_client_state`` draws its weights."""
    if net_type == "unet_lc_multihead":
        kw = {}
        if dropout is not None:
            kw["dropout"] = tuple(dropout)
        if dsn_dropout is not None:
            kw["dsn_dropout"] = float(dsn_dropout)
        return UNetLCMultiHead(
            in_chns=in_chns,
            num_classes=class_num,
            num_clients=num_clients,
            client_id=client_id,
            pcs_num=pcs_num,
            **kw,
        )
    if net_type in MODEL_TYPES:
        raise NotImplementedError(
            f"model type {net_type!r} is not ported yet (ROADMAP.md, remaining model types)"
        )
    raise ValueError(f"unknown net_type {net_type!r}; expected one of {MODEL_TYPES}")
