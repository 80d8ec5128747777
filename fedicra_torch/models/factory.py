"""Model factory with the reference's ``net_factory`` model-type strings.

Counterpart of ``fedicra_tpu/models/factory.py``, with its keyword surface:
``dropout`` reaches ``unet`` and the LC models, ``dsn_dropout`` only
``unet_lc_multihead``. ``pnet`` and ``efficient_unet`` are not ported yet and
raise ``NotImplementedError`` (ROADMAP.md, queue 1, the remaining model
types).
"""

from __future__ import annotations

from torch import nn

from .unet import (
    UNet,
    UNetCCT,
    UNetCCT3H,
    UNetDS,
    UNetHead,
    UNetLC,
    UNetLCMultiHead,
    UNetLCMultiHeadTwo,
    UNetMultiHead,
)

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

# Model types whose forward accepts/uses a client embedding index.
LC_MODELS = ("unet_lc", "unet_lc_multihead", "unet_lc_multihead_two")

_PLAIN = {
    "unet_cct": UNetCCT,
    "unet_cct_3h": UNetCCT3H,
    "unet_ds": UNetDS,
    "unet_head": UNetHead,
    "unet_multihead": UNetMultiHead,
}
_LC = {"unet_lc": UNetLC, "unet_lc_multihead": UNetLCMultiHead,
       "unet_lc_multihead_two": UNetLCMultiHeadTwo}


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
    kw = {} if dropout is None else {"dropout": tuple(dropout)}
    if net_type == "unet":
        return UNet(in_chns=in_chns, num_classes=class_num, **kw)
    if net_type in _PLAIN:
        return _PLAIN[net_type](in_chns=in_chns, num_classes=class_num)
    if net_type in _LC:
        if net_type == "unet_lc_multihead" and dsn_dropout is not None:
            kw["dsn_dropout"] = float(dsn_dropout)
        return _LC[net_type](
            in_chns=in_chns,
            num_classes=class_num,
            num_clients=num_clients,
            client_id=client_id,
            pcs_num=pcs_num,
            **kw,
        )
    if net_type in MODEL_TYPES:
        raise NotImplementedError(
            f"model type {net_type!r} is not ported yet "
            "(ROADMAP.md, queue 1: the remaining model types)"
        )
    raise ValueError(f"unknown net_type {net_type!r}; expected one of {MODEL_TYPES}")
