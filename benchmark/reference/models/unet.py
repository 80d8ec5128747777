"""The plain ``unet`` of the reference's pCE baseline: ``unet_lc_multihead``'s
encoder and decoder without PCS or deep-supervision heads.

``widths``: the five ``features`` and the encoder stages' five ``dropout``
rates (the published model: 16 / 32 / 64 / 128 / 256 and 0.05 / 0.1 / 0.2 /
0.3 / 0.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..unet_lc import UNetOps, decoder_convs, decoder_specs, encoder_convs, encoder_specs


def check_widths(widths: dict) -> None:
    if len(widths["features"]) != 5 or len(widths["dropout"]) != 5:
        raise ValueError(f"five feature widths and dropout rates, got {widths}")


def is_head(name: str) -> bool:
    return name.startswith("decoder.out_conv.")


def param_specs(config: dict) -> List[Tuple[str, tuple, Optional[int]]]:
    task, f = config["task"], config["widths"]["features"]
    check_widths(config["widths"])
    return encoder_specs(task["in_chns"], f) + decoder_specs(task["num_classes"], f)


def port_kwargs(config: dict) -> dict:
    return dict(dropout=config["widths"]["dropout"])


def forward(config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor, client: torch.Tensor,
            generator: Optional[torch.Generator], round_bits: Optional[int] = None) -> dict:
    """``client`` is not read: the plain model is not client-conditioned."""
    check_widths(config["widths"])
    ops = UNetOps(round_bits)
    skips = ops.encoder(params, images.permute(0, 3, 1, 2), config["widths"]["dropout"], generator)
    ups = ops.up(params, skips, generator)
    return {"logits": ops.conv(params, "decoder.out_conv", ups[-1]).permute(0, 2, 3, 1)}


def convs(config: dict) -> List[Tuple[str, int, int, int, int, int]]:
    task, f = config["task"], config["widths"]["features"]
    return (encoder_convs(task["in_chns"], f, task["img_size"])
            + decoder_convs(task["num_classes"], f, task["img_size"]))
