"""FedICRA's ``unet_lc_multihead``: the U-Net with PCS on the bottleneck and
deep-supervision heads, as ``reference/unet_lc.py`` writes it out."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..unet_lc import (UNetLCMultiHead, check_widths, decoder_convs, encoder_convs, head_sources,
                       param_specs as _param_specs)

HEATMAP = True
CONSTANT_INPUT = ("encoder.pcs0.fc1_a", "encoder.pcs0.fc1_b")  # the client's one-hot and its embedding


def is_head(name: str) -> bool:
    return name.startswith("decoder.out_conv.")


def is_pcs(name: str) -> bool:
    return any(part.startswith("pcs") for part in name.split("."))


def is_dsn_head(name: str) -> bool:
    return any(part.startswith("dsn_head") for part in name.split("."))


def param_specs(config: dict):
    task = config["task"]
    return _param_specs(task["in_chns"], task["num_classes"], task["num_clients"], config["widths"])


def port_kwargs(config: dict) -> dict:
    w = config["widths"]
    return dict(num_clients=config["task"]["num_clients"], pcs_num=w["pcs_stages"], dropout=w["dropout"],
                dsn_dropout=w["dsn_dropout"])


def forward(config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor, client: torch.Tensor,
            generator: Optional[torch.Generator], round_bits: Optional[int] = None) -> dict:
    model = UNetLCMultiHead(config["task"]["num_clients"], config["widths"], round_bits=round_bits)
    logits, aux, heat = model(params, images, client, generator)
    return {"logits": logits, "aux": aux, "heatmap": heat}


def convs(config: dict) -> List[Tuple[str, int, int, int, int, int]]:
    widths, task = config["widths"], config["task"]
    check_widths(widths)
    f, hidden, img, k = widths["features"], widths["dsn_hidden"], task["img_size"], task["num_clients"]
    hid, pcs = max(f[4] // 16, 1), "encoder.pcs0"
    out = encoder_convs(task["in_chns"], f, img)
    out += [(f"{pcs}.fc1_a", k, f[4], 1, 1, 1), (f"{pcs}.fc1_b", f[4], f[4], 1, 1, 1)]
    out += [(f"{pcs}.fc2_a", 2 * f[4], hid, 1, 1, 1), (f"{pcs}.fc2_b", hid, f[4], 1, 1, 1)] * 2  # avg, max
    out += decoder_convs(task["num_classes"], f, img)
    for i in head_sources(widths):
        px = (img >> (3 - i)) ** 2  # up stage i's output
        out += [(f"decoder.dsn_head{i}.conv", f[3 - i], hidden, 3, px, 1),
                (f"decoder.dsn_head{i}.out", hidden, task["num_classes"], 1, px, 1)]
    return out
