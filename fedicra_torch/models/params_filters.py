"""Predicates over the port's parameter names (``model.named_parameters()``).

Counterpart of ``fedicra_tpu/models/params_filters.py``; a name here is the
dotted PyTorch name, e.g. ``decoder.out_conv.weight``.

- head: ``decoder.out_conv.*``, the FedICRA local head trained alone in the
  head phase;
- ALA-gated: names with any of ``out_conv, up4, up3, up2, up1`` in a
  component, never PCS;
- PCS: the personalised channel selection, frozen and not federated;
- DSN head: the deep-supervision heads, frozen when no loss reaches them.
"""

from __future__ import annotations

ALA_GATED_KEYS = ("out_conv", "up4", "up3", "up2", "up1")


def is_pcs(name: str) -> bool:
    return any(part.startswith("pcs") for part in name.split("."))


def is_head(name: str) -> bool:
    return name.startswith("decoder.out_conv.")


def is_dsn_head(name: str) -> bool:
    return any(part.startswith("dsn_head") for part in name.split("."))


def is_ala_gated(name: str) -> bool:
    if is_pcs(name):
        return False
    return any(k in part for part in name.split(".") for k in ALA_GATED_KEYS)
