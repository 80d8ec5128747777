"""Weight bridge between a flax ``params``/``batch_stats`` tree and the port.

The trees are nested dicts of numpy arrays (no flax needed). The port's
module names follow the flax paths, so the mapping is a rule:

- ``.../X/conv/{kernel,bias}``  (the ``Conv`` wrapper)  -> ``X.{weight,bias}``,
  kernels HWIO -> OIHW;
- ``.../X/bn/{scale,bias}``     (the ``BatchNorm`` wrapper) -> ``X.{weight,bias}``,
  stats ``.../X/bn/{mean,var}`` -> ``X.{running_mean,running_var}``;
- ``.../dsn_headN/{conv_kernel,conv_bias,bn_scale,bn_bias,out_kernel}``
  (``DSNHead``'s raw params) -> ``dsn_headN.{conv,bn,out}.*``, stats
  ``dsn_headN/{mean,var}`` -> ``dsn_headN.bn.running_*``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DSN_PARAMS = {
    "conv_kernel": "conv.weight",
    "conv_bias": "conv.bias",
    "bn_scale": "bn.weight",
    "bn_bias": "bn.bias",
    "out_kernel": "out.weight",
}
_DSN_STATS = {"mean": "bn.running_mean", "var": "bn.running_var"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(flat) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _torch_name(path: Tuple[str, ...], stats: bool) -> str:
    *parent, owner, leaf = path
    if owner.startswith("dsn_head"):
        table = _DSN_STATS if stats else _DSN_PARAMS
        return ".".join(path[:-1] + (table[leaf],))
    if owner == "bn":
        return ".".join(parent + [_BN_LEAF[leaf]])
    if owner == "conv" and not stats:
        return ".".join(parent + ["weight" if leaf == "kernel" else "bias"])
    raise KeyError(f"no port name for flax path {'/'.join(path)}")


def flax_to_state_dict(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """flax trees (numpy leaves) -> the port's ``state_dict``."""
    sd = {}
    for stats, tree in ((False, params), (True, batch_stats)):
        for path, v in _flatten(tree):
            a = np.asarray(v, dtype=np.float32)
            if a.ndim == 4:  # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            sd[_torch_name(path, stats)] = torch.from_numpy(np.array(a, copy=True))
    return sd


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's ``state_dict`` -> (params, batch_stats) flax trees of numpy arrays."""
    bn_owners = {k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")}
    dsn_params = {v: k for k, v in _DSN_PARAMS.items()}
    dsn_stats = {v: k for k, v in _DSN_STATS.items()}
    bn_leaf = {v: k for k, v in _BN_LEAF.items()}
    params, stats = {}, {}
    for name, t in sd.items():
        a = t.detach().cpu().numpy()
        if a.ndim == 4:  # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        parts = name.split(".")
        if len(parts) >= 3 and parts[-3].startswith("dsn_head"):
            sub = ".".join(parts[-2:])
            if sub in dsn_stats:
                stats[tuple(parts[:-2]) + (dsn_stats[sub],)] = a
            else:
                params[tuple(parts[:-2]) + (dsn_params[sub],)] = a
            continue
        owner, leaf = ".".join(parts[:-1]), parts[-1]
        if owner in bn_owners:
            target = stats if leaf.startswith("running_") else params
            target[tuple(parts[:-1]) + ("bn", bn_leaf[leaf])] = a
        else:
            params[tuple(parts[:-1]) + ("conv", "kernel" if leaf == "weight" else "bias")] = a
    return _unflatten(params), _unflatten(stats)
