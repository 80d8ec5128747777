"""FedICRA's federated round around the local round, in plain PyTorch: the
client's adaptive local aggregation (ALA) and the server's FedAvg.

The reference for the federated cells, stage by stage; the local round
between the two is ``fedicra_round.reference_round``. It follows the FedICRA
paper (arXiv:2304.05635) and the reference code's ``MyModel.set_weights``
(ALA) and flwr's FedAvg:

- ALA: a client that receives the global weights keeps them for every leaf
  but the gated ones (the decoder's up stages and its out conv: a name with
  ``out_conv``, ``up1`` ... ``up4`` in a component, never a PCS leaf), and
  for each gated leaf learns a per-element gate w, from all ones, over one
  epoch of its training batches: merged = global + (local - global) w, the
  partial cross-entropy of the model at the merged weights (train mode:
  dropout drawn from the client's ALA stream, BatchNorm on the batch's
  statistics; the running statistics' updates are discarded), then
  w <- clamp(w - eta grad (local - global), 0, 1) with eta = 1 and grad the
  loss's gradient at the merged leaf;
- FedAvg: the mean of the clients' trees (weights and BatchNorm
  statistics) weighted by their batch counts, in float64;
- a client's epoch (the reference's ``DataLoader(shuffle=True)`` over its
  ``RandomGenerator``, dataset.py:186-251): its split in a random order,
  wrapped to whole batches, each sample with p = 0.5 turned by ``np.rot90``
  (k in 0..3) and flipped over an axis, then with p = 0.5 rotated by an
  integer angle in [-45, 45) as ``scipy.ndimage.rotate(order=0,
  reshape=False)`` does (nearest source pixel, coordinates in float32,
  label fill ``num_classes``, image fill 0.8 for FAZ and 0 otherwise).
  The order and the draws come from the sampling stream the program names,
  (seed, epoch): CPU generators seeded ((seed * 1,000,003 + epoch) * 2 +
  s) mod 2**63, s = 0 for the order and 1 for the draws.

``round_bits`` rounds the model's convolution operands as in the local
round's control.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, Optional, Sequence, Tuple

import torch

from .fedicra_round import partial_cross_entropy

GATED_KEYS = ("out_conv", "up4", "up3", "up2", "up1")
ETA = 1.0

Tree = Dict[str, torch.Tensor]


def is_gated(name: str) -> bool:
    """A leaf whose merge ALA learns."""
    parts = name.split(".")
    if any(part.startswith("pcs") for part in parts):
        return False
    return any(k in part for part in parts for k in GATED_KEYS)


def ala_merge(model: ModuleType, config: dict, local: Tree, global_: Tree, images: torch.Tensor,
              labels: torch.Tensor, cid: int, generator: Optional[torch.Generator],
              round_bits: Optional[int] = None) -> Tree:
    """Client ``cid``'s merged weights after one gate-learning epoch over
    ``images`` [nb, B, H, W, C_in] and ``labels`` [nb, B, H, W]: every leaf
    of ``global_``, the gated ones blended with ``local``."""
    C = config["task"]["num_classes"]
    gated = [n for n in global_ if is_gated(n)]
    delta = {n: local[n] - global_[n] for n in gated}
    gates = {n: torch.ones_like(global_[n]) for n in gated}
    for x, y in zip(images, labels):
        merged = {n: (global_[n] + delta[n] * gates[n]).requires_grad_(True) for n in gated}
        client = torch.full((x.shape[0],), cid, dtype=torch.long, device=x.device)
        out = model.forward(config, {**global_, **merged}, x.float(), client, generator,
                            round_bits=round_bits)
        loss = partial_cross_entropy(out["logits"], y.long(), C)
        grads = torch.autograd.grad(loss, [merged[n] for n in gated])
        with torch.no_grad():
            gates = {n: torch.clamp(gates[n] - ETA * g * delta[n], 0.0, 1.0)
                     for n, g in zip(gated, grads)}
    return {n: global_[n] + delta[n] * gates[n] if n in gates else global_[n] for n in global_}


def fedavg(trees: Sequence[Tree], weights: Sequence[float]) -> Tree:
    """The weighted mean of ``trees``, leaf by leaf, in float64."""
    w = torch.as_tensor(weights, dtype=torch.float64)
    w = w / w.sum()
    return {n: sum(wi * t[n].double().cpu() for wi, t in zip(w, trees)) for n in trees[0]}


def image_cval(img_class: str) -> float:
    """The image's fill where a rotation reads outside it (dataset.py:208)."""
    return 0.8 if img_class == "faz" else 0.0


def _stream(seed: int, epoch: int, s: int) -> torch.Generator:
    return torch.Generator().manual_seed(((seed * 1_000_003 + epoch) * 2 + s) % 2**63)


def _rotate(x: torch.Tensor, angle: int, fill: float) -> torch.Tensor:
    """``x`` [H, W, ...] turned by ``angle`` degrees about its centre: each
    pixel takes its nearest source pixel, ``fill`` where that lies outside."""
    h, w = x.shape[:2]
    theta = torch.tensor(-float(angle), dtype=torch.float32, device=x.device) * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :] - cx
    sy = torch.round(cos * yy - sin * xx + cy).long()
    sx = torch.round(sin * yy + cos * xx + cx).long()
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    out = x[sy.clamp(0, h - 1), sx.clamp(0, w - 1)]
    if out.dim() > 2:
        inside = inside[..., None]
    return torch.where(inside, out, torch.full_like(out, fill))


def epoch_batches(images: torch.Tensor, labels: torch.Tensor, seed: int, epoch: int, batch_size: int,
                  num_classes: int, cval: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Epoch ``epoch`` of the stream ``seed`` over a split of images
    [N, H, W, C] and labels [N, H, W]: ([nb, B, H, W, C], [nb, B, H, W]
    int64), sample by sample."""
    n = images.shape[0]
    nb = math.ceil(n / batch_size)
    order = torch.randperm(n, generator=_stream(seed, epoch, 0)).tolist()
    order += order[:nb * batch_size - n]
    g = _stream(seed, epoch, 1)
    m = len(order)
    u = torch.rand(2, m, generator=g)
    k = torch.randint(0, 4, (m,), generator=g).tolist()
    axis = torch.randint(0, 2, (m,), generator=g).tolist()
    angle = torch.randint(-45, 45, (m,), generator=g).tolist()
    xs, ys = [], []
    for i, src in enumerate(order):
        x, y = images[src], labels[src].long()
        if u[0, i] > 0.5:
            x, y = torch.rot90(x, k[i], (0, 1)), torch.rot90(y, k[i], (0, 1))
            x, y = torch.flip(x, (axis[i],)), torch.flip(y, (axis[i],))
        if u[1, i] > 0.5:
            x, y = _rotate(x, angle[i], cval), _rotate(y, angle[i], num_classes)
        xs.append(x)
        ys.append(y)
    return (torch.stack(xs).reshape(nb, batch_size, *images.shape[1:]),
            torch.stack(ys).reshape(nb, batch_size, *labels.shape[1:]))
