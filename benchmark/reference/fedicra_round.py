"""FedICRA's local round with the "ours" objective, in plain PyTorch.

The reference for the local-rounds cells. One round of a client, as the
FedICRA paper and the reference's ``flower_runner.py`` train it:

- loss = pCE + tree energy (``tree_loss_weight``) + ``gatecrf_weight`` x
  gated CRF + ``alpha`` x contrast;
- pCE: cross-entropy averaged over the labelled pixels (label
  ``num_classes`` marks an unlabelled one);
- tree energy: ``tree_chain.multi_scale_tree_energy`` on the unlabelled
  pixels, the image (a gray one repeated to 3 channels) as the low guide
  and the three deep-supervision outputs as the high guides;
- gated CRF: the Potts kernel exp(-1/2 ||f(q + o) - f(q)||^2) with f =
  [column / 6, row / 6, image / 0.1], over the offsets of a (2r + 1)^2
  window but the centre, times 1 - <y(q), y(q + o)>, y the softmax, y and
  f zero outside the image, summed and divided by B H W;
- contrast: -(1 / (K - 1)) sum over the other clients k of the mean
  squared gap between the bottleneck's PCS heatmap under this client's
  one-hot and, with no gradient, under client k's (the reference code uses
  this client's own one-hot where k is 0), each of those K - 1 forwards in
  train mode with its own dropout draws;
- AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-2), started afresh
  for each phase: the first ``iters - rep_iters`` steps train only the out
  conv (the head), the last ``rep_iters`` every parameter but the head and
  PCS; PCS never trains, and the deep-supervision heads only while the tree
  term is on. The rate of step j is base_lr (1 - (start + j) / max_iter)^0.9.

``fault="half_batch"`` trains each step on the first half of its batch:
one of the faults the comparison has to catch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .tree_chain import multi_scale_tree_energy
from .unet_lc import UNetLCMultiHead

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-2


def partial_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    valid = labels != num_classes
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def gated_crf(probs: torch.Tensor, image: torch.Tensor, radius: int) -> torch.Tensor:
    """The Potts gated CRF of NHWC softmax ``probs`` guided by NHWC ``image``."""
    b, h, w, _ = probs.shape
    cols = torch.arange(w, dtype=image.dtype, device=image.device).expand(h, w)
    rows = torch.arange(h, dtype=image.dtype, device=image.device)[:, None].expand(h, w)
    f = torch.cat([torch.stack([cols, rows])[None].expand(b, 2, h, w) / 6.0,
                   image.permute(0, 3, 1, 2) / 0.1], dim=1)
    y = probs.permute(0, 3, 1, 2)
    r = radius
    f_pad, y_pad = F.pad(f, (r,) * 4), F.pad(y, (r,) * 4)
    total = torch.zeros((), dtype=torch.float64, device=probs.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            win = (slice(None), slice(None), slice(r + dy, r + dy + h), slice(r + dx, r + dx + w))
            k = torch.exp(-0.5 * ((f_pad[win] - f) ** 2).sum(dim=1))
            total = total + (k * (1.0 - (y_pad[win] * y).sum(dim=1))).sum().double()
    return (total / (b * h * w)).float()


def ours_loss(model: UNetLCMultiHead, p, images, labels, cid: int, cfg: dict, generator,
              stats: Optional[dict] = None) -> torch.Tensor:
    C, K = cfg["num_classes"], cfg["num_clients"]
    batch = images.shape[0]
    client = torch.full((batch,), cid, dtype=torch.long, device=images.device)
    logits, aux, heat = model(p, images, client, generator)
    loss = partial_cross_entropy(logits, labels, C)
    if cfg["tree_loss_weight"]:
        guide = images.repeat(1, 1, 1, 3) if images.shape[-1] == 1 else images
        loss = loss + multi_scale_tree_energy(logits, guide, aux, labels == C,
                                              cfg["tree_loss_weight"], stats=stats)
    loss = loss + cfg["gatecrf_weight"] * gated_crf(torch.softmax(logits, dim=-1), images,
                                                    cfg["gatecrf_radius"])
    gaps = []
    for k in range(K):
        if k == cid:
            continue
        other = torch.full((batch,), cid if k == 0 else k, dtype=torch.long, device=images.device)
        with torch.no_grad():
            heat_k = model(p, images, other, generator)[2]
        gaps.append(((heat - heat_k) ** 2).mean())
    return loss + cfg["alpha"] * (-torch.stack(gaps).sum() / (K - 1))


def is_head(name: str) -> bool:
    return name.startswith("decoder.out_conv.")


def is_pcs(name: str) -> bool:
    return any(part.startswith("pcs") for part in name.split("."))


def is_dsn_head(name: str) -> bool:
    return any(part.startswith("dsn_head") for part in name.split("."))


def reference_round(params: Dict[str, torch.Tensor], images: torch.Tensor, labels: torch.Tensor,
                    cid: int, cfg: dict, generator: torch.Generator, *, round_bits: Optional[int] = None,
                    fault: Optional[str] = None, record_grads=(0,)) -> dict:
    """One FedICRA round from ``params`` over ``images`` [iters, B, H, W,
    C_in] and ``labels`` [iters, B, H, W]; ``cfg`` holds the model's
    ``widths`` and the objective's and the schedule's numbers
    (``start_iter`` the client's iteration count).

    Returns ``losses`` (one float per step), ``grads`` ({step: {name: the
    norm of the gradient that step's optimizer gets}} for the steps in
    ``record_grads``), ``params`` (after the round) and ``depths`` (the
    first step's four trees' depths, [4, B])."""
    model = UNetLCMultiHead(cfg["num_clients"], cfg["widths"], round_bits=round_bits)
    iters, rep = cfg["iters"], cfg["rep_iters"]
    dsn_idle = cfg["tree_loss_weight"] == 0.0
    trainable = [n for n in params if not is_pcs(n) and not (dsn_idle and is_dsn_head(n))]
    phases = [([n for n in trainable if is_head(n)], 0, iters - rep),
              ([n for n in trainable if not is_head(n)], iters - rep, iters)]
    p = {n: t.detach().clone() for n, t in params.items()}
    out = {"losses": [], "grads": {}, "depths": None}
    for live, lo, hi in phases:
        m = {n: torch.zeros_like(p[n]) for n in live}
        v = {n: torch.zeros_like(p[n]) for n in live}
        for j in range(lo, hi):
            t = j - lo + 1
            lr = cfg["base_lr"] * (1.0 - (cfg["start_iter"] + j) / cfg["max_iterations"]) ** 0.9
            for n in live:
                p[n].requires_grad_(True)
            x, y = images[j], labels[j]
            if fault == "half_batch":
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            stats = {} if j == 0 else None
            loss = ours_loss(model, p, x, y, cid, cfg, generator, stats)
            grads = torch.autograd.grad(loss, [p[n] for n in live])
            out["losses"].append(float(loss.detach()))
            if stats is not None:
                out["depths"] = stats.get("depths")
            if j in record_grads:
                out["grads"][j] = {n: float(g.norm()) for n, g in zip(live, grads)}
            with torch.no_grad():
                bc1, bc2 = 1.0 - BETAS[0] ** t, 1.0 - BETAS[1] ** t
                for n, g in zip(live, grads):
                    w = p[n].detach()
                    w.mul_(1.0 - lr * WEIGHT_DECAY)
                    m[n].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                    v[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    denom = (v[n].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                    w.addcdiv_(m[n], denom, value=-lr / bc1)
                    p[n] = w
    out["params"] = {n: t.detach() for n, t in p.items()}
    return out
