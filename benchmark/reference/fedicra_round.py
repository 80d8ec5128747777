"""FedICRA's local round, and the other strategies' local round, in plain
PyTorch.

The reference for the local-rounds cells. One round of a client, as the
FedICRA paper and the reference's ``flower_runner.py`` train it. The model
is the configuration's ``model`` module (``reference/models/``); the
objective is the configuration's ``train.procedure``:

- "ours": loss = pCE + tree energy (``tree_loss_weight``) + ``gatecrf_weight``
  x gated CRF + ``alpha`` x contrast;
- "pce": loss = pCE, + ``alpha`` x contrast under FedICRA with a
  client-conditioned model;
- pCE: cross-entropy averaged over the labelled pixels (label
  ``num_classes`` marks an unlabelled one);
- tree energy: ``tree_chain.multi_scale_tree_energy`` on the unlabelled
  pixels, the image (a gray one repeated to 3 channels) as the low guide
  and the three deep-supervision outputs as the high guides;
- gated CRF: the Potts kernel exp(-1/2 ||f(q + o) - f(q)||^2) with f =
  [column / 6, row / 6, image / 0.1], over the offsets of a (2r + 1)^2
  window but the centre, times 1 - <y(q), y(q + o)>, y the softmax, y and
  f zero outside the image, summed and divided by B H W;
- contrast (FedICRA, a model that gives the PCS ``heatmap``): -(1 / (K -
  1)) sum over the other clients k of the mean squared gap between the
  bottleneck's PCS heatmap under this client's one-hot and, with no
  gradient, under client k's (the reference code uses this client's own
  one-hot where k is 0), each of those K - 1 forwards in train mode with
  its own dropout draws;
- AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-2), started afresh
  for each phase. The phases are the strategy's: under FedICRA the first
  ``iters - rep_iters`` steps train only the out conv (the head), the last
  ``rep_iters`` every other trainable parameter; under any other strategy
  one phase of ``iters`` steps trains every trainable parameter. PCS never
  trains, and the deep-supervision heads only while the tree term reads
  them ("ours" with the tree term on). The rate of step j is base_lr (1 -
  (start + j) / max_iter)^0.9.

``fault="half_batch"`` trains each step on the first half of its batch:
one of the faults the comparison has to catch.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .models import never
from .tree_chain import multi_scale_tree_energy

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


def fedicra(config: dict) -> bool:
    return config["train"]["strategy"] == "FedICRA"


def contrast_forwards(model: ModuleType, config: dict) -> int:
    """The no-grad forwards of the contrast term a step runs: K - 1 under
    FedICRA with a model that gives the PCS heatmap, else none."""
    if fedicra(config) and getattr(model, "HEATMAP", False):
        return config["task"]["num_clients"] - 1
    return 0


def phases(model: ModuleType, config: dict, names) -> List[Tuple[str, List[str], int, int]]:
    """(label, the leaves it trains, first step, end) of each phase of the
    round, over the parameter ``names``."""
    t = config["train"]
    is_pcs, is_dsn_head = getattr(model, "is_pcs", never), getattr(model, "is_dsn_head", never)
    dsn_idle = t["procedure"] != "ours" or t["tree_loss_weight"] == 0.0
    trainable = [n for n in names if not is_pcs(n) and not (dsn_idle and is_dsn_head(n))]
    if not fedicra(config):
        return [("full", trainable, 0, t["iters"])]
    n_head = t["iters"] - t["rep_iters"]
    return [("head", [n for n in trainable if model.is_head(n)], 0, n_head),
            ("body", [n for n in trainable if not model.is_head(n)], n_head, t["iters"])]


def _contrast(forward, K: int, p, images, heat, cid: int, generator) -> torch.Tensor:
    batch = images.shape[0]
    gaps = []
    for k in range(K):
        if k == cid:
            continue
        other = torch.full((batch,), cid if k == 0 else k, dtype=torch.long, device=images.device)
        with torch.no_grad():
            heat_k = forward(p, images, other, generator)["heatmap"]
        gaps.append(((heat - heat_k) ** 2).mean())
    return -torch.stack(gaps).sum() / (K - 1)


def objective(model: ModuleType, config: dict, p, images, labels, cid: int, generator,
              round_bits: Optional[int] = None, stats: Optional[dict] = None) -> torch.Tensor:
    """The step's loss under the configuration's procedure."""
    t, C = config["train"], config["task"]["num_classes"]
    if t["procedure"] not in ("ours", "pce"):
        raise ValueError(f"the reference trains 'ours' or 'pce', not {t['procedure']!r}")
    client = torch.full((images.shape[0],), cid, dtype=torch.long, device=images.device)

    def forward(*args):
        return model.forward(config, *args, round_bits=round_bits)

    out = forward(p, images, client, generator)
    logits = out["logits"]
    loss = partial_cross_entropy(logits, labels, C)
    if t["procedure"] == "ours":
        if t["tree_loss_weight"]:
            guide = images.repeat(1, 1, 1, 3) if images.shape[-1] == 1 else images
            loss = loss + multi_scale_tree_energy(logits, guide, out["aux"], labels == C,
                                                  t["tree_loss_weight"], stats=stats)
        loss = loss + t["gatecrf_weight"] * gated_crf(torch.softmax(logits, dim=-1), images,
                                                      t["gatecrf_radius"])
    if contrast_forwards(model, config):
        loss = loss + t["alpha"] * _contrast(forward, config["task"]["num_clients"], p, images, out["heatmap"], cid, generator)
    return loss


def reference_round(model: ModuleType, config: dict, params: Dict[str, torch.Tensor], images: torch.Tensor,
                    labels: torch.Tensor, cid: int, generator: torch.Generator, *, start_iter: int = 0,
                    round_bits: Optional[int] = None, fault: Optional[str] = None,
                    record_grads=(0,)) -> dict:
    """One round of client ``cid`` from ``params`` over ``images`` [iters, B,
    H, W, C_in] and ``labels`` [iters, B, H, W]: the model module ``model``
    at the configuration's ``widths``, the objective and the schedule of its
    ``train`` block; ``start_iter`` is the client's iteration count.

    Returns ``losses`` (one float per step), ``grads`` ({step: {name: the
    norm of the gradient that step's optimizer gets}} for the steps in
    ``record_grads``), ``params`` (after the round) and ``depths`` (the
    first step's four trees' depths, [4, B], where the tree term runs)."""
    t = config["train"]
    p = {n: t_.detach().clone() for n, t_ in params.items()}
    out = {"losses": [], "grads": {}, "depths": None}
    for _, live, lo, hi in phases(model, config, list(params)):
        m = {n: torch.zeros_like(p[n]) for n in live}
        v = {n: torch.zeros_like(p[n]) for n in live}
        for j in range(lo, hi):
            step = j - lo + 1
            lr = t["base_lr"] * (1.0 - (start_iter + j) / t["max_iterations"]) ** 0.9
            for n in live:
                p[n].requires_grad_(True)
            x, y = images[j], labels[j]
            if fault == "half_batch":
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            stats = {} if j == 0 else None
            loss = objective(model, config, p, x, y, cid, generator, round_bits, stats)
            grads = torch.autograd.grad(loss, [p[n] for n in live])
            out["losses"].append(float(loss.detach()))
            if stats is not None:
                out["depths"] = stats.get("depths")
            if j in record_grads:
                out["grads"][j] = {n: float(g.norm()) for n, g in zip(live, grads)}
            with torch.no_grad():
                bc1, bc2 = 1.0 - BETAS[0] ** step, 1.0 - BETAS[1] ** step
                for n, g in zip(live, grads):
                    w = p[n].detach()
                    w.mul_(1.0 - lr * WEIGHT_DECAY)
                    m[n].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                    v[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    denom = (v[n].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                    w.addcdiv_(m[n], denom, value=-lr / bc1)
                    p[n] = w
    out["params"] = {n: t_.detach() for n, t_ in p.items()}
    return out
