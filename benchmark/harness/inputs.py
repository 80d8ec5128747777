"""Everything a run feeds both sides, made on the device from ``--seed``.

One seed gives the same weights, images and labels in every run, and the
reference gets them from the same calls. Each draw has a generator of its
own, seeded from the run's seed and the draw's name, so adding a draw
leaves the others as they were.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the draw named by ``keys`` under the run's ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def draw_weights(specs: Sequence[Tuple[str, tuple, Optional[int]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """PyTorch's default initialisation, in one draw on the device: each
    convolution's weight and bias uniform in +-1/sqrt(fan_in), each
    BatchNorm scale 1 and shift 0. ``specs``: (name, shape, fan_in), fan_in
    None for a BatchNorm parameter."""
    sized = [(n, s, f) for n, s, f in specs if f is not None]
    total = sum(math.prod(s) for _, s, _ in sized)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=generator(device, seed, "weights"))
    out, at = {}, 0
    for name, shape, fan_in in specs:
        if fan_in is None:
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) / math.sqrt(fan_in)
        at += n
    return out


def smooth_images(g: torch.Generator, n: int, h: int, w: int, channels: int, spec: dict,
                  device) -> torch.Tensor:
    """(n, h, w, channels) images in [0, 1] that vary slowly, dark at the
    top-left: u v (a + b sin(2 pi (f_u u + f_v v) + phase)) + noise, u and v
    the column and row in [0, 1]. Slow waves keep the gated CRF's neighbour
    weights spread over (0, 1) and give the tree chain trees some thousands
    of levels deep, as a fundus or OCTA image's smooth background does."""
    lo, hi = spec["freq"]
    a, b = spec["amplitude"]
    v = torch.linspace(0.0, 1.0, h, device=device)[:, None, None]
    u = torch.linspace(0.0, 1.0, w, device=device)[None, :, None]
    freq = torch.empty((n, 1, 1, channels, 2), device=device).uniform_(lo, hi, generator=g)
    phase = torch.empty((n, 1, 1, channels), device=device).uniform_(0.0, 2 * math.pi, generator=g)
    wave = torch.sin(2 * math.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    noise = torch.empty((n, h, w, channels), device=device).normal_(generator=g)
    return (u * v * (a + b * wave) + spec["noise"] * noise).clamp_(0.0, 1.0)


def ground_truth(g: torch.Generator, n: int, h: int, w: int, num_classes: int, spec: dict,
                 device) -> torch.Tensor:
    """(n, h, w) long class maps: background 0 and one disk (class 1), with a
    concentric inner disk (class 2) when there are three classes, as an
    optic disc and cup."""
    def uniform(lo, hi):
        return torch.empty(n, device=device).uniform_(lo, hi, generator=g)

    side = min(h, w)
    cy = uniform(*spec["disk_center"]) * h
    cx = uniform(*spec["disk_center"]) * w
    r = uniform(*spec["disk_radius"]) * side
    r_in = r * uniform(*spec["inner_radius"])
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    d2 = (yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2
    gt = (d2 < (r ** 2)[:, None, None]).long()
    if num_classes == 3:
        gt = gt + (d2 < (r_in ** 2)[:, None, None]).long()
    elif num_classes != 2:
        raise ValueError(f"ground truth for 2 or 3 classes, not {num_classes}")
    return gt


def _assign(g: torch.Generator, flat: torch.Tensor, where: torch.Tensor, k: int, value) -> None:
    """Set ``flat`` (n, h * w) to ``value`` at k random pixels of each image
    among ``where`` (n, h, w) bool, or at all of them where there are fewer;
    ``value`` is a number or a function of the pixels' current labels."""
    scores = torch.rand(where.shape, device=where.device, generator=g)
    top = torch.where(where, scores, -1.0).flatten(1).topk(k, dim=1)
    cur = flat.gather(1, top.indices)
    new = value(cur) if callable(value) else torch.full_like(cur, value)
    flat.scatter_(1, top.indices, torch.where(top.values >= 0, new, cur))


def supervise(g: torch.Generator, gt: torch.Tensor, sup_type: str, num_classes: int,
              spec: dict) -> torch.Tensor:
    """The weak label of ``sup_type`` from the class maps ``gt``; the label
    ``num_classes`` marks an unlabelled pixel.

    - scribble: ``scribble_pixels`` labelled pixels a class;
    - scribble_noisy: a scribble with ``noisy_flip_share`` of its labelled
      pixels moved to the next class;
    - keypoint: ``keypoint_pixels`` labelled pixels a class;
    - box: background labelled outside the foreground's bounding box, the
      box unlabelled;
    - block: one quadrant of the image labelled in full.
    """
    n, h, w = gt.shape
    unl = num_classes
    if sup_type in ("scribble", "scribble_noisy", "keypoint"):
        k = spec["keypoint_pixels"] if sup_type == "keypoint" else spec["scribble_pixels"]
        flat = torch.full((n, h * w), unl, dtype=torch.long, device=gt.device)
        for c in range(num_classes):
            _assign(g, flat, gt == c, k, c)
        if sup_type == "scribble_noisy":
            n_flip = max(int(k * num_classes * spec["noisy_flip_share"]), 1)
            _assign(g, flat, (flat != unl).view(n, h, w), n_flip, lambda cur: (cur + 1) % num_classes)
        return flat.view(n, h, w)
    if sup_type == "box":
        fg = gt > 0
        box = fg.any(dim=2)[:, :, None] & fg.any(dim=1)[:, None, :]
        return torch.where(box, unl, 0)
    if sup_type == "block":
        q = torch.randint(0, 2, (n, 2), device=gt.device, generator=g)
        rows = (torch.arange(h, device=gt.device)[None, :] >= h // 2) == q[:, :1].bool()
        cols = (torch.arange(w, device=gt.device)[None, :] >= w // 2) == q[:, 1:].bool()
        return torch.where(rows[:, :, None] & cols[:, None, :], gt, unl)
    raise ValueError(f"unknown supervision form {sup_type!r}")


def client_pool(seed: int, cid: int, n: int, task: dict, traffic: dict, device) -> Tuple[torch.Tensor,
                                                                                        torch.Tensor]:
    """Client ``cid``'s ``n`` images (n, H, W, C_in) and weak labels (n, H, W)."""
    h = w = task["img_size"]
    g = generator(device, seed, "pool", cid)
    images = smooth_images(g, n, h, w, task["in_chns"], traffic["images"], device)
    gt = ground_truth(g, n, h, w, task["num_classes"], traffic["labels"], device)
    labels = supervise(g, gt, task["sup_types"][cid], task["num_classes"], traffic["labels"])
    return images, labels
