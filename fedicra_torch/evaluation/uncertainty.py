"""Ensemble uncertainty of noisy, rotated copies of a batch (reference
evaluate_uncertainty, flower_common.py:155-188; present in the reference but
called by no live procedure).

Counterpart of ``fedicra_tpu/evaluation/uncertainty.py``. For each batch:
rotate by a random multiple of 90 degrees, build T=8 noisy copies (additive
N(0, 1) x 0.1 clamped to [-0.2, 0.2]), run the model on each in eval mode,
average the softmax over the ensemble and report the mean predictive
entropy. The draws (``draw_uncertainty``) are kept apart from their use, so
that a caller can feed given draws (JAX's, in the tests). Images are NHWC.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device


def draw_uncertainty(shape, num_samples: int, generator: Optional[torch.Generator] = None
                     ) -> Tuple[int, torch.Tensor]:
    """(rotation count 0-3, noise [T, B, H', W', C]) for a batch of ``shape``
    (B, H, W, C); the noise has the rotated shape, so an odd count swaps H
    and W. Drawn on the generator's device (the CPU without one)."""
    b, h, w, c = shape
    device = generator.device if generator is not None else None
    k = int(torch.randint(0, 4, (), generator=generator, device=device))
    if k % 2:
        h, w = w, h
    noise = torch.randn((num_samples, b, h, w, c), generator=generator, device=device)
    return k, noise


@torch.no_grad()
def batch_uncertainty(
    model,
    params,
    batch_stats,
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 8,
    draws: Optional[Tuple[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Mean predictive entropy (0-dim tensor) of the noisy, rotated ensemble
    of one batch, on the images' device. ``draws`` (from
    ``draw_uncertainty``) replaces drawing from ``generator``."""
    k, noise = draws if draws is not None else draw_uncertainty(images.shape, num_samples, generator)
    rotated = torch.rot90(images, k, dims=(1, 2))
    noise = torch.clamp(noise.to(images.device) * 0.1, -0.2, 0.2)
    weights = {**params, **batch_stats}
    was_training = model.training
    model.eval()
    try:
        preds = [torch.softmax(functional_call(model, weights, (rotated + n,))["logits"], dim=-1)
                 for n in noise]
    finally:
        model.train(was_training)
    mean_pred = torch.stack(preds).mean(dim=0)
    entropy = -torch.sum(mean_pred * torch.log(mean_pred + 1e-6), dim=-1)
    return entropy.mean()


def evaluate_uncertainty(
    model,
    params,
    batch_stats,
    batches: Iterable,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 8,
    device=None,
) -> float:
    """Mean uncertainty over an iterable of image batches (numpy or tensors,
    NHWC), on the card unless ``device`` names one."""
    device = resolve_device(device)
    vals = [
        float(batch_uncertainty(model, params, batch_stats, torch.as_tensor(images, device=device),
                                generator, num_samples))
        for images in batches
    ]
    return float(np.mean(vals))
