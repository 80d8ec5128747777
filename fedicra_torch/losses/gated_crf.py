"""Gated CRF loss (Obukhov et al. 2019), the live surface of the "Ours" objective.

Counterpart of ``fedicra_tpu/losses/gated_crf.py`` for one Potts kernel
``{weight 1, xy 6, rgb 0.1}`` with no masks and no compatibility matrix
(the mask/compatibility surface is queued in ROADMAP.md). Tensors are NHWC:
``softmax_probs`` (B, H, W, C), ``image`` (B, H, W, C_img).

    L = sum_{b,q,o != 0} k_o(q) (1 - <y(q), y(q+o)>) / (B H W)
    k_o(q) = exp(-1/2 ||f(q+o) - f(q)||^2),  f = [x/6, y/6, rgb/0.1]

with y and f zero outside the image (the reference's ``unfold`` padding).
"""

from __future__ import annotations

import torch

from ..ops.gated_crf_cuda import gated_crf_potts, gated_crf_potts_plain

LIVE_KERNEL = {"weight": 1.0, "xy": 6.0, "rgb": 0.1}  # the "Ours" objective's only kernel


def gated_crf_features(image: torch.Tensor, sigma_xy: float, sigma_rgb: float) -> torch.Tensor:
    """The [x/sigma_xy, y/sigma_xy, rgb/sigma_rgb] stack, NHWC (x = column index)."""
    b, h, w, _ = image.shape
    cols = torch.arange(w, dtype=image.dtype, device=image.device)[None, :].expand(h, w)
    rows = torch.arange(h, dtype=image.dtype, device=image.device)[:, None].expand(h, w)
    mesh = torch.stack([cols, rows], dim=-1)[None].expand(b, h, w, 2)
    return torch.cat([mesh / sigma_xy, image / sigma_rgb], dim=-1)


def _planes(softmax_probs: torch.Tensor, image: torch.Tensor):
    """(y, f) planes; y keeps its dtype (bf16 under AMP), f is float32."""
    feats = gated_crf_features(image, LIVE_KERNEL["xy"], LIVE_KERNEL["rgb"])
    y = softmax_probs.permute(0, 3, 1, 2).contiguous()
    f = feats.float().permute(0, 3, 1, 2).contiguous()
    return y, f


def gated_crf_loss(softmax_probs: torch.Tensor, image: torch.Tensor, *, radius: int = 5) -> torch.Tensor:
    """The plain PyTorch gated CRF, on any device (the kernel's twin)."""
    return gated_crf_potts_plain(*_planes(softmax_probs, image), radius)


def gated_crf_loss_auto(softmax_probs: torch.Tensor, image: torch.Tensor, *, radius: int = 5) -> torch.Tensor:
    """Live-path dispatch: the CUDA kernel for CUDA tensors, the twin on the CPU.

    The guide features are a gradient leaf, as in the live objective.
    """
    return gated_crf_potts(*_planes(softmax_probs, image), radius)
