"""Gated CRF loss (Obukhov et al. 2019): the live Potts surface and the full one.

Counterpart of ``fedicra_tpu/losses/gated_crf.py`` (reference
gate_crf_loss.py:20-122). Tensors are NHWC: ``softmax_probs`` (B, H, W, C),
``image`` (B, H, W, C_img). The live "Ours" objective uses one Potts kernel
``{weight 1, xy 6, rgb 0.1}`` with no masks:

    L = sum_{b,q,o != 0} k_o(q) (1 - <y(q), y(q+o)>) / (B H W)
    k_o(q) = exp(-1/2 ||f(q+o) - f(q)||^2),  f = [x/6, y/6, rgb/0.1]

with y and f zero outside the image (the reference's ``unfold`` padding).
``gated_crf_loss_auto`` computes it with the CUDA kernel on the card;
``gated_crf_loss`` with every argument at its default is the kernel's
plain twin. The rest of the surface (several kernels, xy-only kernels,
``mask_src``, ``mask_dst``, ``compatibility``), which no live procedure
uses, is plain PyTorch on the inputs' device, as JAX computes it with XLA
ops: it streams over the offsets, each recomputed in the backward
(``torch.utils.checkpoint``), so autograd holds no offset's residuals.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.gated_crf_cuda import gated_crf_potts, gated_crf_potts_plain, offset_windows

LIVE_KERNEL = {"weight": 1.0, "xy": 6.0, "rgb": 0.1}  # the "Ours" objective's only kernel


def gated_crf_features(image: torch.Tensor, sigma_xy: float,
                       sigma_rgb: Optional[float] = None) -> torch.Tensor:
    """The [x/sigma_xy, y/sigma_xy, rgb/sigma_rgb] stack, NHWC (x = column
    index); xy only when ``sigma_rgb`` is None."""
    b, h, w, _ = image.shape
    cols = torch.arange(w, dtype=image.dtype, device=image.device)[None, :].expand(h, w)
    rows = torch.arange(h, dtype=image.dtype, device=image.device)[:, None].expand(h, w)
    feats = [torch.stack([cols, rows], dim=-1)[None].expand(b, h, w, 2) / sigma_xy]
    if sigma_rgb is not None:
        feats.append(image / sigma_rgb)
    return torch.cat(feats, dim=-1)


def _planes(softmax_probs: torch.Tensor, image: torch.Tensor):
    """(y, f) planes; y keeps its dtype (bf16 under AMP), f is float32."""
    feats = gated_crf_features(image, LIVE_KERNEL["xy"], LIVE_KERNEL["rgb"])
    y = softmax_probs.permute(0, 3, 1, 2).contiguous()
    f = feats.float().permute(0, 3, 1, 2).contiguous()
    return y, f


def _fix_mask(mask: torch.Tensor) -> torch.Tensor:
    """Reference mask conditioning (gate_crf_loss.py:66-76): NaN -> 0, then
    anything below 1.0 (interpolation edges) -> 0. Accepts (B,H,W) or
    (B,H,W,1); returns (B,H,W)."""
    if mask.ndim == 4:
        mask = mask[..., 0]
    mask = torch.nan_to_num(mask, nan=0.0)
    return torch.where(mask < 1.0, torch.zeros_like(mask), mask)


def gated_crf_loss(
    softmax_probs: torch.Tensor,
    image: torch.Tensor,
    *,
    radius: int = 5,
    kernels_desc: Optional[List[dict]] = None,
    mask_src: Optional[torch.Tensor] = None,
    mask_dst: Optional[torch.Tensor] = None,
    compatibility: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The gated CRF loss value (0-dim), plain PyTorch on any device.

    With every argument at its default, the live Potts loss by the kernel's
    twin. Otherwise the full ModelLossSemsegGatedCRF surface:
    - each kernel ``{weight, xy, rgb}`` adds ``weight * exp(-1/2 ||df||^2)``
      over its features (xy only without ``rgb``);
    - ``mask_src`` gates kernel values at the neighbour (zero outside the
      image) and sets the denominator to its sum (at least 1);
    - ``mask_dst`` gates them at the centre and overrides the denominator
      (the reference applies src, then dst: the last write wins);
    - ``compatibility`` (C, C, non-negative, zero diagonal) replaces the
      Potts model: loss = sum(k * y^T compat_n y(.+o)) with compat_n =
      (C-1) * row-L1-normalised compatibility, without the kernels' sum.
    """
    if kernels_desc is None and mask_src is None and mask_dst is None and compatibility is None:
        return gated_crf_potts_plain(*_planes(softmax_probs, image), radius)
    if kernels_desc is None:
        kernels_desc = [LIVE_KERNEL]

    b, h, w, c = softmax_probs.shape
    pad = (radius,) * 4
    y = softmax_probs.permute(0, 3, 1, 2)
    y_pad = F.pad(y, pad)
    kernels = []
    for desc in kernels_desc:
        f = gated_crf_features(image, desc["xy"], desc.get("rgb")).permute(0, 3, 1, 2)
        kernels.append((desc["weight"], f, F.pad(f, pad)))

    denom = float(b * h * w)
    if mask_src is not None:
        mask_src = _fix_mask(mask_src)
        denom = torch.clamp(mask_src.sum(), min=1.0)
        src_pad = F.pad(mask_src, pad)
    if mask_dst is not None:
        mask_dst = _fix_mask(mask_dst)
        denom = torch.clamp(mask_dst.sum(), min=1.0)
    if compatibility is not None:
        compat = torch.as_tensor(compatibility, dtype=torch.float32, device=y.device)
        compat = (c - 1) * compat / torch.clamp(compat.abs().sum(dim=1, keepdim=True), min=1e-12)

    def offset_term(y, y_pad, win):
        k = torch.zeros((b, h, w), dtype=torch.float32, device=y.device)
        for weight, f, f_pad in kernels:
            diff = f_pad[win] - f
            k = k + weight * torch.exp(-0.5 * (diff * diff).sum(dim=1))
        if mask_src is not None:
            k = k * src_pad[win[:1] + win[2:]]
        if mask_dst is not None:
            k = k * mask_dst
        y_sh = y_pad[win]
        if compatibility is None:
            return (k * (1.0 - (y_sh * y).sum(dim=1))).sum()
        return (k * (y * torch.einsum("cd,bdhw->bchw", compat, y_sh)).sum(dim=1)).sum()

    total = y.new_zeros((), dtype=torch.float32)
    for win in offset_windows(radius, h, w):
        total = total + checkpoint(offset_term, y, y_pad, win, use_reentrant=False)
    return total / denom


def gated_crf_loss_auto(softmax_probs: torch.Tensor, image: torch.Tensor, *, radius: int = 5) -> torch.Tensor:
    """Live-path dispatch: the CUDA kernel for CUDA tensors, the twin on the CPU.

    Potts with no masks, the one surface the kernel takes (as JAX's Pallas
    kernel). The guide features are a gradient leaf, as in the live objective.
    """
    return gated_crf_potts(*_planes(softmax_probs, image), radius)
