"""DenseCRF loss (Tang et al. regularized-loss form), exact.

Counterpart of ``fedicra_tpu/losses/dense_crf.py::dense_crf_loss``; NHWC::

    L = -(weight / B) * sum_b sum_i sum_j k(f_i, f_j) s_i s_j,  s = probs * ROI,
    k = exp(-||dxy||^2 / (2 sxy^2) - ||drgb||^2 / (2 srgb^2))

with the inputs downscaled by ``scale_factor`` (images and ROIs nearest,
probabilities linear with antialiasing, as ``jax.image.resize`` does) and
sigma_xy scaled with them. The filter is the exact Gaussian kernel filter
of ``ops/gaussian_filter_cuda.py``: its CUDA kernel on the card, its plain
twin on the CPU. The gradient to the probabilities follows by autograd
(the filter is linear and its kernel symmetric).

``dense_crf_loss_lattice`` is the reference's own evaluation
(DenseCRFLoss.py): the host permutohedral lattice (``ops/permutohedral.py``)
in place of the exact filter, returning the loss and its gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.gaussian_filter_cuda import bilateral_features, gaussian_kernel_filter
from ..ops.permutohedral import permutohedral_filter
from .tree_energy import resize_linear, resize_nearest


def dense_crf_loss(
    images: torch.Tensor,  # [B, H, W, C] in [0, 1]
    probs: torch.Tensor,  # [B, H, W, K] softmax scores
    rois: torch.Tensor,  # [B, H, W]
    *,
    weight: float = 2e-9,
    sigma_rgb: float = 15.0,
    sigma_xy: float = 100.0,
    scale_factor: float = 0.5,
    image_scale: float = 255.0,
) -> torch.Tensor:
    """Scalar dense-CRF loss. ``image_scale`` maps [0, 1] inputs to the
    uint8 intensity range the reference's sigmas are calibrated for."""
    b, h, w, k = probs.shape
    hw = (int(h * scale_factor), int(w * scale_factor))
    img_s = resize_nearest(images * image_scale, hw)
    probs_s = resize_linear(probs, hw)
    rois_s = resize_nearest(rois[..., None].to(probs.dtype), hw)
    seg = (probs_s * rois_s).reshape(b, hw[0] * hw[1], k)
    feats = bilateral_features(img_s, sigma_rgb, sigma_xy * scale_factor)
    AS = gaussian_kernel_filter(feats.detach(), seg)
    return -weight * torch.sum(seg * AS) / b


def resize_nearest_floor(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The lattice route's nearest resize of [B, H, W, ...]: source index
    floor(i * in / out), as ``dense_crf_loss_lattice`` in fedicra_tpu takes
    it (not ``resize_nearest``, the exact loss's)."""
    ys = (torch.arange(hw[0], dtype=torch.float64) * (x.shape[1] / hw[0])).long()
    xs = (torch.arange(hw[1], dtype=torch.float64) * (x.shape[2] / hw[1])).long()
    return x[:, ys.to(x.device)][:, :, xs.to(x.device)]


def dense_crf_loss_lattice(
    images: torch.Tensor,  # [B, H, W, C] in [0, 1]
    probs: torch.Tensor,  # [B, H, W, K] softmax scores
    rois: torch.Tensor,  # [B, H, W]
    *,
    weight: float = 2e-9,
    sigma_rgb: float = 15.0,
    sigma_xy: float = 100.0,
    scale_factor: float = 0.5,
    image_scale: float = 255.0,
) -> Tuple[float, torch.Tensor]:
    """The same loss evaluated on the host permutohedral lattice, the
    reference's execution model (DenseCRFLoss.py forward/backward through
    bilateralfilter_batch). Returns (loss, d_probs): d_probs [B, oh, ow, K]
    is the gradient at the downscaled size, as the reference's backward
    leaves it (DenseCRFLoss.py:32-44), on ``probs``' device.

    Probabilities shrink by ``resize_linear``; images and ROIs by the
    lattice route's own nearest index, floor(i * in / out).
    """
    b, h, w, k = probs.shape
    oh, ow = int(h * scale_factor), int(w * scale_factor)
    with torch.no_grad():
        img_s = resize_nearest_floor(images.float() * image_scale, (oh, ow))
        probs_s = resize_linear(probs.float(), (oh, ow))
        rois_s = resize_nearest_floor(rois.float()[..., None], (oh, ow))
        sxy = sigma_xy * scale_factor
        yy, xx = torch.meshgrid(torch.arange(oh), torch.arange(ow), indexing="ij")
        xy = (torch.stack([xx, yy], -1).float() / sxy).to(probs.device)
        s = (probs_s * rois_s).reshape(b, oh * ow, k)
        feats = torch.cat([xy.expand(b, oh, ow, 2), img_s / sigma_rgb], -1).reshape(b, oh * ow, -1)
        AS = permutohedral_filter(feats, s)  # one host thread per image
        loss = -weight * float((s.double() * AS.double()).sum()) / b
        # d/dprobs of -w/b * s^T K s with s = probs * roi: -2w/b * roi * (K s)
        d_probs = (-2.0 * weight / b) * rois_s.reshape(b, oh * ow, 1) * AS
    return loss, d_probs.reshape(b, oh, ow, k)
