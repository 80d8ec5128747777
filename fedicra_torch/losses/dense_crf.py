"""DenseCRF loss (Tang et al. regularized-loss form), exact.

Counterpart of ``fedicra_tpu/losses/dense_crf.py::dense_crf_loss``; NHWC::

    L = -(weight / B) * sum_b sum_i sum_j k(f_i, f_j) s_i s_j,  s = probs * ROI,
    k = exp(-||dxy||^2 / (2 sxy^2) - ||drgb||^2 / (2 srgb^2))

with the inputs downscaled by ``scale_factor`` (images and ROIs nearest,
probabilities linear with antialiasing, as ``jax.image.resize`` does) and
sigma_xy scaled with them. The filter is the exact Gaussian kernel filter
of ``ops/gaussian_filter_cuda.py``: its CUDA kernel on the card, its plain
twin on the CPU. The gradient to the probabilities follows by autograd
(the filter is linear and its kernel symmetric). The reference's host
permutohedral-lattice variant is not ported.
"""

from __future__ import annotations

import torch

from ..ops.gaussian_filter_cuda import bilateral_features, gaussian_kernel_filter
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
