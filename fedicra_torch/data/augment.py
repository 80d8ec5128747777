"""Batched on-device augmentation with explicit random draws.

Counterpart of ``fedicra_tpu/data/augment.py``, reproducing the reference
RandomGenerator (dataset.py:186-251):

- with p=0.5: rot90 (k in 0..3), then a flip over H or W;
- with p=0.5: a rotation by an integer angle in [-45, 45), nearest
  neighbour, about the centre (n-1)/2, constant fill: label fill
  ``num_classes``, image fill 0.8 for FAZ and 0.0 otherwise.

The draws (do1, k, axis, do2, angle per sample) are made apart from their
application, so the same draws can be applied in either package. Both steps
are gathers of the whole batch through per-sample source coordinates. Like
the JAX version, the rot90 step needs square images.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class AugmentDraws(NamedTuple):
    """Per-sample draws, each of shape [N]."""

    do1: torch.Tensor  # bool: rot90 + flip
    k: torch.Tensor  # int: quarter turns, 0..3
    axis: torch.Tensor  # int: flip axis, 0 (H) or 1 (W)
    do2: torch.Tensor  # bool: free rotation
    angle: torch.Tensor  # int: degrees in [-45, 45)


def draw_augment(n: int, generator: Optional[torch.Generator] = None) -> AugmentDraws:
    """The draws for ``n`` samples, from ``generator`` (on the CPU)."""
    u = torch.rand(2, n, generator=generator)
    return AugmentDraws(
        do1=u[0] > 0.5,
        k=torch.randint(0, 4, (n,), generator=generator),
        axis=torch.randint(0, 2, (n,), generator=generator),
        do2=u[1] > 0.5,
        angle=torch.randint(-45, 45, (n,), generator=generator),
    )


def _gather(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """out[i, y, x] = x[i, sy[i, y, x], sx[i, y, x]] for [N, H, W, ...] x."""
    n, h, w = x.shape[:3]
    idx = (sy * w + sx).reshape(n, h * w)
    flat = x.reshape(n, h * w, -1)
    out = flat.gather(1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(x.shape)


def _rot_flip_coords(draws: AugmentDraws, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates of rot90(k) then flip(axis), identity where not do1."""
    ys = torch.arange(n, device=device)
    y, x = ys[None, :, None], ys[None, None, :]
    k = draws.k.to(device)[:, None, None]
    axis = draws.axis.to(device)[:, None, None]
    # the flip reads the rotated image at (a, b) ...
    a = torch.where(axis == 0, n - 1 - y, y)
    b = torch.where(axis == 0, x, n - 1 - x)
    # ... which rot90 by k (counter-clockwise, as np.rot90) reads at (sy, sx)
    sy = torch.where(k == 0, a, torch.where(k == 1, b, torch.where(k == 2, n - 1 - a, n - 1 - b)))
    sx = torch.where(k == 0, b, torch.where(k == 1, n - 1 - a, torch.where(k == 2, n - 1 - b, a)))
    do = draws.do1.to(device)[:, None, None]
    return torch.where(do, sy, y.expand_as(sy)), torch.where(do, sx, x.expand_as(sx))


def _rotate_coords(angle: torch.Tensor, h: int, w: int, device):
    """Rounded source coordinates of a rotation about ((h-1)/2, (w-1)/2) and
    whether they fall inside, in float32 as the JAX version computes them
    (scipy.ndimage.rotate(order=0, reshape=False) semantics)."""
    theta = -angle.to(device=device, dtype=torch.float32) * (math.pi / 180.0)  # inverse map
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :] - cx
    iy = torch.round(cos * yy - sin * xx + cy).to(torch.int64)
    ix = torch.round(sin * yy + cos * xx + cx).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return iy.clamp(0, h - 1), ix.clamp(0, w - 1), valid


def apply_augment(
    images: torch.Tensor,
    labels: torch.Tensor,
    draws: AugmentDraws,
    *,
    num_classes: int,
    image_cval: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``draws`` to [N, H, W, C] images and [N, H, W] labels (int64 out)."""
    n, h, w = images.shape[:3]
    labels = labels.long()
    if draws.do1.any():
        if h != w:
            raise ValueError(f"rot90 needs square images, got {h}x{w}")
        sy, sx = _rot_flip_coords(draws, h, images.device)
        images, labels = _gather(images, sy, sx), _gather(labels, sy, sx)
    if draws.do2.any():
        iy, ix, valid = _rotate_coords(draws.angle, h, w, images.device)
        valid = valid | ~draws.do2.to(images.device)[:, None, None]
        ident_y = torch.arange(h, device=images.device)[None, :, None].expand(n, h, w)
        ident_x = torch.arange(w, device=images.device)[None, None, :].expand(n, h, w)
        do = draws.do2.to(images.device)[:, None, None]
        iy, ix = torch.where(do, iy, ident_y), torch.where(do, ix, ident_x)
        images = torch.where(valid[..., None], _gather(images, iy, ix),
                             images.new_tensor(image_cval))
        labels = torch.where(valid, _gather(labels, iy, ix), labels.new_tensor(num_classes))
    return images, labels


def augment_batch(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    labels: torch.Tensor,
    *,
    num_classes: int,
    image_cval: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment [N, H, W, C] images and [N, H, W] labels, one draw per sample."""
    draws = draw_augment(images.shape[0], generator)
    return apply_augment(images, labels, draws, num_classes=num_classes, image_cval=image_cval)


def augment_sample(
    generator: Optional[torch.Generator],
    image: torch.Tensor,
    label: torch.Tensor,
    *,
    num_classes: int,
    image_cval: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment one (H, W, C) image and (H, W) label."""
    img, lab = augment_batch(generator, image[None], label[None],
                             num_classes=num_classes, image_cval=image_cval)
    return img[0], lab[0]


def image_cval_for(img_class: str) -> float:
    """FAZ rotations fill the image with 0.8 (dataset.py:208), others 0."""
    return 0.8 if img_class == "faz" else 0.0
