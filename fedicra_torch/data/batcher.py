"""Epoch-cached batch sampling with on-device augmentation.

Counterpart of ``fedicra_tpu/data/batcher.py``. Reproduces the reference's
sampling discipline (…_Ours.py:71-79 + torch DataLoader(shuffle=True)): an
epoch's batches are materialised once, each sample augmented once per epoch,
and replayed by ``global_iter % num_batches`` until the next epoch boundary
regenerates them (PARITY #9).

The tail batch is padded by wrapping to the start of the epoch's permutation,
as in the JAX version (the reference's DataLoader keeps a smaller last batch);
with N % batch_size == 0 the two agree.

The permutation and the augmentation draws come from CPU ``torch.Generator``s
seeded from (seed, epoch), so an epoch is a pure function of them and is the
same on every device. They are not JAX's threefry streams: across the two
packages an epoch agrees only in distribution.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..device import resolve_device
from .augment import augment_batch, image_cval_for
from .h5io import ClientSplit


def _epoch_generator(seed: int, epoch: int, stream: int) -> torch.Generator:
    """One of an epoch's two generators (0: permutation, 1: augmentation)."""
    return torch.Generator().manual_seed(((seed * 1_000_003 + epoch) * 2 + stream) % 2**63)


def materialize_epoch(
    images: torch.Tensor,
    labels: torch.Tensor,
    seed: int,
    epoch: int,
    batch_size: int,
    num_classes: int,
    img_class: str,
    augment: bool = True,
):
    """One epoch of a split's device arrays: the permutation of (seed, epoch),
    wrap-padded to whole batches, gathered and augmented. Returns
    ([nb, B, H, W, C], [nb, B, H, W])."""
    n = images.shape[0]
    nb = math.ceil(n / batch_size)
    perm = torch.randperm(n, generator=_epoch_generator(seed, epoch, 0))
    pad = nb * batch_size - n
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    perm = perm.to(images.device)
    images = images[perm]
    labels = labels[perm].long()
    if augment:
        images, labels = augment_batch(
            _epoch_generator(seed, epoch, 1),
            images,
            labels,
            num_classes=num_classes,
            image_cval=image_cval_for(img_class),
        )
    return (images.reshape(nb, batch_size, *images.shape[1:]),
            labels.reshape(nb, batch_size, *labels.shape[1:]))


class EpochBatcher:
    def __init__(
        self,
        split: ClientSplit,
        batch_size: int,
        num_classes: int,
        img_class: str,
        seed: int = 2022,
        augment: bool = True,
        source: Optional["EpochBatcher"] = None,
        device=None,
    ):
        self.split = split
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.img_class = img_class
        self.augment = augment
        self.seed = seed
        self.n = len(split)
        self.num_batches = math.ceil(self.n / batch_size)
        self._epoch_cache: Optional[int] = None
        self._epoch_images = None
        self._epoch_labels = None
        if source is not None:
            # share the device copy of another batcher over the same split
            # (the ALA stream): the device holds ONE copy
            self.device = source.device
            self._images_dev = source._images_dev
            self._labels_dev = source._labels_dev
        else:
            self.device = resolve_device(device)
            self._images_dev = torch.as_tensor(split.images, device=self.device)
            self._labels_dev = torch.as_tensor(split.labels, device=self.device)

    def drop_epoch_cache(self) -> None:
        """Free the epoch's device arrays. Safe anytime: an epoch is a pure
        function of (seed, epoch), so a rebuild gives the same batches."""
        self._epoch_cache = None
        self._epoch_images = None
        self._epoch_labels = None

    def _materialize_epoch(self, epoch: int):
        self._epoch_images, self._epoch_labels = materialize_epoch(
            self._images_dev, self._labels_dev, self.seed, epoch, self.batch_size,
            self.num_classes, self.img_class, augment=self.augment,
        )
        self._epoch_cache = epoch

    def batch_at(self, global_iter: int) -> Dict[str, torch.Tensor]:
        """Batch for a global iteration index (reference replay semantics)."""
        epoch = global_iter // self.num_batches
        idx = global_iter % self.num_batches
        if self._epoch_cache != epoch:
            self._materialize_epoch(epoch)
        return {"image": self._epoch_images[idx], "label": self._epoch_labels[idx]}

    def batches_for_round(self, start_iter: int, iters: int) -> Dict[str, torch.Tensor]:
        """Stacked batches [iters, B, ...] for one local round."""
        bs = [self.batch_at(start_iter + i) for i in range(iters)]
        return {
            "image": torch.stack([b["image"] for b in bs]),
            "label": torch.stack([b["label"] for b in bs]),
        }

    def epoch_arrays(self, epoch: int):
        """All batches of one epoch: ([nb, B, H, W, C], [nb, B, H, W])."""
        if self._epoch_cache != epoch:
            self._materialize_epoch(epoch)
        return self._epoch_images, self._epoch_labels
