"""H5 dataset reader honouring the reference directory schema.

The port's own copy of ``fedicra_tpu/data/h5io.py`` (numpy only; ``h5py`` is
imported where a split is read, so the rest runs without it).

Schema (SURVEY.md §2.5; the reference's dataloaders/dataset.py:63-183):
  {root}/Domain{1..K}/{train,test}/*.h5 with keys
    train: 'image' + one dataset per supervision type
           ('scribble','scribble_noisy','keypoint','block','box'[faz],'mask')
    test:  'image', 'mask'
  clientN maps to DomainN; 'client_all' is the union.

Images: FAZ float32 (256,256) in [0,1] (we add a channel axis); ODOC/Polyp
float32 (3,H,W) CHW (we transpose to HWC). Labels uint8 with value
``num_classes`` marking unlabeled pixels in sparse annotations.

Like the reference, a client's full split is loaded into host RAM once; the
batcher then keeps one copy of it on the device and augments there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

SUP_TYPES = ("scribble", "scribble_noisy", "keypoint", "block", "box", "mask")


@dataclass
class ClientSplit:
    images: np.ndarray  # [N, H, W, C] float32
    labels: np.ndarray  # [N, H, W] uint8 (train: sup_type; val: mask)
    case_names: List[str]

    def __len__(self) -> int:
        return self.images.shape[0]


def _to_hwc(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img[..., None].astype(np.float32)
    if img.ndim == 3:  # CHW -> HWC
        return np.transpose(img, (1, 2, 0)).astype(np.float32)
    raise ValueError(f"unexpected image shape {img.shape}")


def domain_dirs(root: str) -> List[str]:
    doms = sorted(
        d for d in os.listdir(root) if d.startswith("Domain") and
        os.path.isdir(os.path.join(root, d))
    )
    return doms


def client_to_domains(client: str, root: str) -> List[str]:
    """'clientN' -> ['DomainN']; 'client_all' -> all domains (dataset.py:98-171)."""
    doms = domain_dirs(root)
    if client == "client_all":
        return doms
    if client.startswith("client"):
        n = int(client[len("client"):])
        name = f"Domain{n}"
        if name not in doms:
            raise ValueError(f"{name} not found under {root}")
        return [name]
    raise ValueError(f"bad client key {client!r}")


def _split_cache_path(root, client, split, sup_type, limit) -> Optional[str]:
    """Decoded-split disk cache (a relaunch would otherwise decode every
    H5 file again). Keyed by a digest of the per-domain file listing (name, size,
    mtime), so any change to the source H5s misses. Default dir
    ~/.cache/fedicra_torch/datasets; FEDICRA_DATASET_CACHE_DIR= disables."""
    import hashlib

    d = os.environ.get("FEDICRA_DATASET_CACHE_DIR")
    if d is None:
        d = os.path.expanduser("~/.cache/fedicra_torch/datasets")
    if not d:
        return None
    h = hashlib.blake2b(digest_size=16)
    # decode-logic version: bump whenever label decoding (e.g. the
    # random_walker thresholding) changes, so warm caches can't silently
    # serve splits decoded by older logic
    h.update(b"decode-v1")
    subdir = "train" if split == "train" else "test"
    try:
        for dom in client_to_domains(client, root):
            ddir = os.path.join(root, dom, subdir)
            for fname in sorted(os.listdir(ddir)):
                if not fname.endswith(".h5"):
                    continue
                st = os.stat(os.path.join(ddir, fname))
                h.update(f"{dom}/{fname}:{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:
        return None
    tag = f"{client}_{split}_{sup_type}_{limit}_{h.hexdigest()}"
    return os.path.join(d, f"{tag}.npz")


def load_client_split(
    root: str,
    client: str,
    split: str,
    sup_type: str = "mask",
    limit: Optional[int] = None,
) -> ClientSplit:
    """Load one client's train or test split fully into memory."""
    import h5py

    cache = _split_cache_path(root, client, split, sup_type, limit)
    if cache:
        try:
            with np.load(cache, allow_pickle=False) as z:
                return ClientSplit(
                    images=z["images"], labels=z["labels"],
                    case_names=[str(s) for s in z["names"]],
                )
        except (OSError, KeyError, ValueError):
            pass

    subdir = "train" if split == "train" else "test"
    label_key = sup_type if split == "train" else "mask"
    random_walker = label_key == "random_walker"
    if random_walker:
        from .pseudo_label import pseudo_label_random_walker
    images, labels, names = [], [], []
    for dom in client_to_domains(client, root):
        ddir = os.path.join(root, dom, subdir)
        for fname in sorted(os.listdir(ddir)):
            if not fname.endswith(".h5"):
                continue
            with h5py.File(os.path.join(ddir, fname), "r") as f:
                raw_img = f["image"][:]
                images.append(_to_hwc(raw_img))
                if random_walker:
                    # dense pseudo-labels from the scribble seeds
                    # (dataset.py:90-93; the reference seeds from sup_type
                    # 'random_walker' which reads the scribble dataset)
                    seed_key = "scribble" if "scribble" in f else label_key
                    seed = np.asarray(f[seed_key][:])
                    img_class = "odoc" if seed.max() >= 3 else "faz"
                    labels.append(
                        pseudo_label_random_walker(
                            raw_img, seed, img_class=img_class
                        ).astype(np.uint8)
                    )
                else:
                    labels.append(np.asarray(f[label_key][:], dtype=np.uint8))
            names.append(f"{dom}/{subdir}/{fname}")
            if limit is not None and len(names) >= limit:
                break
        if limit is not None and len(names) >= limit:
            break
    out = ClientSplit(
        images=np.stack(images), labels=np.stack(labels), case_names=names
    )
    if cache:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez(tmp, images=out.images, labels=out.labels,
                     names=np.asarray(out.case_names))
            os.replace(tmp, cache)  # atomic vs concurrent writers
        except OSError:
            pass
    return out


def make_synthetic_split(
    num_samples: int,
    height: int,
    width: int,
    channels: int,
    num_classes: int,
    seed: int = 0,
    sparse: bool = True,
    sup_type: str = "scribble",
) -> ClientSplit:
    """Synthetic data generator (used for the Polyp federation, whose data is
    referenced by the reference launcher but not shipped, and for tests).

    `sup_type` shapes the partial annotation the way the reference's H5 label
    keys do (scribble / scribble_noisy / keypoint / box / block — the
    semantics live in the shipped data there, dataset.py:61-96, so the exact
    pixel patterns here are our own reasonable stand-ins):

    - scribble: ~30 labeled pixels per class, rest ignore (num_classes)
    - scribble_noisy: scribble with ~10% of labeled pixels flipped
    - keypoint: 3 labeled pixels per class
    - box: background labeled OUTSIDE the foreground bounding box; the box
      interior is ignore (the classic bbox weak label)
    - block: one image quadrant fully labeled, the rest ignore

    `sparse=False` returns the dense ground-truth mask (val splits)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, size=(num_samples, height, width, channels)).astype(
        np.float32
    )
    labels = np.full((num_samples, height, width), num_classes, dtype=np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(num_samples):
        cy, cx = rng.integers(height // 4, 3 * height // 4), rng.integers(
            width // 4, 3 * width // 4
        )
        r = rng.integers(min(height, width) // 8, min(height, width) // 4)
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        imgs[i, ..., 0] = np.where(disk, imgs[i, ..., 0] * 0.5 + 0.5, imgs[i, ..., 0])
        if not sparse:
            labels[i] = np.where(disk, 1, 0).astype(np.uint8)
            continue
        lab = labels[i]
        fg = np.argwhere(disk)
        bg = np.argwhere(~disk)
        if sup_type in ("scribble", "scribble_noisy", "keypoint"):
            n_px = 3 if sup_type == "keypoint" else 30
            for cls, pool in ((1, fg), (0, bg)):
                take = pool[
                    rng.choice(len(pool), size=min(n_px, len(pool)), replace=False)
                ]
                lab[take[:, 0], take[:, 1]] = cls if num_classes > 1 else 0
            if sup_type == "scribble_noisy" and num_classes > 1:
                labeled = np.argwhere(lab != num_classes)
                flip = labeled[
                    rng.choice(len(labeled), size=max(len(labeled) // 10, 1),
                               replace=False)
                ]
                lab[flip[:, 0], flip[:, 1]] = (
                    1 - lab[flip[:, 0], flip[:, 1]]
                ).astype(np.uint8)
        elif sup_type == "box":
            y0, y1 = fg[:, 0].min(), fg[:, 0].max()
            x0, x1 = fg[:, 1].min(), fg[:, 1].max()
            box = np.zeros((height, width), dtype=bool)
            box[y0:y1 + 1, x0:x1 + 1] = True
            lab[~box] = 0
        elif sup_type == "block":
            qy, qx = rng.integers(0, 2), rng.integers(0, 2)
            sl = (slice(qy * height // 2, (qy + 1) * height // 2),
                  slice(qx * width // 2, (qx + 1) * width // 2))
            lab[sl] = np.where(disk, 1, 0).astype(np.uint8)[sl]
        else:
            raise ValueError(f"unknown synthetic sup_type {sup_type!r}")
    return ClientSplit(
        images=imgs,
        labels=labels,
        case_names=[f"synthetic/{i:04d}.h5" for i in range(num_samples)],
    )
