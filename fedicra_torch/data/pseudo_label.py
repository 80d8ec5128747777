"""Random-walker pseudo-label generation from sparse seeds.

The port's own copy of ``fedicra_tpu/data/pseudo_label.py`` (numpy and scipy).

Reference: pseudo_label_generator_acdc (dataloaders/dataset.py:16-60) — when
``sup_type == 'random_walker'`` the sparse seed annotation is expanded into a
dense pseudo-label with skimage's random walker (beta=50, 'bf' mode) after a
rescale_intensity to (-1, 1) over the (-0.35, 1.35) input window. Marker
mapping: the unlabeled value (num_classes) becomes 0 (unknown); labels
shift up by one; output shifts back down.

This is a host-side preprocessing step (runs once at dataset load); a
skimage-free fallback solves the same anchored graph Laplacian system with
scipy sparse solvers (the random walker *is* a Dirichlet problem — Grady
2006), so behaviour is equivalent up to solver tolerance.
"""

from __future__ import annotations

import numpy as np


def _rescale_intensity(data: np.ndarray, in_range=(-0.35, 1.35)) -> np.ndarray:
    lo, hi = in_range
    x = np.clip((data.astype(np.float64) - lo) / (hi - lo), 0, 1)
    return x * 2.0 - 1.0


def _random_walker_scipy(data: np.ndarray, markers: np.ndarray, beta: float):
    """Grady random walker via the anchored Laplacian (scipy sparse)."""
    from scipy import sparse
    from scipy.sparse.linalg import spsolve

    if data.ndim == 3:  # (C,H,W) -> mean over channels for edge weights
        img = data.mean(axis=0)
    else:
        img = data
    h, w = img.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)

    def edges(a, b):
        d = (img.reshape(-1)[a] - img.reshape(-1)[b]) ** 2
        wgt = np.exp(-beta * d / max(img.std() ** 2, 1e-10))
        return wgt + 1e-6

    ev = (idx[:-1, :].ravel(), idx[1:, :].ravel())
    eh = (idx[:, :-1].ravel(), idx[:, 1:].ravel())
    eu = np.concatenate([ev[0], eh[0]])
    evv = np.concatenate([ev[1], eh[1]])
    wgt = edges(eu, evv)

    W = sparse.coo_matrix((np.concatenate([wgt, wgt]),
                           (np.concatenate([eu, evv]),
                            np.concatenate([evv, eu]))), shape=(n, n)).tocsr()
    L = sparse.diags(np.asarray(W.sum(axis=1)).ravel()) - W

    m = markers.reshape(-1)
    labels = np.unique(m[m > 0])
    seeded = m > 0
    unseeded = ~seeded
    B = L[unseeded][:, seeded]
    Lu = L[unseeded][:, unseeded]

    probs = np.zeros((n, len(labels)))
    for li, lab in enumerate(labels):
        xb = (m[seeded] == lab).astype(np.float64)
        probs[unseeded, li] = spsolve(Lu.tocsc(), -B @ xb)
        probs[seeded, li] = xb
    out = labels[np.argmax(probs, axis=1)]
    return out.reshape(h, w)


def pseudo_label_random_walker(
    data: np.ndarray,
    seed: np.ndarray,
    beta: float = 50.0,
    img_class: str = "odoc",
) -> np.ndarray:
    """dataset.py:16-60 parity: seed -> markers -> random walker -> label."""
    num_fg = 2 if img_class == "odoc" else 1
    present = all(c in np.unique(seed) for c in range(1, num_fg + 1))
    if not present:
        return np.zeros_like(seed)

    unlabeled_val = num_fg + 1  # 3 for odoc, 2 for faz/polyp
    markers = np.ones_like(seed)
    markers[seed == unlabeled_val] = 0
    for c in range(num_fg + 1):
        markers[seed == c] = c + 1

    data_r = _rescale_intensity(np.asarray(data))
    try:
        from skimage.segmentation import random_walker

        kwargs = {"mode": "bf"}
        if data_r.ndim == 3:
            kwargs["channel_axis"] = 0
        seg = random_walker(data_r, markers, beta, **kwargs)
    except ImportError:
        seg = _random_walker_scipy(data_r, markers, beta)
    return (seg - 1).astype(seed.dtype)
