"""The port's evaluation against fedicra_tpu's and scipy's (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from fedicra_torch.evaluation import evaluate_client, metrics_batch, metrics_percase, surface_distances
from fedicra_torch.evaluation.evaluate import predict_labels
from fedicra_tpu.evaluation import evaluate_client as jax_evaluate_client
from fedicra_tpu.evaluation import metrics_percase as jax_metrics_percase
from torch_port_helpers import models, one_torch_thread  # noqa: F401 (autouse fixture)

OVERLAP = [0, 2, 3, 4, 5, 6]  # dice, recall, precision, jc, specificity, ravd
HD95 = 1


def _disc(h, w, cy, cx, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 < r * r


def _blobs(seed, h=40, w=36):
    rng = np.random.default_rng(seed)
    a = _disc(h, w, rng.integers(8, 30), rng.integers(8, 28), rng.integers(4, 10))
    b = _disc(h, w, rng.integers(8, 30), rng.integers(8, 28), rng.integers(4, 10))
    b |= rng.uniform(size=(h, w)) < 0.03  # speckle: scattered boundary pixels
    return a, b


def _cases():
    h, w = 40, 36
    one_px = np.zeros((h, w), bool)
    one_px[17, 5] = True
    border = np.zeros((h, w), bool)
    border[:9, 20:] = True  # touches the top and right edges
    empty = np.zeros((h, w), bool)
    disc = _disc(h, w, 20, 18, 9)
    return {
        **{f"blobs{s}": _blobs(s) for s in range(4)},
        "one_pixel": (one_px, disc),
        "one_pixel_truth": (disc, one_px),
        "border": (border, disc),
        "empty_prediction": (empty, disc),
        "empty_truth": (disc, empty),
        "identical": (disc, disc),
    }


CASES = _cases()


def _medpy_oracle(pred, gt):
    """medpy.metric.binary hd95/asd/assd with scipy's exact EDT."""
    foot = ndimage.generate_binary_structure(2, 1)

    def border(m):
        return m & ~ndimage.binary_erosion(m, structure=foot, iterations=1)

    pb, gb = border(pred), border(gt)
    d_ab = ndimage.distance_transform_edt(~gb)[pb]
    d_ba = ndimage.distance_transform_edt(~pb)[gb]
    both = np.hstack([d_ab, d_ba])
    return {"hd95": np.percentile(both, 95), "asd": d_ab.mean(), "assd": both.mean()}


@pytest.mark.parametrize("name", list(CASES))
def test_metrics_percase_matches_jax(name):
    pred, gt = CASES[name]
    got = metrics_percase(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    want = np.asarray(jax_metrics_percase(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(got[OVERLAP], want[OVERLAP], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[HD95], want[HD95], rtol=1e-5, atol=0)  # NaN == NaN
    if name == "empty_prediction":
        assert not got.any()
    if name == "empty_truth":  # no truth boundary: numpy's percentile of infs
        assert np.isnan(got[HD95])


@pytest.mark.parametrize("name", [n for n in CASES if "empty" not in n])
def test_surface_distances_match_scipy_and_jax(name):
    from fedicra_tpu.evaluation import surface_distances as jax_surface_distances

    pred, gt = CASES[name]
    got = {k: float(v) for k, v in surface_distances(torch.as_tensor(pred), torch.as_tensor(gt)).items()}
    want = {k: float(v) for k, v in jax_surface_distances(jnp.asarray(pred), jnp.asarray(gt)).items()}
    oracle = _medpy_oracle(pred, gt)
    for k in ("hd95", "asd", "assd"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
        np.testing.assert_allclose(got[k], oracle[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_surface_distances_to_an_empty_mask_are_inf():
    pred, gt = CASES["empty_truth"]
    sd = surface_distances(torch.as_tensor(pred), torch.as_tensor(gt))
    assert torch.isinf(sd["asd"]) and torch.isinf(sd["assd"])


def test_batched_metrics_equal_per_case():
    names = list(CASES)
    preds = torch.as_tensor(np.stack([CASES[n][0] for n in names]))
    gts = torch.as_tensor(np.stack([CASES[n][1] for n in names]))
    batched = metrics_percase(preds, gts)
    for i in range(len(names)):
        torch.testing.assert_close(batched[i], metrics_percase(preds[i], gts[i]), equal_nan=True,
                                   rtol=0, atol=0)
    # class 1 exact match, classes >= 2 the union (PARITY #12)
    lab_p, lab_g = preds.long() * 2, gts.long()
    m = metrics_batch(lab_p, lab_g, 3)
    assert m.shape == (len(names), 2, 7)
    torch.testing.assert_close(m[:, 0], metrics_percase(lab_p == 1, lab_g == 1), equal_nan=True)
    torch.testing.assert_close(m[:, 1], metrics_percase(lab_p >= 1, lab_g >= 1), equal_nan=True)


def _val_set(n=5, size=32, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    labels = np.stack([
        np.where(_disc(size, size, *rng.integers(8, 24, 2), 10), 1, 0)
        + _disc(size, size, 16, 16, 5) for _ in range(n)
    ]).astype(np.uint8)
    return images, np.minimum(labels, 2)


def test_evaluate_client_matches_jax_without_padding():
    """N = 5 with an eval batch of 2: JAX pads its tail batch, the port runs
    it as it is, and the means agree."""
    jm, v, pm = models(client_id=0)
    images, labels = _val_set()
    want = jax_evaluate_client(jm, v["params"], v["batch_stats"], images, labels, 3,
                               emb_idx=1, batch=2)
    sd = pm.state_dict()
    names = {n for n, _ in pm.named_parameters()}
    params = {k: t for k, t in sd.items() if k in names}
    stats = {k: t for k, t in sd.items() if k not in names}
    got = evaluate_client(pm, params, stats, images, labels, 3, emb_idx=1, batch=2, device="cpu")
    assert got.keys() == want.keys() and len(got) == 3 * 7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["mean_dice"] > 0  # the predictions overlap the truth
    whole = evaluate_client(pm, params, stats, images, labels, 3, emb_idx=1, batch=8, device="cpu")
    assert whole == pytest.approx(got, rel=1e-6, nan_ok=True)


def test_predict_labels_leaves_the_model_alone():
    _, _, pm = models()
    pm.train()
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    sd = pm.state_dict()
    names = {n for n, _ in pm.named_parameters()}
    params = {k: t + 0.01 for k, t in sd.items() if k in names}
    stats = {k: t.clone() for k, t in sd.items() if k not in names}
    images = torch.as_tensor(_val_set(n=2)[0])
    pred = predict_labels(pm, params, stats, images)
    assert pred.shape == (2, 32, 32) and pm.training
    for k, t in pm.state_dict().items():
        assert torch.equal(t, before[k]), k
    for k, t in stats.items():
        assert torch.equal(t, before[k]), k  # eval mode: running stats untouched
