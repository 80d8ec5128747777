"""The port's data layer against fedicra_tpu's (CPU): synthetic splits,
augmentation on replayed draws, and the epoch batcher's replay."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedicra_torch.data import EpochBatcher, augment_sample, make_synthetic_split
from fedicra_torch.data.augment import AugmentDraws, apply_augment, augment_batch, draw_augment
from fedicra_tpu.data import augment_batch as jax_augment_batch
from fedicra_tpu.data import make_synthetic_split as jax_make_synthetic_split
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize(
    "sup_type,sparse",
    [("scribble", True), ("scribble_noisy", True), ("keypoint", True), ("box", True),
     ("block", True), ("scribble", False)],
)
def test_synthetic_split_is_bit_identical(sup_type, sparse):
    args = (5, 24, 20, 3, 3)
    got = make_synthetic_split(*args, seed=7, sparse=sparse, sup_type=sup_type)
    want = jax_make_synthetic_split(*args, seed=7, sparse=sparse, sup_type=sup_type)
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.case_names == want.case_names and len(got) == 5


def _jax_draws(key, n):
    """The draws jax_augment_batch makes from ``key`` for ``n`` samples,
    replayed with jax.random as fedicra_tpu/data/augment.py takes them."""
    rows = []
    for k in jax.random.split(key, n):
        k_do1, k_rot, k_flip, k_do2, k_ang = jax.random.split(k, 5)
        rows.append((
            bool(jax.random.uniform(k_do1) > 0.5),
            int(jax.random.randint(k_rot, (), 0, 4)),
            int(jax.random.randint(k_flip, (), 0, 2)),
            bool(jax.random.uniform(k_do2) > 0.5),
            int(jax.random.randint(k_ang, (), -45, 45)),
        ))
    cols = list(zip(*rows))
    return AugmentDraws(
        do1=torch.tensor(cols[0]), k=torch.tensor(cols[1]), axis=torch.tensor(cols[2]),
        do2=torch.tensor(cols[3]), angle=torch.tensor(cols[4]),
    )


@pytest.mark.parametrize("channels,cval,size", [(3, 0.0, 32), (1, 0.8, 31)])
def test_augment_matches_jax_on_its_draws(channels, cval, size):
    n = 24
    rng = np.random.default_rng(channels)
    images = rng.uniform(size=(n, size, size, channels)).astype(np.float32)
    labels = rng.integers(0, 3, size=(n, size, size)).astype(np.uint8)  # 3 only as fill
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, n)
    # every branch is taken: no-op, rot/flip only, rotation only, both
    both = draws.do1 & draws.do2
    assert both.any() and (draws.do1 & ~draws.do2).any() and (~draws.do1 & draws.do2).any()
    assert set(draws.k.tolist()) == {0, 1, 2, 3} and set(draws.axis.tolist()) == {0, 1}

    want_img, want_lab = jax_augment_batch(
        key, jnp.asarray(images), jnp.asarray(labels), num_classes=3, image_cval=cval
    )
    got_img, got_lab = apply_augment(
        torch.as_tensor(images), torch.as_tensor(labels), draws, num_classes=3, image_cval=cval
    )
    # labels exactly; images within 1e-6 (they are moved, never computed)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    filled = got_lab == 3
    assert filled.any()  # the rotation's fill reached the output
    assert torch.all(got_img[filled] == cval)


def test_augment_draws_are_seeded_and_batch_equals_samples():
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(size=(6, 16, 16, 3)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, 3, size=(6, 16, 16)))
    a = augment_batch(torch.Generator().manual_seed(5), images, labels, num_classes=3)
    b = augment_batch(torch.Generator().manual_seed(5), images, labels, num_classes=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    draws = draw_augment(6, torch.Generator().manual_seed(5))
    assert draws.k.min() >= 0 and draws.k.max() <= 3 and draws.angle.min() >= -45
    assert draws.angle.max() < 45
    g = torch.Generator().manual_seed(3)
    img1, lab1 = augment_sample(g, images[0], labels[0], num_classes=3)
    img2, lab2 = apply_augment(images[:1], labels[:1], draw_augment(1, torch.Generator().manual_seed(3)),
                               num_classes=3)
    assert torch.equal(img1, img2[0]) and torch.equal(lab1, lab2[0])


def _split(n=5, size=12):
    return make_synthetic_split(n, size, size, 3, 3, seed=1, sparse=True)


def test_batcher_replays_an_epoch_and_wraps_the_tail():
    split = _split()
    b = EpochBatcher(split, 2, 3, "odoc", seed=4, augment=False, device="cpu")
    assert b.num_batches == 3
    imgs, labs = b.epoch_arrays(0)
    assert imgs.shape == (3, 2, 12, 12, 3) and labs.shape == (3, 2, 12, 12)
    # one epoch is a permutation of the split, the tail padded by wrapping
    order = [int(np.argmax([np.array_equal(x, y) for y in split.images]))
             for x in imgs.reshape(6, 12, 12, 3).numpy()]
    assert sorted(order[:5]) == list(range(5)) and order[5] == order[0]
    # replay: global iteration i reads batch i % nb of its epoch
    for i in range(3):
        assert torch.equal(b.batch_at(i)["image"], imgs[i])
    r = b.batches_for_round(1, 4)  # iterations 1, 2 (epoch 0) and 3, 4 (epoch 1)
    assert r["image"].shape == (4, 2, 12, 12, 3)
    assert torch.equal(r["image"][0], imgs[1]) and torch.equal(r["image"][1], imgs[2])
    nxt, _ = b.epoch_arrays(1)
    assert torch.equal(r["image"][2], nxt[0]) and not torch.equal(nxt, imgs)


def test_batcher_rebuilds_the_same_epoch_and_shares_its_source():
    split = _split(n=6)
    b = EpochBatcher(split, 3, 3, "odoc", seed=9, device="cpu")
    imgs, labs = (t.clone() for t in b.epoch_arrays(2))
    b.drop_epoch_cache()
    assert b._epoch_images is None
    again = b.epoch_arrays(2)
    assert torch.equal(again[0], imgs) and torch.equal(again[1], labs)
    # augmentation moved pixels: some sample is not a plain copy
    plain = EpochBatcher(split, 3, 3, "odoc", seed=9, augment=False, device="cpu").epoch_arrays(2)[0]
    assert not torch.equal(plain, imgs)
    ala = EpochBatcher(split, 3, 3, "odoc", seed=509, source=b)
    assert ala._images_dev.data_ptr() == b._images_dev.data_ptr() and ala.device == b.device
    assert not torch.equal(ala.epoch_arrays(2)[0], imgs)


def _h5_root(tmp_path):
    """One domain with 3 train cases (CHW images, scribbles with both
    foreground classes) and 2 test cases (HW images, masks)."""
    import h5py

    rng = np.random.default_rng(3)
    root = tmp_path / "root"
    for sub, n in (("train", 3), ("test", 2)):
        (root / "Domain1" / sub).mkdir(parents=True)
        for i in range(n):
            with h5py.File(root / "Domain1" / sub / f"case{i}.h5", "w") as f:
                shape = (3, 12, 12) if sub == "train" else (12, 12)
                f["image"] = rng.random(shape).astype("float32")
                scribble = np.full((12, 12), 3, np.uint8)
                scribble[2, 2:9], scribble[6, 3:8], scribble[10, 1:11] = 1, 2, 0
                f["scribble"] = scribble
                f["mask"] = rng.integers(0, 3, size=(12, 12)).astype("uint8")
    return str(root)


@pytest.mark.parametrize("split,sup_type", [("train", "scribble"), ("train", "random_walker"),
                                            ("val", "mask")])
def test_load_client_split_matches_jax(tmp_path, monkeypatch, split, sup_type):
    from fedicra_torch.data import load_client_split
    from fedicra_tpu.data.h5io import load_client_split as jax_load_client_split

    root = _h5_root(tmp_path)
    monkeypatch.setenv("FEDICRA_DATASET_CACHE_DIR", "")  # no cache: both decode
    got = load_client_split(root, "client1", split, sup_type, limit=None)
    want = jax_load_client_split(root, "client1", split, sup_type, limit=None)
    assert got.images.dtype == np.float32 and got.labels.dtype == np.uint8
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.case_names == want.case_names and len(got) == (3 if split == "train" else 2)
    if sup_type == "random_walker":  # dense labels from the scribble seeds
        assert set(np.unique(got.labels)) == {0, 1, 2}


def test_load_client_split_cache_round_trip(tmp_path, monkeypatch):
    from fedicra_torch.data import load_client_split

    root = _h5_root(tmp_path)
    cache = tmp_path / "cache"
    monkeypatch.setenv("FEDICRA_DATASET_CACHE_DIR", str(cache))
    a = load_client_split(root, "client1", "train", "scribble", limit=2)
    assert len(list(cache.glob("*.npz"))) == 1 and len(a) == 2
    b = load_client_split(root, "client1", "train", "scribble", limit=2)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.case_names == b.case_names
    with pytest.raises(ValueError, match="Domain7"):
        load_client_split(root, "client7", "train", "scribble")
