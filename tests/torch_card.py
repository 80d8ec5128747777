"""What the port's card tests share: the card fixture, the inputs they draw
and the kernels' launch counters.

This module imports no JAX, so it runs on a machine with a card and no JAX
stack. Its name does not start with ``test_``: pytest collects nothing from
it. A test module takes the fixture by importing it::

    from torch_card import cuda_device  # noqa: F401
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

BATCH = 12  # every task's batch on the main path
IMG = 384  # ODOC's side: the headline configuration's
TREE_SIGMA = 0.02  # the tree term's sigma (``multi_scale_tree_energy_loss``'s default)
# mst_tile_kernel<32>'s register file a thread: the launch bound (two 1,024-thread
# blocks an SM) caps it at 32 registers, and ptxas spills 32 bytes to local
# memory; that build ran faster than a 44-register one without the cap (PERF.md
# section 6). A build that needs more fails its test.
MST_TILE_REGISTERS, MST_TILE_LOCAL_BYTES = 32, 32
# the DSN heads' inputs, (channels, side) at batch 12: ODOC's three at 384^2, FAZ's at 256^2
DSN_HEAD_SHAPES = {"odoc": ((64, 96), (32, 192), (16, 384)), "faz": ((64, 64), (32, 128), (16, 256))}
DSN_HIDDEN = 512


def full_fp32() -> None:
    """No TF32 in cuDNN's convolutions or in matmuls: the card computes in full
    fp32, as the plain twins and the CPU it is held to do."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="session")
def cuda_device():
    """The card, in full fp32 for the whole process (``full_fp32``), for
    tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode, and its card "
                    "route (channels-last, CUDA events) runs only there")
    full_fp32()
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def free_the_card():
    """What a test leaves in the caching allocator goes back to the card (a
    module takes it by importing it)."""
    yield
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---- inputs ----------------------------------------------------------------


def smooth_images(rng, b: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    """(b, h, w, channels) images in [0, 1] that vary slowly, dark at the
    top-left (3 channels: ODOC's and Polyp's rgb; 1: FAZ's gray).

    The gated CRF's guide is rgb/0.1, so on per-pixel noise nearly every
    neighbour weight k_o is ~0. Slow waves keep k_o spread over (0, 1), and
    the dark corner keeps the zero-padded border terms there from vanishing.
    """
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    freq = rng.uniform(1.0, 3.0, size=(b, 1, 1, channels, 2))
    phase = rng.uniform(0.0, 2 * np.pi, size=(b, 1, 1, channels))
    wave = np.sin(2 * np.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    img = u * v * (0.6 + 0.3 * wave) + 0.005 * rng.normal(size=(b, h, w, channels))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def confident_logits(rng, b: int, c: int, h: int, w: int) -> np.ndarray:
    """(b, c, h, w) logits, 20x a one-hot map of smooth class regions (the
    argmax of slow waves) plus a little noise: their softmax is near one-hot
    with sharp borders, where K(q) and <y(q), acc(q)> are close and large and
    their difference is what the loss keeps."""
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w)[None, :]
    freq = rng.uniform(1.0, 2.0, size=(b, c, 1, 1, 2))
    phase = rng.uniform(0.0, 2 * np.pi, size=(b, c, 1, 1))
    waves = np.sin(2 * np.pi * (freq[..., 0] * u + freq[..., 1] * v) + phase)
    regions = np.moveaxis(np.eye(c)[waves.argmax(axis=1)], -1, 1)
    return (20.0 * (regions + 0.05 * rng.normal(size=(b, c, h, w)))).astype(np.float32)


def serpentine_weights(h: int, w: int) -> np.ndarray:
    """MST weights [E] whose tree is one path from vertex 0 through every row
    in turn (left to right, then right to left): V levels of one vertex."""
    from fedicra_torch.ops.mst import grid_edges

    eu, ev = grid_edges(h, w)
    i, j = eu // w, eu % w
    horizontal = ev == eu + 1
    # the vertical edge at the end of each row: the right end below even rows, the left below odd
    turn = ~horizontal & (j == np.where(i % 2 == 0, w - 1, 0))
    return np.where(horizontal | turn, 1.0, 10.0).astype(np.float32)


def tree_guides(dev, rng, b: int, h: int, w: int, c: int, channels: int = 3):
    """The four guides of a tree-on step as the objective passes them: a
    smooth image of ``channels`` channels (the low guide; a gray one, FAZ's,
    on 256 levels repeated to 3 channels, whose many equal edge weights the
    MST's (weight, edge index) order must break as ``boruvka_mst`` does) and
    aux logits of ``c`` classes upsampled 4x, 2x and 1x (the high guides),
    NHWC on ``dev``. Returns (low, [highs])."""
    from fedicra_torch.losses.tree_energy import resize_linear

    low = torch.as_tensor(smooth_images(rng, b, h, w, channels), device=dev)
    if channels == 1:
        low = (torch.round(low * 255.0) / 255.0).repeat(1, 1, 1, 3)
    highs = [
        resize_linear(torch.as_tensor(rng.normal(size=(b, h // s, w // s, c)).astype(np.float32),
                                      device=dev), (h, w))
        for s in (4, 2, 1)
    ]
    return low, highs


def dense_crf_inputs(dev, b: int = BATCH, size: int = IMG, seed: int = 3):
    """The dense-CRF loss's inputs beside the headline configuration: smooth
    images, normal logits (B, H, W, 3) and a region of interest covering 95%
    of the pixels. Returns (images, logits, rois) on ``dev``."""
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(smooth_images(rng, b, size, size), device=dev)
    logits = torch.as_tensor(rng.normal(size=(b, size, size, 3)).astype(np.float32), device=dev)
    rois = torch.as_tensor((rng.uniform(size=(b, size, size)) < 0.95).astype(np.float32), device=dev)
    return images, logits, rois


def dsn_head_inputs(dev, c: int, side: int, batch: int = BATCH, seed: int = 7):
    """A DSN head's input (a decoder stage's output: LeakyReLU of a smooth
    field, so that neighbouring taps correlate), and its 3x3 conv's weight
    and bias drawn as torch's default initialisation draws them."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(batch, c, side, side, generator=g, device=dev)
    x = F.leaky_relu(3 * F.avg_pool2d(noise, 3, 1, 1), 0.01).contiguous()
    bound = 1.0 / (9 * c) ** 0.5
    w = (torch.rand(DSN_HIDDEN, c, 3, 3, generator=g, device=dev) * 2 - 1) * bound
    b = (torch.rand(DSN_HIDDEN, generator=g, device=dev) * 2 - 1) * bound
    return x, w, b


def dsn_epilogue_inputs(b: int, c: int, h: int, w: int, k: int, p: float, mode: str, device="cpu",
                        seed: int = 4):
    """A DSN head's epilogue inputs: a 3x3 conv's output y (offset, so the
    batch means matter), a ``BatchNorm`` of c channels in ``mode`` ("train"
    or "eval") with its affine weights and running buffers drawn away from
    their initial values, a 1x1 weight of k classes, a keep mask at rate p
    (None at p = 0 or in eval mode) and aux's gradient g, all drawn on
    ``device``. Returns ((y, weight, keep, g), bn)."""
    from fedicra_torch.models.blocks import BatchNorm, dropout_keep

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    y = 0.5 + draw(b, c, h, w)
    bn = BatchNorm(c).to(dev).train(mode == "train")
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.5 * draw(c))
        bn.bias.copy_(0.5 * draw(c))
        bn.running_mean.copy_(draw(c))
        bn.running_var.copy_(0.5 + draw(c).abs())
    weight = draw(k, c, 1, 1) / c ** 0.5
    keep = None
    if mode == "train" and p != 0.0:
        keep = dropout_keep((b, c), p, gen, device=dev, dtype=torch.float32, channels=True)
    return (y, weight, keep, draw(b, k, h, w)), bn


def direct_float64_moments(x, w, b=None, chunk: int = 64):
    """The conv's output in float64, ``chunk`` output channels at a time: its
    batch mean and biased variance."""
    import torch.nn.functional as F

    means, variances = [], []
    for o in range(0, w.shape[0], chunk):
        bias = None if b is None else b[o:o + chunk].double()
        y = F.conv2d(x.double(), w[o:o + chunk].double(), bias, padding=1)
        means.append(y.mean(dim=(0, 2, 3)))
        variances.append(y.var(dim=(0, 2, 3), unbiased=False))
        del y
    return torch.cat(means), torch.cat(variances)


def main_path_setup(dev, tree_loss_weight: float = 0.1, iters: int = 4, rep_iters: int = 2,
                    amp: bool = False, task: str = "odoc"):
    """The main path's workload: ``task`` (ODOC unless given) at full width
    and its own image size, channels, classes and clients, batch 12, by
    default at the default tree weight with 4 steps (2 head, 2 body), in
    fp32 unless ``amp``.

    Returns (cfg, cid, model, state, round_fn, batches); random weights from
    cfg.seed, smooth images and 95%-unlabelled scribbles from numpy seed 1.
    """
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.trainer import init_client_state, make_round_fn
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task(
        task, procedure="ours", strategy="FedICRA", model="unet_lc_multihead",
        tree_loss_weight=tree_loss_weight, iters=iters, rep_iters=rep_iters, batch_size=BATCH,
        amp=amp,
    )
    cid = 1
    model = net_factory("unet_lc_multihead", in_chns=cfg.in_chns, class_num=cfg.num_classes,
                        num_clients=cfg.num_clients, client_id=cid)
    state = init_client_state(model, cfg, seed=cfg.seed, device=dev)
    round_fn = make_round_fn(model, cfg, device=dev)

    rng = np.random.default_rng(1)
    shape = (cfg.iters, cfg.batch_size, cfg.img_size, cfg.img_size)
    images = smooth_images(rng, cfg.iters * cfg.batch_size, cfg.img_size, cfg.img_size, cfg.in_chns)
    images = images.reshape(shape + (cfg.in_chns,))
    labels = rng.integers(0, cfg.num_classes, size=shape)
    labels = np.where(rng.uniform(size=shape) < 0.95, cfg.num_classes, labels)
    batches = {"image": torch.as_tensor(images, device=dev),
               "label": torch.as_tensor(labels, device=dev)}
    return cfg, cid, model, state, round_fn, batches


# ---- launch counts ---------------------------------------------------------

ZERO_COUNTS = {"gated_crf": 0, "gaussian_filter": 0, "tree_mst": 0, "tree_root": 0,
               "tree_fwd": 0, "tree_bwd": 0, "tree_filter_fwd": 0, "tree_filter_bwd": 0}


def kernel_counts() -> dict:
    """Every kernel's launches, and the plain tree filter's runs."""
    from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda, tree_filter, tree_filter_cuda

    return {**gated_crf_cuda.launches, **gaussian_filter_cuda.launches,
            **tree_filter_cuda.launches, **tree_filter.calls}


def reset_kernel_counts() -> None:
    from fedicra_torch.ops import gated_crf_cuda, gaussian_filter_cuda, tree_filter, tree_filter_cuda

    gated_crf_cuda.reset_launches()
    gaussian_filter_cuda.reset_launches()
    tree_filter_cuda.reset_launches()
    tree_filter.reset_calls()


def tree_on_counts(steps: int, gated_crf: int = None) -> dict:
    """The counts of ``steps`` tree-on steps: per step one MST and one rooting
    launch for the four trees, four filter forwards and four backwards, and
    no run of the plain route's filter; one gated-CRF launch a step unless
    ``gated_crf`` says otherwise."""
    return {**ZERO_COUNTS, "gated_crf": steps if gated_crf is None else gated_crf,
            "tree_mst": steps, "tree_root": steps, "tree_fwd": 4 * steps, "tree_bwd": 4 * steps}
