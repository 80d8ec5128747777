"""The contrast forwards' statistics-only DSN heads (``heatmaps_only``):
the same heatmaps, dropout draws and running statistics as full forwards,
and the batch-moment arithmetic they rest on (``ops/dsn_stats_cuda.py``);
and the U-Net family's activations, channels-last on the card: the same
results in either memory format.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack; the README names the command that runs every card
test.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fedicra_torch.engine.config import TrainConfig
from fedicra_torch.engine.objective import _contrast_loss
from fedicra_torch.models import blocks, net_factory, unet
from fedicra_torch.models.blocks import compute_dtype, dropout, dropout_keep, init_torch_default
from fedicra_torch.models.unet import _UNetLC
from fedicra_torch.ops import dsn_stats_cuda as dsn
from fedicra_torch.parallel import DataShard, spawn_ranks
from fedicra_torch.parallel.data_axis import data_shard
from fedicra_torch.utils import profiling
from torch_card import (DSN_HEAD_SHAPES, cuda_device, direct_float64_moments,  # noqa: F401
                        dsn_head_inputs, main_path_setup)

ROOT = Path(__file__).resolve().parents[1]
K, B, IMG = 5, 4, 32
# in_chns and classes of the ODOC-like and FAZ-like models
TASKS = {"odoc": (3, 3), "faz": (1, 2)}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (pytest-xdist's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(task: str, client_id: int = 0, device="cpu"):
    """Two train-mode copies of one LC model, their running statistics drawn
    away from their initial values."""
    in_chns, classes = TASKS[task]
    model = net_factory("unet_lc_multihead", in_chns=in_chns, class_num=classes,
                        num_clients=K, client_id=client_id)
    g = torch.Generator().manual_seed(11)
    init_torch_default(model, g)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if name.endswith("var") else -0.5))
    model.to(device).train()
    return model, copy.deepcopy(model)


def _images(task: str, batch: int = B, device="cpu"):
    g = torch.Generator().manual_seed(5)
    return torch.rand(batch, IMG, IMG, TASKS[task][0], generator=g).to(device)


def _contrast_forwards(model, images, cid: int, generator, heatmaps_only: bool):
    """The contrast loss's forwards, in its order: each heatmap."""
    kw = {"heatmaps_only": True} if heatmaps_only else {}
    out = []
    with torch.no_grad():
        for k in range(K):
            if k == cid:
                continue
            emb = torch.full((images.shape[0],), cid if k == 0 else k, dtype=torch.long,
                             device=images.device)
            out.append(model(images, emb_idx=emb, generator=generator, **kw)["heatmaps"][-1])
    return out


def _assert_heads_close(got, want, rtol=1e-5):
    """A head's running statistics: the variance at ``rtol``; the mean at
    ``rtol`` of its magnitude plus its channel's standard deviation, since
    the full forward's mean is taken from the conv's fp32 output, whose
    rounding is relative to the values' spread, not to their mean."""
    for prefix in {n.rsplit(".", 1)[0] for n in want if ".dsn_head" in n}:
        mean, var = want[f"{prefix}.running_mean"], want[f"{prefix}.running_var"]
        torch.testing.assert_close(got[f"{prefix}.running_var"], var, rtol=rtol, atol=0)
        gap = (got[f"{prefix}.running_mean"] - mean).abs()
        assert (gap <= rtol * (mean.abs() + var.sqrt())).all(), (prefix, float(gap.max()))


def _assert_forwards_agree(full, stats, hm_full, hm_stats, g_full, g_stats):
    assert all(torch.equal(a, b) for a, b in zip(hm_full, hm_stats))
    assert torch.equal(g_full.get_state(), g_stats.get_state())
    want, got = dict(full.named_buffers()), dict(stats.named_buffers())
    moved = [n for n in want if ".dsn_head" not in n]
    assert moved and all(torch.equal(got[n], want[n]) for n in moved)
    _assert_heads_close(got, want)


class FullForwards(torch.nn.Module):
    """A model whose contrast forwards run in full: it drops the argument
    that asks for the heatmaps only."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, heatmaps_only=False, **kw):
        return self.model(x, **kw)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cid", [0, 2])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_heatmaps_only_forwards_equal_full_forwards(task, cid, amp):
    """One contrast forward per foreign client, each way, from equal models
    and generators: the heatmaps, the generator's state and every encoder
    and up-block buffer bit for bit, the heads' statistics to rounding; then
    the contrast loss, each way, from the models so advanced."""
    full, stats = _models(task, client_id=cid)
    images = _images(task)
    g_full, g_stats = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with compute_dtype(torch.bfloat16 if amp else None):
        hm_full = _contrast_forwards(full, images, cid, g_full, heatmaps_only=False)
        hm_stats = _contrast_forwards(stats, images, cid, g_stats, heatmaps_only=True)
        _assert_forwards_agree(full, stats, hm_full, hm_stats, g_full, g_stats)

        cfg = TrainConfig.for_task(task, img_size=IMG, batch_size=B, num_clients=K)
        hm_own = torch.rand(B, 1, 1, 256, generator=torch.Generator().manual_seed(9))
        hm_own = hm_own.to(hm_full[0].dtype)

        want = _contrast_loss(FullForwards(full), images, hm_own, cid, cfg, g_full)
        got = _contrast_loss(stats, images, hm_own, cid, cfg, g_stats)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(g_full.get_state(), g_stats.get_state())


def _sharded_forwards_rank(rank, device, task, out):
    """Both ways of the contrast forwards on this rank's rows of the batch,
    under a two-rank data shard; writes the results to ``out.<rank>``."""
    import pickle

    torch.set_num_threads(1)
    full, stats = _models(task)
    images = _images(task)
    shard = DataShard(dist.group.WORLD, rank, dist.get_world_size(), images.shape[0])
    result = {}
    with data_shard(shard):
        for name, model in (("full", full), ("stats", stats)):
            g = torch.Generator().manual_seed(3)
            hms = _contrast_forwards(model, shard.rows(images), 1, g, heatmaps_only=name == "stats")
            result[name] = {"heatmaps": [h.numpy() for h in hms], "generator": g.get_state().numpy(),
                            "buffers": {n: b.numpy() for n, b in model.named_buffers()}}
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_heatmaps_only_forwards_equal_full_forwards_on_a_data_shard(tmp_path, monkeypatch, task):
    """The same on two gloo ranks, each holding half the batch: the heads
    sum their moments over the group, as BatchNorm does."""
    import pickle

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "rank")
    spawn_ranks(_sharded_forwards_rank, (task, out), "gloo", ["cpu", "cpu"], timeout=300)
    results = []
    for rank in range(2):
        with open(f"{out}.{rank}", "rb") as f:
            results.append(pickle.load(f))
    for r in results:
        full, stats = r["full"], r["stats"]
        assert all(np.array_equal(a, b) for a, b in zip(full["heatmaps"], stats["heatmaps"]))
        assert np.array_equal(full["generator"], stats["generator"])
        want = {n: torch.as_tensor(b) for n, b in full["buffers"].items()}
        got = {n: torch.as_tensor(b) for n, b in stats["buffers"].items()}
        assert all(torch.equal(got[n], want[n]) for n in want if ".dsn_head" not in n)
        _assert_heads_close(got, want)
    # the group's statistics: every rank holds the same buffers
    for n, b in results[0]["stats"]["buffers"].items():
        assert np.array_equal(b, results[1]["stats"]["buffers"][n]), n


# (batch, in channels, h, w, bias scale, input offset, input scale)
MOMENT_CASES = {
    "ODOC head1-like": (3, 64, 6, 6, 1.0, 0.0, 1.0),
    "FAZ head3-like": (2, 16, 12, 10, 1.0, 0.0, 1.0),
    "channels not a multiple of 16": (2, 20, 7, 9, 1.0, 0.0, 1.0),
    "large bias": (2, 16, 8, 8, 1e3, 0.0, 1.0),
    "near-constant channels": (2, 16, 8, 8, 1.0, 1e3, 1e-3),
    "one row, one column": (3, 5, 1, 1, 1.0, 0.5, 1.0),
}


@pytest.mark.parametrize("case", sorted(MOMENT_CASES))
def test_plain_moments_equal_the_direct_float64_statistics(case):
    b, c, h, w, bias_scale, offset, scale = MOMENT_CASES[case]
    g = torch.Generator().manual_seed(2)
    x = offset + scale * torch.randn(b, c, h, w, generator=g)
    weight = torch.randn(24, c, 3, 3, generator=g) / (3 * c ** 0.5)
    bias = bias_scale * torch.randn(24, generator=g)
    mean, var = dsn.conv3x3_batch_moments(x, weight, bias)
    want_mean, want_var = direct_float64_moments(x, weight, bias)
    assert mean.dtype == var.dtype == torch.float64
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=0)


def test_plain_moments_advance_the_running_buffers_by_batchnorm_rule():
    g = torch.Generator().manual_seed(4)
    x, weight = torch.randn(2, 16, 6, 6, generator=g), torch.randn(8, 16, 3, 3, generator=g)
    running = (torch.rand(8, generator=g), torch.rand(8, generator=g) + 0.5)
    before = [t.clone() for t in running]
    mean, var = dsn.conv3x3_batch_moments(x, weight, None, running=running, momentum=0.25)
    for buf, old, stat in zip(running, before, (mean, var)):
        torch.testing.assert_close(buf, 0.75 * old + 0.25 * stat.float(), rtol=1e-6, atol=1e-7)


def test_dropout_and_its_keep_mask_draw_alike():
    x = torch.rand(3, 5, 4, 4)
    for channels in (False, True):
        g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
        keep = dropout_keep(x.shape, 0.3, g2, device=x.device, dtype=x.dtype, channels=channels)
        assert torch.equal(dropout(x, 0.3, g1, channels=channels), x * keep / 0.7)
        assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("mode", ["eval", "grad on"])
def test_heatmaps_only_refuses_eval_mode_and_grad_before_it_runs(mode):
    model, untouched = _models("odoc")
    images = _images("odoc")
    if mode == "eval":
        model.eval()
    with torch.set_grad_enabled(mode == "grad on"):
        with pytest.raises(RuntimeError, match="statistics-only forward"):
            model(images, heatmaps_only=True)
    want = dict(untouched.named_buffers())
    assert all(torch.equal(b, want[n]) for n, b in model.named_buffers())


def test_heads_run_the_moments_only_in_the_contrast_forwards(monkeypatch):
    """Three moment calls a contrast forward, none in the step's own
    forward or in evaluation, and under a profiler one span a head, inside
    the contrast span."""
    calls = []
    plain = dsn.conv3x3_batch_moments

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return plain(*args, **kw)

    monkeypatch.setattr(dsn, "conv3x3_batch_moments", counted)
    model, _ = _models("odoc")
    images = _images("odoc")
    model(images)["logits"].sum().backward()
    with torch.no_grad():
        model.eval()(images)
    assert calls == []
    model.train()
    cfg = TrainConfig.for_task("odoc", img_size=IMG, batch_size=B, num_clients=K)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _contrast_loss(model, images, torch.rand(B, 1, 1, 256), 1, cfg)
    assert calls == [64, 32, 16] * (K - 1)
    _contrast_loss(model.eval(), images, torch.rand(B, 1, 1, 256), 1, cfg)  # eval: full forwards
    assert calls == [64, 32, 16] * (K - 1)
    spans = profiling.spans()
    profiling.reset()
    contrast = [s for s in spans if s["name"] == "fedicra.step.contrast"]
    heads = [s for s in spans if s["name"] == "fedicra.contrast.head_stats"]
    assert len(contrast) == 1 and [s["ids"]["head"] for s in heads] == [1, 2, 3] * (K - 1)
    assert all(s["parent"] == contrast[0]["seq"] for s in heads)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_heads_hand_the_moments_contiguous_planes(monkeypatch, task):
    """The kernels read NCHW planes; a 1-channel model's decoder runs
    channels-last, so its heads make their input contiguous first."""
    seen = []
    plain = dsn.conv3x3_batch_moments

    def checked(x, *args, **kw):
        seen.append(x.is_contiguous())
        return plain(x, *args, **kw)

    monkeypatch.setattr(dsn, "conv3x3_batch_moments", checked)
    model, _ = _models(task)
    _contrast_forwards(model, _images(task), 1, None, heatmaps_only=True)
    assert seen == [True] * 3 * (K - 1)


def test_band_rows_take_the_fewest_waves_of_the_tallest_bands():
    # ODOC's head3 (384^2, batch 12, one group pair) with 396 blocks at once:
    # 12 rows give 384 blocks, one wave of 12 rows; 6 rows two waves
    assert dsn.band_rows(384, 384, 12, 396) == 12
    # ODOC's head1 (96^2, ten group pairs): 48 rows, one wave of 240 blocks
    assert dsn.band_rows(96, 96, 120, 264) == 48
    for h, w, per_band, conc in ((192, 192, 36, 264), (8, 8, 1, 100), (1, 9000, 4, 264),
                                 (7, 5, 3, 2)):
        rows = dsn.band_rows(h, w, per_band, conc)
        assert 1 <= rows <= h and (rows == 1 or rows * w <= dsn.BAND_PIXELS)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    dsn.reset_launches()
    x, w = torch.zeros(1, 16, 8, 8), torch.zeros(4, 16, 3, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dsn.conv3x3_batch_moments_cuda(x, w, None)
    dsn.conv3x3_batch_moments(x, w, None)  # the plain twin: no launch
    assert dsn.launches == {"dsn_stats": 0}


# ---- the activations' memory format -------------------------------------

# ``_nchw`` as the card has it (the NHWC input's channels-last view) and as
# a contiguous NCHW copy
LAYOUTS = {"channels_last": lambda x: x.permute(0, 3, 1, 2),
           "nchw": lambda x: x.permute(0, 3, 1, 2).contiguous()}
LAYOUT_MODELS = {"unet": {}, "unet_multihead": {},
                 "unet_lc_multihead": {"num_clients": K, "client_id": 1}}


def _layout_model(name: str, device="cpu"):
    model = net_factory(name, in_chns=3, class_num=3, **LAYOUT_MODELS[name])
    init_torch_default(model, torch.Generator().manual_seed(11))
    return model.to(device).train()


def _concatenated(conv: blocks.Conv, parts) -> torch.Tensor:
    return torch.nn.Conv2d.forward(conv, torch.cat(parts, dim=1))


def _forward_in_layout(monkeypatch, model, images, layout: str, heatmaps_only=False,
                       concatenated=False):
    """A train-mode forward whose model sees its input in ``layout``: its
    outputs, the dropout keep masks it drew, and its generator's state.
    ``concatenated`` makes ``Conv`` concatenate its parts on the card too."""
    masks = []
    draw = blocks.dropout_keep

    def recorded(*args, **kw):
        keep = draw(*args, **kw)
        masks.append(keep.clone())
        return keep

    g = torch.Generator(device=images.device).manual_seed(3)
    kw = {"heatmaps_only": True} if heatmaps_only else {}
    with monkeypatch.context() as m, torch.set_grad_enabled(not heatmaps_only):
        m.setattr(blocks, "dropout_keep", recorded)
        m.setattr(unet, "_nchw", LAYOUTS[layout])
        if concatenated:
            m.setattr(blocks.Conv, "_forward_parts", _concatenated)
        out = model(images, emb_idx=2, generator=g, **kw)
    return out, masks, g.get_state()


@pytest.mark.parametrize("name, heatmaps_only", [
    *((name, False) for name in sorted(LAYOUT_MODELS)), ("unet_lc_multihead", True)],
    ids=[*sorted(LAYOUT_MODELS), "unet_lc_multihead-heatmaps_only"])
def test_blocks_give_the_same_results_in_either_memory_format(monkeypatch, name, heatmaps_only):
    """The same model and input, once as contiguous NCHW and once as the
    channels-last view the card runs: every block keeps the channels-last
    format; logits, aux outputs, heatmaps and every running statistic agree
    to fp32 rounding; the dropout masks and the generator's state after are
    the same bits. The LC model's statistics-only forward too."""
    model = _layout_model(name)
    twin = copy.deepcopy(model)
    images = torch.rand(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(5))
    got, got_masks, got_state = _forward_in_layout(monkeypatch, model, images, "channels_last",
                                                   heatmaps_only)
    want, want_masks, want_state = _forward_in_layout(monkeypatch, twin, images, "nchw",
                                                      heatmaps_only)
    # an NHWC view is contiguous where its NCHW tensor is channels-last
    assert all(t.is_contiguous() for t in got["features"] + got.get("de", []))
    assert not any(t.is_contiguous() for t in want["features"] + want.get("de", []))
    for key in ("logits", "aux", "heatmaps"):
        assert (key in got) == (key in want)
        if key in got:
            torch.testing.assert_close(got[key], want[key])
    assert got_masks and len(got_masks) == len(want_masks)
    assert all(torch.equal(a, b) for a, b in zip(got_masks, want_masks))
    assert torch.equal(got_state, want_state)
    want_buffers = dict(twin.named_buffers())
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, want_buffers[n], msg=n)


# (batch, size, the parts' channels, output channels): a small conv, and
# ODOC's first up block, whose concatenation cuDNN sends to FFT tiling
PARTS_SHAPES = {"small": (2, 12, (16, 8), 8), "odoc_up1": (12, 48, (128, 128), 128)}


@pytest.mark.parametrize("device, shape", [
    pytest.param("cpu", "small", id="cpu"),
    pytest.param("cuda", "small", marks=pytest.mark.cuda, id="cuda"),
    pytest.param("cuda", "odoc_up1", marks=pytest.mark.cuda, id="cuda-odoc_up1")])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_conv_of_parts_equals_conv_of_their_concatenation(request, device, shape, layout):
    """``Conv._forward_parts`` on a tuple of channel blocks: their
    concatenation's convolution to fp32 rounding, and so are the gradients.
    ``Conv.forward`` on the tuple takes that route on the card in fp32, and
    concatenates on the CPU and under a compute dtype, so that its one
    convolution rounds once: the same bits as the route it takes."""
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    n, size, channels, out_ch = PARTS_SHAPES[shape]
    g = torch.Generator().manual_seed(7)
    layer = blocks.conv(sum(channels), out_ch)
    init_torch_default(layer, g)
    layer.to(device)
    parts = tuple(LAYOUTS[layout](torch.randn(n, size, size, c, generator=g).to(device))
                  for c in channels)
    split = tuple(t.clone().requires_grad_() for t in parts)
    whole = [t.clone().requires_grad_() for t in parts]
    got, want = layer._forward_parts(split), layer(torch.cat(whole, dim=1))
    torch.testing.assert_close(got, want)
    grads = torch.autograd.grad(got.square().sum(), [*split, layer.weight, layer.bias])
    wants = torch.autograd.grad(want.square().sum(), [*whole, layer.weight, layer.bias])
    for a, b in zip(grads, wants):
        # a weight's gradient sums n x size^2 products a tap: rounding
        # relative to its largest
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    with torch.no_grad():
        route = layer._forward_parts(parts) if parts[0].is_cuda else layer(torch.cat(parts, dim=1))
        assert torch.equal(layer(parts), route)
        with compute_dtype(torch.bfloat16):
            assert torch.equal(layer(parts), layer(torch.cat(parts, dim=1)))


# ---- on the card ---------------------------------------------------------

HEAD_SHAPES = {f"{task}.head{i}": shape for task, shapes in DSN_HEAD_SHAPES.items()
               for i, shape in enumerate(shapes, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_kernel_equals_float64_and_the_plain_twin_at_the_head_shapes(cuda_device, shape):
    x, w, b = dsn_head_inputs(cuda_device, *HEAD_SHAPES[shape])
    running = (torch.rand(512, device=cuda_device), torch.rand(512, device=cuda_device) + 0.5)
    running_plain = tuple(t.clone() for t in running)
    dsn.reset_launches()
    mean, var = dsn.conv3x3_batch_moments(x, w, b, running=running)
    torch.cuda.synchronize()
    assert dsn.launches == {"dsn_stats": 1}
    want_mean, want_var = direct_float64_moments(x, w, b)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=0)
    plain_mean, plain_var = dsn.conv3x3_batch_moments_plain(x, w, b, running=running_plain)
    torch.testing.assert_close(mean, plain_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(var, plain_var, rtol=1e-5, atol=0)
    for got, want in zip(running, running_plain):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


SHARD_HEAD = (32, 48, 5)  # channels, side, batch: the ranks hold 3 and 2 images


def _sharded_moments_rank(rank, device, out):
    """The kernels on this rank's rows of one head input, under a two-rank
    data shard on the card; saves (mean, var, running buffers) to ``out.<rank>``."""
    dev = torch.device(device)
    x, w, b = dsn_head_inputs(dev, *SHARD_HEAD)
    running = (torch.full((w.shape[0],), 0.5, device=dev), torch.ones(w.shape[0], device=dev))
    shard = DataShard(dist.group.WORLD, rank, dist.get_world_size(), x.shape[0])
    with data_shard(shard):
        mean, var = dsn.conv3x3_batch_moments(shard.rows(x), w, b, running=running)
    torch.save([t.cpu() for t in (mean, var, *running)], f"{out}.{rank}")


@pytest.mark.cuda
def test_kernel_sums_its_moments_over_a_data_shard(cuda_device, tmp_path):
    """Two ranks on the card, each with its rows of the batch: the tap sums
    and the quadratic forms summed over the group give the whole batch's
    moments (float64 direct statistics at rtol 1e-5) and running buffers."""
    out = str(tmp_path / "rank")
    spawn_ranks(_sharded_moments_rank, (out,), "gloo", ["cuda", "cuda"], timeout=300)
    x, w, b = dsn_head_inputs(cuda_device, *SHARD_HEAD)
    want_mean, want_var = (t.cpu() for t in direct_float64_moments(x, w, b))
    running = (torch.full((w.shape[0],), 0.5, device=cuda_device), torch.ones(w.shape[0], device=cuda_device))
    dsn.conv3x3_batch_moments(x, w, b, running=running)
    for rank in range(2):
        mean, var, rm, rv = torch.load(f"{out}.{rank}")
        torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=0)
        torch.testing.assert_close(var, want_var, rtol=1e-5, atol=0)
        torch.testing.assert_close(rm, running[0].cpu(), rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(rv, running[1].cpu(), rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("task", sorted(TASKS))
def test_an_ours_round_on_the_card_launches_12_a_step_and_matches_full_forwards(
        cuda_device, monkeypatch, task):
    """The task's "ours" round at its shape (ODOC 384^2, FAZ 256^2; batch
    12, 5 clients), 2 head steps and 1 body step: 12 moment launches (3
    heads x 4 contrast forwards) and 3 host syncs a step; then the same
    round with the contrast forwards full: no launch, and its losses within
    the benchmark's loss limit of the first."""
    cfg, cid, model, state, round_fn, batches = main_path_setup(cuda_device, iters=3, rep_iters=1,
                                                                task=task)
    start = state.generator.get_state()
    dsn.reset_launches()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts):
        _, metrics = round_fn(state, batches, cid)
        torch.cuda.synchronize()
    syncs = sum(profiling.counters()["host_syncs"].values())
    profiling.reset()
    assert dsn.launches == {"dsn_stats": 12 * cfg.iters}
    assert syncs == 3 * cfg.iters

    forward = _UNetLC.forward
    monkeypatch.setattr(_UNetLC, "forward",
                        lambda self, x, emb_idx=None, generator=None, heatmaps_only=False:
                        forward(self, x, emb_idx, generator))
    state.generator.set_state(start)
    dsn.reset_launches()
    _, full = round_fn(state, batches, cid)
    assert dsn.launches == {"dsn_stats": 0}
    limit = json.loads((ROOT / "benchmark" / "limits" / f"{task}.local_rounds.json").read_text())
    got, want = metrics["total_loss"].double().cpu(), full["total_loss"].double().cpu()
    gap = ((got - want).abs() / want.abs()).max().item()
    assert gap <= limit["limits"]["loss"], (got.tolist(), want.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
def test_nchw_is_a_view_of_the_input_on_the_card(cuda_device, channels):
    """``_nchw`` copies nothing on the card: at C = 3 a channels-last view
    of the NHWC input; at C = 1 the tensor a contiguous copy gives, strides
    and all, since a 1-channel tensor is both formats."""
    x = torch.rand(2, 256, 256, channels, device=cuda_device)
    got = unet._nchw(x)
    assert got.data_ptr() == x.data_ptr() and got.shape == (2, channels, 256, 256)
    assert got.is_contiguous(memory_format=torch.channels_last)
    if channels == 1:
        copied = x.permute(0, 3, 1, 2).contiguous()
        assert got.stride() == copied.stride() and copied.data_ptr() == x.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("layout, concatenated", [
    ("nchw", True), ("nchw", False), ("channels_last", True)],
    ids=["nchw-concatenated", "nchw-parts", "channels_last-concatenated"])
def test_the_lc_model_runs_channels_last_on_the_card_at_odocs_shape(
        cuda_device, monkeypatch, layout, concatenated):
    """ODOC's shape (384^2, C = 3), train mode: every encoder stage's and up
    block's output is channels-last, and the logits, aux outputs, heatmaps
    and running statistics match a forward of the same model in another
    route to fp32 rounding (norm-relative gap at most 1e-4: cuDNN's
    algorithms differ between the routes, through the model's 23
    convolutions), with the same dropout masks and generator state. The
    routes: contiguous NCHW with the up blocks' concatenations (the route
    before the card ran channels-last), with their parts, and channels-last
    with the concatenations."""
    model = _layout_model("unet_lc_multihead", cuda_device)
    twin = copy.deepcopy(model)
    images = torch.rand(2, 384, 384, 3, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    outputs = []
    blocks_ = model.encoder.stages() + [getattr(model.decoder, f"up{i}") for i in range(1, 5)]
    hooks = [b.register_forward_hook(lambda mod, args, out: outputs.append(out)) for b in blocks_]
    try:
        got, got_masks, got_state = _forward_in_layout(monkeypatch, model, images, "channels_last")
    finally:
        for h in hooks:
            h.remove()
    assert len(outputs) == 9
    assert all(t.is_contiguous(memory_format=torch.channels_last) for t in outputs)
    want, want_masks, want_state = _forward_in_layout(monkeypatch, twin, images, layout,
                                                      concatenated=concatenated)
    pairs = [("logits", got["logits"], want["logits"]),
             ("heatmap", got["heatmaps"][-1], want["heatmaps"][-1])]
    pairs += [(f"aux{i}", a, b) for i, (a, b) in enumerate(zip(got["aux"], want["aux"]))]
    want_buffers = dict(twin.named_buffers())
    pairs += [(n, b, want_buffers[n]) for n, b in model.named_buffers()]
    with torch.no_grad():
        gaps = {name: float((a - b).norm() / b.norm()) for name, a, b in pairs}
    print(f"norm-relative gaps, channels-last with parts against {layout} "
          f"{'concatenated' if concatenated else 'with parts'}:",
          {n: g for n, g in gaps.items() if "." not in n}, "running statistics, worst:",
          max(g for n, g in gaps.items() if "." in n))
    assert max(gaps.values()) <= 1e-4, gaps
    assert all(torch.equal(a, b) for a, b in zip(got_masks, want_masks))
    assert torch.equal(got_state, want_state)
