"""A DSN head's epilogue after its 3x3 convolution (``ops/dsn_epilogue_cuda.py``):
its plain twin and a float64 model of the kernels' arithmetic against
autograd of the head's composition, the CPU route unchanged, and on the
card the kernels against both at the tasks' head shapes.

This file imports no JAX, so the tests marked ``cuda`` run on a machine with
a card and no JAX stack; the README names the command that runs every card
test.
"""

import copy

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fedicra_torch.models import blocks, net_factory
from fedicra_torch.models.blocks import DSNHead, dropout, init_torch_default
from fedicra_torch.ops import dsn_epilogue_cuda as epi
from fedicra_torch.parallel import DataShard, spawn_ranks
from fedicra_torch.parallel.data_axis import data_shard
from fedicra_torch.utils import profiling
from torch_card import DSN_HEAD_SHAPES, DSN_HIDDEN, cuda_device, dsn_epilogue_inputs  # noqa: F401

P = 0.1  # the heads' Dropout2d rate
MODES = ["train", "eval"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (pytest-xdist's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _float64_head(y, bn, weight, keep, p, g):
    """Autograd of the head's composition in float64: aux, the running
    buffers after it, and the gradients of y, gamma, beta and the 1x1 weight."""
    bn64 = copy.deepcopy(bn).double()
    y64 = y.detach().double().requires_grad_()
    w64 = weight.detach().double().requires_grad_()
    h = F.relu(bn64(y64))
    if keep is not None:
        h = h * keep.double() / (1.0 - p)
    aux = F.conv2d(h, w64)
    dy, dgamma, dbeta, dw = torch.autograd.grad((aux * g.double()).sum(),
                                                [y64, bn64.weight, bn64.bias, w64])
    return {"aux": aux.detach(), "running_mean": bn64.running_mean, "running_var": bn64.running_var,
            "dy": dy, "dgamma": dgamma, "dbeta": dbeta, "dweight": dw}


def _twin(y, bn, weight, keep, p, g):
    """The plain twin (the route CPU tensors take) and its autograd."""
    bn = copy.deepcopy(bn)
    y, weight = y.detach().requires_grad_(), weight.detach().requires_grad_()
    aux = epi.dsn_epilogue_plain(y, bn, weight, keep, p)
    dy, dgamma, dbeta, dw = torch.autograd.grad((aux * g).sum(), [y, bn.weight, bn.bias, weight])
    return {"aux": aux.detach(), "running_mean": bn.running_mean, "running_var": bn.running_var,
            "dy": dy, "dgamma": dgamma, "dbeta": dbeta, "dweight": dw}


def _kernel_model(y, bn, weight, keep, p, g):
    """The kernels' arithmetic (``csrc/dsn_epilogue.cu``'s header), each pass
    written out in float64: the batch sums and moments, the chain and aux,
    pass A's sums and pass B's dy."""
    y, g = y.double(), g.double()
    b, c, h, w = y.shape
    m = b * h * w
    gamma, beta = bn.weight.detach().double(), bn.bias.detach().double()
    rm, rv = bn.running_mean.double(), bn.running_var.double()
    if bn.training:
        mean = y.sum(dim=(0, 2, 3)) / m
        var = ((y * y).sum(dim=(0, 2, 3)) / m - mean * mean).clamp(min=0.0)
        rm, rv = rm * (1 - bn.momentum) + bn.momentum * mean, rv * (1 - bn.momentum) + bn.momentum * var
    else:
        mean, var = rm, rv
    rstd = 1.0 / torch.sqrt(var + bn.eps)
    per = lambda v: v[None, :, None, None]  # noqa: E731
    kq = torch.ones(b, c, 1, 1, dtype=torch.float64) if keep is None else keep.double()
    inv_q = 1.0 if keep is None else 1.0 / (1.0 - p)
    wk = weight.detach().double()[:, :, 0, 0]  # (K, C)
    xh = (y - per(mean)) * per(rstd)
    u = xh * per(gamma) + per(beta)
    z = u.clamp(min=0.0) * kq * inv_q
    aux = torch.einsum("kc,bchw->bkhw", wk, z)
    du = (u > 0) * kq * inv_q * torch.einsum("kc,bkhw->bchw", wk, g)
    dw = torch.einsum("bkhw,bchw->kc", g, z)
    dbeta, dgamma = du.sum(dim=(0, 2, 3)), (du * xh).sum(dim=(0, 2, 3))
    if bn.training:
        dy = per(gamma * rstd) * (du - per(dbeta / m) - xh * per(dgamma / m))
    else:
        dy = per(gamma * rstd) * du
    return {"aux": aux, "running_mean": rm, "running_var": rv, "dy": dy, "dgamma": dgamma, "dbeta": dbeta,
            "dweight": dw[:, :, None, None]}


def _gaps(got: dict, want: dict) -> dict:
    """Each quantity's norm-relative gap."""
    return {n: float((got[n].double().cpu() - want[n].double().cpu()).norm() / want[n].double().cpu().norm())
            for n in want}


# (route, its norm-relative tolerance against float64): the twin computes in
# fp32; the model of the kernels in float64, so only the order of its sums
# differs from autograd's
ROUTES = {"twin": (_twin, 1e-5), "kernel_model": (_kernel_model, 1e-11)}


@pytest.mark.parametrize("p", [P, 0.0], ids=["p0.1", "p0"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_equals_float64_autograd_of_the_heads_composition(route, mode, p):
    """As a function of y: aux, the running buffers, and the gradients of
    y, gamma, beta and the 1x1 weight, against autograd of the head's
    composition in float64."""
    (y, weight, keep, g), bn = dsn_epilogue_inputs(3, 40, 5, 6, 3, p, mode)
    assert mode == "eval" or p == 0.0 or keep.min() == 0.0  # a dropped channel
    fn, tol = ROUTES[route]
    gaps = _gaps(fn(y, bn, weight, keep, p, g), _float64_head(y, bn, weight, keep, p, g))
    assert max(gaps.values()) <= tol, gaps


@pytest.mark.parametrize("mode", MODES)
def test_head_on_the_cpu_draws_and_computes_as_its_composition(mode):
    """``DSNHead.forward`` on CPU tensors: the old composition's bits, running
    buffers and generator state (the keep mask drawn as ``dropout`` draws it)."""
    head = DSNHead(8, 3, hidden=24)
    init_torch_default(head, torch.Generator().manual_seed(1))
    head.train(mode == "train")
    old = copy.deepcopy(head)
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(2))
    g_new, g_old = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = head(x, g_new)
    h = F.relu(old.bn(old.conv(x)))
    if old.training:
        h = dropout(h, old.drop_rate, g_old, channels=True)
    assert torch.equal(got, old.out(h))
    assert torch.equal(g_new.get_state(), g_old.get_state())
    for (name, a), b in zip(head.named_buffers(), old.buffers()):
        assert torch.equal(a, b), name


def test_wrapper_refuses_what_the_kernels_do_not_take():
    (y, weight, keep, _), bn = dsn_epilogue_inputs(2, 8, 4, 4, 2, P, "train")
    epi.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        epi.dsn_epilogue_cuda(y, bn, weight, keep, P)
    epi.dsn_epilogue(y, bn, weight, keep, P)  # the plain twin: no launch
    assert epi.launches == {"dsn_epilogue": 0}


def test_full_forwards_span_each_head_and_contrast_forwards_none():
    """Under a profiler, one ``fedicra.dsn.head`` span a head (id ``head``) in
    a full forward, in train and eval mode; none in a statistics-only one."""
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5, client_id=1)
    init_torch_default(model, torch.Generator().manual_seed(11))
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.train()(images)
        with torch.no_grad():
            model(images, heatmaps_only=True)
            model.eval()(images)
    heads = [s for s in profiling.spans() if s["name"] == "fedicra.dsn.head"]
    profiling.reset()
    assert [s["ids"] for s in heads] == [{"head": h} for h in (1, 2, 3)] * 2


# ---- on the card -----------------------------------------------------------

HEAD_SHAPES = {f"{task}.head{i}": (c, side, 3 if task == "odoc" else 2)
               for task, shapes in DSN_HEAD_SHAPES.items() for i, (c, side) in enumerate(shapes, 1)}
KERNEL_TOL = 1e-5  # norm-relative against float64: fp32 rounding over sums of up to 1.8M terms
FLIP_BAND = 1e-6  # ~16 fp32 ulps of u's terms: where fp32 rounding can move u across zero


def _kernels(y, bn, weight, keep, p, g):
    """The kernel route's forward and backward on copies of ``bn``'s state."""
    bn = copy.deepcopy(bn)
    y, weight = y.detach().requires_grad_(), weight.detach().requires_grad_()
    aux = epi.dsn_epilogue(y, bn, weight, keep, p)
    dy, dgamma, dbeta, dw = torch.autograd.grad(aux, [y, bn.weight, bn.bias, weight], g)
    return {"aux": aux.detach(), "running_mean": bn.running_mean, "running_var": bn.running_var,
            "dy": dy, "dgamma": dgamma, "dbeta": dbeta, "dweight": dw}


def _float64_gaps(results: dict, y, bn, weight, keep, p, g, chunk: int = 32):
    """Each route's norm-relative gaps to ``_float64_head``, and what ReLU's
    gate can add to them: (gaps by route, allowance by quantity).

    An element whose float64 BatchNorm output u lies within ``FLIP_BAND`` of
    the size of its terms may take the other side of zero in fp32, on any
    route; it then moves du by its whole value, and dbeta, dgamma and dy
    with it (train-mode dy through the sums too). The allowance is the
    norm of those moves over every such element, relative to the
    quantity's norm. Taken ``chunk`` channels at a time (BatchNorm is per
    channel, aux the chunks' sum), so the float64 maps stay small."""
    b, c = y.shape[:2]
    m = y[:, 0].numel()
    per = lambda v: v[None, :, None, None]  # noqa: E731
    err = {route: {} for route in results}
    ref_sq, flip_sq, aux64 = {}, {}, 0.0
    for c0 in range(0, c, chunk):
        sl = slice(c0, min(c0 + chunk, c))
        part = blocks.BatchNorm(sl.stop - c0).to(y.device).train(bn.training)
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(part, name).copy_(getattr(bn, name)[sl])
        part_keep = None if keep is None else keep[:, sl]
        want = _float64_head(y[:, sl], part, weight[:, sl], part_keep, p, g)
        aux64 = aux64 + want.pop("aux")
        for name, ref in want.items():
            ref_sq[name] = ref_sq.get(name, 0.0) + float(ref.square().sum())
            for route, got in results.items():
                d = got[name][sl] if got[name].ndim == 1 else got[name][:, sl]
                err[route][name] = err[route].get(name, 0.0) + float((d.double() - ref).square().sum())
        del want
        with torch.no_grad():
            y64 = y[:, sl].double()
            if bn.training:
                mean, var = y64.mean(dim=(0, 2, 3)), y64.var(dim=(0, 2, 3), unbiased=False)
            else:
                mean, var = part.running_mean.double(), part.running_var.double()
            rstd, gamma, beta = (var + part.eps).rsqrt(), part.weight.double(), part.bias.double()
            xh = (y64 - per(mean)) * per(rstd)
            terms = ((xh * per(gamma)).abs() + per(beta.abs())
                     + per((gamma * rstd).abs()) * (y64.abs() + per(mean.abs())))
            near = (xh * per(gamma) + per(beta)).abs() <= FLIP_BAND * terms
            del y64, terms
            flip = torch.einsum("kc,bkhw->bchw", weight[:, sl, 0, 0].double(), g.double()).abs() * near
            if part_keep is not None:
                flip = flip * part_keep.double() / (1.0 - p)
            fb, fg = flip.sum(dim=(0, 2, 3)), (flip * xh.abs()).sum(dim=(0, 2, 3))
            dy = flip + ((per(fb) + xh.abs() * per(fg)) / (b * m) if bn.training else 0.0)
            moves = {"dbeta": fb, "dgamma": fg, "dy": per((gamma * rstd).abs()) * dy}
            for name, v in moves.items():
                flip_sq[name] = flip_sq.get(name, 0.0) + float(v.square().sum())
            del xh, flip, dy, moves
    gaps = {}
    for route, got in results.items():
        gaps[route] = {n: (e / ref_sq[n]) ** 0.5 for n, e in err[route].items()}
        gaps[route]["aux"] = float((got["aux"].double() - aux64).norm() / aux64.norm())
    allowance = {n: (flip_sq.get(n, 0.0) / ref_sq[n]) ** 0.5 for n in ref_sq}
    return gaps, {**allowance, "aux": 0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_kernels_equal_float64_and_the_twin_at_the_head_shapes(cuda_device, shape, mode):
    """Batch 12, 512 channels, the task's side and classes: aux, the running
    buffers and the four gradients, norm-relative to float64 autograd of the
    composition within ``KERNEL_TOL`` plus what ReLU's gate can add
    (``_float64_gaps``); the fp32 twin's gaps beside them."""
    c_in, side, k = HEAD_SHAPES[shape]
    (y, weight, keep, g), bn = dsn_epilogue_inputs(12, DSN_HIDDEN, side, side, k, P, mode, cuda_device)
    epi.reset_launches()
    results = {"kernels": _kernels(y, bn, weight, keep, P, g)}
    assert epi.launches == {"dsn_epilogue": 1}
    results["twin"] = _twin(y, bn, weight, keep, P, g)
    gaps, allowance = _float64_gaps(results, y, bn, weight, keep, P, g)
    print(shape, mode, "norm-relative gaps to float64:", gaps, "allowance:", allowance)
    over = {n: v for n, v in gaps["kernels"].items() if v > KERNEL_TOL + allowance[n]}
    assert not over, (over, allowance)


# (batch, channels, h, w, classes): a plane not a multiple of 4 pixels (the
# 4-byte loads), channels not a multiple of the backward's 128, one class,
# four classes
ODD_SHAPES = {"odd plane": (3, 40, 7, 9, 3), "200 channels": (2, 200, 12, 12, 2),
              "one class": (2, 64, 8, 8, 1), "four classes": (2, 64, 16, 16, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(ODD_SHAPES))
def test_kernels_equal_float64_at_other_shapes(cuda_device, case, mode):
    b, c, h, w, k = ODD_SHAPES[case]
    (y, weight, keep, g), bn = dsn_epilogue_inputs(b, c, h, w, k, P, mode, cuda_device)
    gaps = _gaps(_kernels(y, bn, weight, keep, P, g), _float64_head(y, bn, weight, keep, P, g))
    assert max(gaps.values()) <= KERNEL_TOL, gaps


@pytest.mark.cuda
def test_kernels_give_the_same_bits_twice(cuda_device):
    """Two forward and backward calls on the same inputs: the same bits in
    every output (no float atomics; sums in a fixed order)."""
    c_in, side, k = HEAD_SHAPES["odoc.head2"]
    (y, weight, keep, g), bn = dsn_epilogue_inputs(12, DSN_HIDDEN, side, side, k, P, "train", cuda_device)
    first, second = (_kernels(y, bn, weight, keep, P, g) for _ in range(2))
    assert all(torch.equal(first[n], second[n]) for n in first)


SHARD = (5, 64, 24, 3)  # batch, channels, side, classes: the ranks hold 3 and 2 images


def _sharded_epilogue_rank(rank, device, out):
    """The kernels on this rank's rows of one input under a two-rank data
    shard on the card; saves its aux, dy, parameter gradients and running
    buffers to ``out.<rank>``."""
    dev = torch.device(device)
    b, c, side, k = SHARD
    (y, weight, keep, g), bn = dsn_epilogue_inputs(b, c, side, side, k, P, "train", dev)
    shard = DataShard(dist.group.WORLD, rank, dist.get_world_size(), b)
    with data_shard(shard):
        got = _kernels(shard.rows(y), bn, weight, shard.rows(keep), P, shard.rows(g))
    torch.save({n: t.cpu() for n, t in got.items()}, f"{out}.{rank}")


@pytest.mark.cuda
def test_kernels_sum_over_a_data_shard(cuda_device, tmp_path):
    """Two ranks on the card, each with its rows of the batch: their aux and
    dy are the whole batch's rows, their running buffers the whole batch's,
    and their parameter gradients add up to the whole batch's."""
    out = str(tmp_path / "rank")
    spawn_ranks(_sharded_epilogue_rank, (out,), "gloo", ["cuda", "cuda"], timeout=300)
    b, c, side, k = SHARD
    (y, weight, keep, g), bn = dsn_epilogue_inputs(b, c, side, side, k, P, "train", cuda_device)
    want = {n: t.cpu() for n, t in _kernels(y, bn, weight, keep, P, g).items()}
    ranks = [torch.load(f"{out}.{rank}") for rank in range(2)]
    close = dict(rtol=1e-5, atol=1e-6)
    for name in ("aux", "dy"):
        torch.testing.assert_close(torch.cat([r[name] for r in ranks]), want[name], **close)
    for r in ranks:
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(r[name], want[name], **close)
    for name in ("dgamma", "dbeta", "dweight"):
        torch.testing.assert_close(ranks[0][name] + ranks[1][name], want[name], **close)


@pytest.mark.cuda
def test_launches_one_a_head_in_full_forwards_and_none_in_contrast_forwards(cuda_device):
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5, client_id=1)
    init_torch_default(model, torch.Generator().manual_seed(11))
    model.to(cuda_device).train()
    images = torch.rand(2, 64, 64, 3, device=cuda_device)
    counts = []
    for mode, kw in (("train", {}), ("train", {"heatmaps_only": True}), ("eval", {})):
        epi.reset_launches()
        with torch.set_grad_enabled(not kw):
            model.train(mode == "train")(images, **kw)
        counts.append(epi.launches["dsn_epilogue"])
    assert counts == [3, 0, 3]


@pytest.mark.cuda
def test_kernels_keep_two_fewer_maps_at_odocs_head3(cuda_device, monkeypatch):
    """ODOC's head 3 (batch 12, 16 -> 512 channels at 384^2) with its 3x3
    convolution: what its forward leaves held for the backward is below the
    composition's by at least two 512-channel maps (3.62 GB each: only y
    is kept), and the peak of its forward and backward is no higher. (The
    kernel route's peak comes in the 3x3 convolution's backward, which the
    routes share, so it falls by less.)"""
    c_in, side, k = HEAD_SHAPES["odoc.head3"]
    head = DSNHead(c_in, k).to(cuda_device).train()
    x = torch.randn(12, c_in, side, side, device=cuda_device)
    g = torch.randn(12, k, side, side, device=cuda_device)

    def measure():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        aux = head(x, torch.Generator(device=cuda_device).manual_seed(0))
        held = torch.cuda.memory_allocated() - base
        aux.backward(g)
        torch.cuda.synchronize()
        head.zero_grad(set_to_none=True)
        return held, torch.cuda.max_memory_allocated() - base

    new = measure()
    monkeypatch.setattr(epi, "dsn_epilogue", epi.dsn_epilogue_plain)
    old = measure()
    plane = 12 * DSN_HIDDEN * side * side * 4
    print("held after the forward, peak (GiB): kernels", [v / 2**30 for v in new],
          "composition", [v / 2**30 for v in old])
    assert old[0] - new[0] >= 2 * plane and new[1] <= old[1], (old, new)
