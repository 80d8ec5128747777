"""The port's paths on the card, from the losses to a client's local round:
the card against the CPU, the kernel route against the plain route, and
what a round launches, trains and keeps, at the tasks' full widths.

Every test here is marked ``cuda`` and skips without a card. This file
imports no JAX (the card's machine has none); the README names the command
that runs every card test.
"""

import functools
import math

import numpy as np
import pytest
import torch

from torch_card import (BATCH, IMG, TREE_SIGMA, ZERO_COUNTS, cuda_device, dense_crf_inputs,  # noqa: F401
                        free_the_card, kernel_counts, main_path_setup, reset_kernel_counts,
                        serpentine_weights, smooth_images, tree_guides, tree_on_counts)

pytestmark = pytest.mark.cuda


# ---- the card against the CPU ------------------------------------------------


def test_small_objective_on_the_card_equals_the_cpu(cuda_device, monkeypatch):
    """``ours_loss`` (tree term on) and then ``treeenergy_add`` on the same
    model at 2 x 32^2, on the card (the kernels) against the CPU (the plain
    twins): every scalar term at rtol 1e-4 / atol 1e-6 and ``out_conv``'s
    gradient at rtol 1e-3 / atol 1e-5. The launches show the route: the tree
    kernels and no plain filter on the card, the plain filter and no kernel
    on the CPU.

    The high trees' MSTs come from aux logits upsampled 4x, whose weights
    hold near-ties that each device's rounding breaks its own way, and a tie
    broken otherwise moves the gradient through the tree. So the CPU builds
    its trees from the card's MST weights, call for call."""
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.objective import ours_loss, treeenergy_add_loss
    from fedicra_torch.engine.trainer import init_client_state
    from fedicra_torch.losses import tree_energy
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", img_size=32, batch_size=2, tree_loss_weight=0.1)
    rng = np.random.default_rng(2)
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    label = np.where(rng.uniform(size=(2, 32, 32)) < 0.7, 3, rng.integers(0, 3, (2, 32, 32)))
    own_weights = tree_energy.mst_edge_weights
    card_weights, cpu_calls = [], []

    def card_weights_everywhere(guides, eu, ev):
        weights = own_weights(guides, eu, ev)
        if weights.is_cuda:
            card_weights.append(weights)
            return weights
        cpu_calls.append(weights.shape)
        return card_weights[len(cpu_calls) - 1].to(weights.device)

    monkeypatch.setattr(tree_energy, "mst_edge_weights", card_weights_everywhere)
    results = {}
    for device in (cuda_device, torch.device("cpu")):
        model = net_factory("unet_lc_multihead", in_chns=3, class_num=3,
                            dropout=(0.0,) * 5, dsn_dropout=0.0)
        init_client_state(model, cfg, seed=5, device=device)
        model.train()
        batch = {"image": torch.as_tensor(image, device=device),
                 "label": torch.as_tensor(label, device=device)}
        reset_kernel_counts()
        loss, metrics = ours_loss(model, batch, 1, cfg)
        loss.backward()
        counts = {"ours": kernel_counts()}
        reset_kernel_counts()
        _, add = treeenergy_add_loss(model, batch, 1, cfg.replace(procedure="treeenergy_add"))
        counts["treeenergy_add"] = kernel_counts()
        if device.type == "cpu":  # the four plain filters, forward and backward (treeenergy_add: forward)
            want = {"ours": {**ZERO_COUNTS, "tree_filter_fwd": 4, "tree_filter_bwd": 4},
                    "treeenergy_add": {**ZERO_COUNTS, "tree_filter_fwd": 4}}
        else:
            want = {"ours": tree_on_counts(1),
                    "treeenergy_add": {**tree_on_counts(1, gated_crf=0), "tree_bwd": 0}}
        assert counts == want, device
        results[device.type] = (
            {**{k: v.item() for k, v in metrics.items() if v.ndim == 0},
             **{f"treeenergy_add {k}": v.item() for k, v in add.items()}},
            model.decoder.out_conv.weight.grad.cpu())
    assert len(cpu_calls) == len(card_weights)
    (m_card, g_card), (m_cpu, g_cpu) = results["cuda"], results["cpu"]
    assert m_card["loss_tree"] > 0.0
    for k in m_cpu:
        assert math.isclose(m_cpu[k], m_card[k], rel_tol=1e-4, abs_tol=1e-6), (k, m_card[k], m_cpu[k])
    torch.testing.assert_close(g_card, g_cpu, rtol=1e-3, atol=1e-5)


def test_plain_tree_route_on_the_card_equals_the_cpu(cuda_device):
    """The plain tree route (PyTorch ops: the CPU's route, and
    ``host_offload=False`` on the card) at the main path's shape, on one
    step's four trees of 12 images: V - 1 edges an image; the MST and the
    Euler-tour tree of a low tree's image and of a 4x-upsampled guide's
    (whose weights hold many near-ties) equal the CPU's from the same
    weights; one image's filter on the first high tree against the CPU, y
    at rtol 1e-4 and dx and d logw at rtol 1e-3."""
    from fedicra_torch.losses.tree_energy import mst_edge_weights
    from fedicra_torch.ops.mst import boruvka_mst, grid_edges
    from fedicra_torch.ops.tree import TreeStructure, build_tree
    from fedicra_torch.ops.tree_filter import tree_filter_refine

    b, h, w, c = BATCH, IMG, IMG, 3
    V = h * w
    rng = np.random.default_rng(4)
    low, highs = tree_guides(cuda_device, rng, b, h, w, c)
    eu, ev = (torch.as_tensor(a, device=cuda_device).long() for a in grid_edges(h, w))
    dist = mst_edge_weights([low, *highs], eu, ev)
    sel = boruvka_mst(eu, ev, dist, V)
    struct = build_tree(eu, ev, sel, V)
    assert (sel.sum(dim=1) == V - 1).all()
    for k in (0, b):
        sel_cpu = boruvka_mst(eu.cpu(), ev.cpu(), dist[k].cpu(), V)
        assert torch.equal(sel_cpu, sel[k].cpu()), k
        tree_cpu = build_tree(eu.cpu(), ev.cpu(), sel_cpu[None], V)
        for name, a_cpu, a_card in zip(TreeStructure._fields, tree_cpu, struct):
            assert torch.equal(a_cpu[0], a_card[k].cpu()), (k, name)

    # the filter over the first high tree, its weights to the guide (4x upsampled)
    st = TreeStructure(*(a[b:2 * b] for a in struct))
    emb = highs[0].reshape(b, V, c).gather(1, st.dfs_vertices[..., None].expand(-1, -1, c))
    parent_emb = emb.gather(1, st.parent_pos[..., None].expand(-1, -1, c))
    logw = (-((emb - parent_emb) ** 2).sum(-1)).requires_grad_(True)
    x = torch.softmax(torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32),
                                      device=cuda_device), -1).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=cuda_device)
    y = tree_filter_refine(x, logw, st.parent_pos, st.size)
    dx, dlogw = torch.autograd.grad(y, (x, logw), g)
    cpu = [t[:1].detach().cpu() for t in (x, logw, st.parent_pos, st.size, g)]
    xc, lc = cpu[0].requires_grad_(True), cpu[1].requires_grad_(True)
    yc = tree_filter_refine(xc, lc, cpu[2], cpu[3])
    dxc, dlc = torch.autograd.grad(yc, (xc, lc), cpu[4])
    torch.testing.assert_close(y[:1].detach().cpu(), yc.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dx[:1].cpu(), dxc, rtol=1e-3, atol=1e-4 * dxc.abs().max().item())
    torch.testing.assert_close(dlogw[:1].cpu(), dlc, rtol=1e-3, atol=1e-4 * dlc.abs().max().item())


def test_dense_crf_loss_on_the_card(cuda_device):
    """``dense_crf_loss`` at the headline shape (12 x 384^2 inputs, N = 192^2
    after its downscale), forward and backward: two Gaussian-filter launches
    (forward, VJP), a finite loss and a finite, non-zero gradient; at
    2 x 32^2 the loss on the card against the CPU's (the twin) at rtol 1e-4,
    its gradient at rtol 1e-3."""
    from fedicra_torch.losses.dense_crf import dense_crf_loss
    from fedicra_torch.ops import gaussian_filter_cuda as gf

    images, logits, rois = dense_crf_inputs(cuda_device)
    lg = logits.clone().requires_grad_(True)
    gf.reset_launches()
    loss = dense_crf_loss(images, torch.softmax(lg, -1), rois)
    loss.backward()
    torch.cuda.synchronize()
    assert gf.launches == {"gaussian_filter": 2}
    assert torch.isfinite(loss) and torch.isfinite(lg.grad).all() and lg.grad.abs().max() > 0

    small = [t[:2, :32, :32] for t in (images, logits, rois)]
    results = []
    for device in (cuda_device, "cpu"):
        im, lo, ro = (t.to(device) for t in small)
        lo = lo.clone().requires_grad_(True)
        value = dense_crf_loss(im, torch.softmax(lo, -1), ro)
        value.backward()
        results.append((value.item(), lo.grad.cpu()))
    (v_card, g_card), (v_cpu, g_cpu) = results
    assert math.isclose(v_card, v_cpu, rel_tol=1e-4), (v_card, v_cpu)
    torch.testing.assert_close(g_card, g_cpu, rtol=1e-3, atol=1e-5 * g_cpu.abs().max().item())


def test_ensemble_uncertainty_on_the_card_equals_the_cpu(cuda_device):
    """``batch_uncertainty`` of full-width ``unet_lc_multihead`` on 12 x 384^2
    ODOC images, T = 8, on the card: the entropy in [-1e-5, ln 3]; on a
    2-image slice with the same draws, the card's equals the CPU's at rtol
    1e-4."""
    from fedicra_torch.engine.config import TrainConfig
    from fedicra_torch.engine.trainer import init_client_state
    from fedicra_torch.evaluation.uncertainty import batch_uncertainty, draw_uncertainty
    from fedicra_torch.models import net_factory

    cfg = TrainConfig.for_task("odoc", model="unet_lc_multihead", img_size=IMG, batch_size=BATCH)
    model = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5)
    state = init_client_state(model, cfg, device=cuda_device)
    images = torch.as_tensor(smooth_images(np.random.default_rng(6), BATCH, IMG, IMG), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    draws = draw_uncertainty(images.shape, 8, gen)
    value = batch_uncertainty(model, state.params, state.batch_stats, images, draws=draws).item()
    assert -1e-5 <= value <= math.log(3), value
    small = draw_uncertainty(images[:2].shape, 8, gen)
    card = batch_uncertainty(model, state.params, state.batch_stats, images[:2], draws=small).item()
    model_cpu = net_factory("unet_lc_multihead", in_chns=3, class_num=3, num_clients=5)
    cpu = batch_uncertainty(model_cpu, {k: v.cpu() for k, v in state.params.items()},
                            {k: v.cpu() for k, v in state.batch_stats.items()}, images[:2].cpu(),
                            draws=(small[0], small[1].cpu())).item()
    assert math.isclose(card, cpu, rel_tol=1e-4), (card, cpu)


def test_gated_crf_surface_on_the_card(cuda_device):
    """The full gated-CRF surface (plain PyTorch) at 12 x 384^2, radius 5:
    the Potts kernel with an all-ones ``mask_dst`` equals the CUDA kernel's
    loss (rtol 1e-5); masked, compatibility and two-kernel runs on one image
    equal the CPU's (rtol 1e-5); forward and backward with every option at
    once give a finite, non-zero gradient in under 8 GiB."""
    from fedicra_torch.losses.gated_crf import LIVE_KERNEL, gated_crf_loss, gated_crf_loss_auto

    b, c, r = BATCH, 3, 5
    rng = np.random.default_rng(7)
    image = torch.as_tensor(smooth_images(rng, b, IMG, IMG), device=cuda_device)
    logits = torch.as_tensor(rng.normal(size=(b, IMG, IMG, c)).astype(np.float32), device=cuda_device)
    probs = torch.softmax(logits, -1)
    mask = rng.choice([1.0, 1.0, 1.0, 0.0, 0.5], size=(b, IMG, IMG)).astype(np.float32)
    mask[0, :4, :4] = np.nan
    mask = torch.as_tensor(mask, device=cuda_device)
    ones = torch.ones((b, IMG, IMG), device=cuda_device)

    kernel = gated_crf_loss_auto(probs, image, radius=r).item()
    general = gated_crf_loss(probs, image, radius=r, kernels_desc=[LIVE_KERNEL], mask_dst=ones).item()
    assert math.isclose(general, kernel, rel_tol=1e-5), (general, kernel)

    runs = {
        "masked": dict(mask_src=mask, mask_dst=mask.flip(1)),
        "compatibility": dict(compatibility=torch.tensor([[0.0, 1.0, 3.0], [2.0, 0.0, 0.5],
                                                          [1.0, 1.0, 0.0]])),
        "two kernels": dict(kernels_desc=[{"weight": 0.7, "xy": 4.0, "rgb": 0.2},
                                          {"weight": 0.3, "xy": 2.0}]),
    }
    for name, kw in runs.items():
        one = {k: (v[:1] if k.startswith("mask") else v) for k, v in kw.items()}
        on_card = gated_crf_loss(probs[:1], image[:1], radius=r, **one).item()
        on_cpu = gated_crf_loss(probs[:1].cpu(), image[:1].cpu(), radius=r,
                                **{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in one.items()}).item()
        assert math.isclose(on_card, on_cpu, rel_tol=1e-5), (name, on_card, on_cpu)

    full = dict(kernels_desc=runs["two kernels"]["kernels_desc"], mask_src=mask, mask_dst=mask.flip(1),
                compatibility=runs["compatibility"]["compatibility"])
    for name, kw in (("Potts, all-ones mask_dst", dict(kernels_desc=[LIVE_KERNEL], mask_dst=ones)),
                     ("two kernels, both masks, compatibility", full)):
        lg = logits.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gated_crf_loss(torch.softmax(lg, -1), image, radius=r, **kw).backward()
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert torch.isfinite(lg.grad).all() and lg.grad.abs().max() > 0, name
        assert peak < 8.0, (name, peak)


def test_lattice_dense_crf_against_the_exact_loss(cuda_device):
    """``dense_crf_loss_lattice`` (host C++) at the dense CRF's shape (12 x
    384^2 inputs, N = 192^2, d = 5, C = 3) against the exact loss and
    gradient from the Gaussian-filter kernel on the lattice's own downscaled
    inputs: the ratio in 0.3-1.7 and the gradients' cosine above 0.9
    (fedicra_tpu's bounds); the gradient finite and on the card."""
    from fedicra_torch.losses.dense_crf import dense_crf_loss_lattice, resize_nearest_floor
    from fedicra_torch.losses.tree_energy import resize_linear
    from fedicra_torch.ops import gaussian_filter_cuda as gf

    images, logits, rois = dense_crf_inputs(cuda_device)
    probs = torch.softmax(logits, -1)
    b, h, w, c = probs.shape
    oh, ow = h // 2, w // 2
    approx, d_probs = dense_crf_loss_lattice(images, probs, rois)
    img_s = resize_nearest_floor(images * 255.0, (oh, ow))
    rois_s = resize_nearest_floor(rois[..., None], (oh, ow))
    s = (resize_linear(probs, (oh, ow)) * rois_s).reshape(b, oh * ow, c).contiguous()
    Ks = gf.gaussian_filter_cuda(gf.bilateral_features(img_s, 15.0, 50.0).contiguous(), s)
    exact = (-2e-9 * (s.double() * Ks.double()).sum() / b).item()
    g_exact = ((-2.0 * 2e-9 / b) * rois_s.reshape(b, oh * ow, 1) * Ks).reshape(d_probs.shape)
    cos = ((g_exact.double() * d_probs.double()).sum()
           / (g_exact.double().norm() * d_probs.double().norm())).item()
    assert approx < 0 and exact < 0 and 0.3 < approx / exact < 1.7, (approx, exact)
    assert cos > 0.9 and torch.isfinite(d_probs).all() and d_probs.device == probs.device, cos


# ---- the tree chain's kernel route ------------------------------------------


def test_kernel_filters_equal_the_plain_route_on_a_steps_trees(cuda_device):
    """The tree filter by the kernels (``tree_filter_cuda.tree_filter``,
    autograd) against the plain route's (DFS order) on the same MSTs: one
    step's four trees of 12 images at the main path's shape, built as the
    objective builds them (``native_structures``). y at rtol 1e-4 and the
    gradients at rtol 1e-3 against the plain route in float64 on every tree,
    and against it in fp32 on the low and the first high tree: the fp32
    plain route drifts from exact with a tree's depth, through its log path
    products (~1e-4 on y of the 1x noise tree)."""
    from fedicra_torch.losses.tree_energy import mst_edge_weights, native_structures
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import grid_edges
    from fedicra_torch.ops.tree import build_tree
    from fedicra_torch.ops.tree_filter import tree_filter

    b, h, w, c = BATCH, IMG, IMG, 3
    V = h * w
    rng = np.random.default_rng(4)
    low, highs = tree_guides(cuda_device, rng, b, h, w, c)
    guides = [low, *highs]
    eu, ev = (torch.as_tensor(a, device=cuda_device).long() for a in grid_edges(h, w))
    sel = tfc.tree_mst(mst_edge_weights(guides, eu, ev), h, w)
    trees = native_structures(guides, TREE_SIGMA)
    x = torch.softmax(torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=cuda_device), -1)
    g = torch.as_tensor(rng.normal(size=(b, V, c)).astype(np.float32), device=cuda_device)
    plain = functools.partial(tree_filter, sigma=TREE_SIGMA)
    for k in range(4):
        low_tree = k == 0
        e = guides[k].reshape(b, V, -1).contiguous()
        struct = build_tree(eu, ev, sel[k * b:(k + 1) * b], V)
        outs = {}
        for route, filt, st, dt in (("kernels", tfc.tree_filter, trees[k], torch.float32),
                                    ("plain fp32", plain, struct, torch.float32),
                                    ("plain fp64", plain, struct, torch.float64)):
            xr, er = x.to(dt).requires_grad_(True), e.to(dt).requires_grad_(not low_tree)
            yr = filt(xr, er, st, low_tree=low_tree)
            grads = torch.autograd.grad(yr, [xr] if low_tree else [xr, er], g.to(dt))
            outs[route] = [yr.detach(), *grads]
        for ref in ("plain fp64", "plain fp32") if k < 2 else ("plain fp64",):
            want = outs[ref]
            got = [t.to(want[0].dtype) for t in outs["kernels"]]
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5, msg=f"tree {k}, y, {ref}")
            for a, w_ in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, w_, rtol=1e-3, atol=1e-4 * w_.abs().max().item(),
                                           msg=f"tree {k}, gradient, {ref}")


def test_a_path_shaped_tree_at_the_main_paths_size(cuda_device):
    """K1 and K2 on one image at 384^2 whose tree is a path of V levels of
    one vertex (``serpentine_weights``): the MST bit for bit
    ``boruvka_mst``'s, and the BFS arrays exactly the path's (order the
    serpentine, each position's parent the one before, child ranges one
    wide, V levels), which the twin would take all V levels to walk."""
    from fedicra_torch.ops import tree_filter_cuda as tfc
    from fedicra_torch.ops.mst import boruvka_mst, grid_edges

    h = w = IMG
    V = h * w
    weights = torch.as_tensor(serpentine_weights(h, w), device=cuda_device)[None].contiguous()
    eu, ev = (torch.as_tensor(a, device=cuda_device).long() for a in grid_edges(h, w))
    sel = tfc.tree_mst_cuda(weights, h, w)
    assert torch.equal(sel, boruvka_mst(eu, ev, weights, V))
    embed = torch.rand((1, V, 3), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    path = tfc.tree_root_cuda(sel, embed, h, w, 0, TREE_SIGMA)
    order = np.arange(V).reshape(h, w)
    order[1::2] = order[1::2, ::-1]
    order = torch.as_tensor(order.reshape(-1), dtype=torch.int32, device=cuda_device)
    q = torch.arange(V, dtype=torch.int32, device=cuda_device)
    parent = torch.empty_like(order)
    parent[order.long()] = torch.cat([order[:1], order[:-1]])
    want = {"order": order, "parent": parent, "ppos": (q - 1).clamp(min=0),
            "cptr": torch.cat([q + 1, q[-1:] + 1]).clamp(max=V), "level": torch.cat([q, q[-1:] + 1]),
            "n_levels": torch.tensor([V], dtype=torch.int32, device=cuda_device)}
    for field, a in want.items():
        got = getattr(path, field)[0]
        assert torch.equal(got, a.reshape(got.shape)), field


# ---- a client's local round -------------------------------------------------


def _round(dev, **setup):
    """One FedICRA "ours" round at full width (``main_path_setup``); returns
    what the checks read: the configuration, the states before, after the
    head phase and after the round, the metrics, the launches, and the
    dtypes of the first step's forwards (their outputs and every
    BatchNorm's input)."""
    import types

    import torch.nn.functional as F

    from fedicra_torch.ops import dsn_stats_cuda, gated_crf_cuda

    cfg, cid, model, state, round_fn, batches = main_path_setup(dev, **setup)
    snaps, dtypes = [], {}
    batch_norm = F.batch_norm

    def seen(name, t):
        dtypes.setdefault(name, set()).add(str(t.dtype).replace("torch.", ""))

    def hook(module, args, out):
        if "logits" in out:  # a contrast forward returns only features and heatmaps
            seen("logits", out["logits"])
        for key in ("features", "de", "aux"):
            for t in out.get(key, []):
                seen(key, t)
        for t in out.get("heatmaps", []):
            if t is not None:
                seen("heatmaps", t)

    def recording_batch_norm(x, *args, **kwargs):
        seen("batch_norm input", x)
        return batch_norm(x, *args, **kwargs)

    def stop_recording():
        handle.remove()
        F.batch_norm = batch_norm

    def on_step(j, metrics):
        if j == 0:
            stop_recording()
        if j == cfg.iters - cfg.rep_iters - 1:
            snaps.append({n: p.detach().clone() for n, p in model.named_parameters()})

    handle = model.register_forward_hook(hook)
    F.batch_norm = recording_batch_norm
    generator_state = state.generator.get_state()  # replays step 1's draws for the plain route
    reset_kernel_counts()
    dsn_stats_cuda.reset_launches()
    try:
        new, metrics = round_fn(state, batches, cid, on_step=on_step)
    finally:
        stop_recording()
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        cfg=cfg, cid=cid, model=model, state=state, new=new, head_end=snaps[0], metrics=metrics,
        batches=batches, generator_state=generator_state, counts=kernel_counts(),
        by_dtype=dict(gated_crf_cuda.launches_by_dtype), dsn=dsn_stats_cuda.launches["dsn_stats"],
        dtypes=dtypes)


def _hold_round(run) -> None:
    """A round's losses, launches and parameters (``test_a_round_on_the_card``)."""
    from fedicra_torch.models.params_filters import is_dsn_head, is_head, is_pcs

    cfg, metrics = run.cfg, run.metrics
    iters, tree_on = cfg.iters, cfg.tree_loss_weight != 0.0
    losses = metrics["total_loss"].float().cpu()
    assert losses.shape == (iters,) and torch.isfinite(losses).all(), losses
    for k in ("loss_ce", "loss_tree", "loss_crf", "loss_lc"):
        assert torch.isfinite(metrics[k].float()).all(), k
    if tree_on:
        assert (metrics["loss_tree"] > 0).all(), metrics["loss_tree"]
    # 3 DSN heads in each of the K - 1 contrast forwards a step, none in the step's own forward
    assert run.dsn == 3 * (cfg.num_clients - 1) * iters
    assert run.counts == (tree_on_counts(iters) if tree_on else {**ZERO_COUNTS, "gated_crf": iters})
    assert run.by_dtype["bfloat16" if cfg.amp else "float32"] == iters, run.by_dtype
    before, after = run.state.params, run.new.params
    for n in before:
        assert not is_pcs(n) or torch.equal(before[n], after[n]), f"frozen PCS parameter {n} changed"
        assert not is_dsn_head(n) or torch.equal(before[n], after[n]) != tree_on, \
            f"DSN parameter {n} moved={not tree_on} at tree_loss_weight {cfg.tree_loss_weight}"
        assert before[n].dtype == after[n].dtype == torch.float32, n
        assert (not torch.equal(before[n], run.head_end[n])) == is_head(n), f"head phase: {n}"
    assert run.new.current_iter == iters


ROUNDS = {  # main_path_setup's arguments
    "odoc tree-off": dict(tree_loss_weight=0.0, iters=2, rep_iters=1),
    "odoc": {},
    "faz": dict(task="faz"),
    "polyp": dict(task="polyp"),
}


@pytest.mark.parametrize("tag", sorted(ROUNDS))
def test_a_round_on_the_card(cuda_device, tag):
    """A FedICRA "ours" local round at a task's full width, batch 12, fp32:
    ODOC with the tree term off (1 head and 1 body step) and on (2 and 2),
    FAZ's and Polyp's with it on (2 and 2). Finite losses, ``loss_tree``
    above 0 where the term is on; a step's launches: one gated CRF on fp32
    y, with the tree term one MST, one rooting and four filter launches each
    way and no plain filter; 3 DSN moment launches in each of a step's
    K - 1 contrast forwards. The head phase moves the head alone, PCS stays
    frozen, the DSN heads move only with the tree term on, and every
    parameter stays fp32. With the tree term on, the first step's
    ``loss_tree`` again on the plain route (``host_offload=False``: PyTorch
    ops, DFS-ordered filters) at rtol 1e-4, four plain filter runs and no
    kernel launch."""
    from fedicra_torch.engine.objective import _forward, _tree_loss

    run = _round(cuda_device, **ROUNDS[tag])
    _hold_round(run)
    if run.cfg.tree_loss_weight == 0.0:
        return
    model, state = run.model, run.state
    model.load_state_dict({**state.params, **state.batch_stats})
    model.train()
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(run.generator_state)
    images, labels = run.batches["image"][0].float(), run.batches["label"][0].long()
    reset_kernel_counts()
    with torch.no_grad():
        out = _forward(model, images, run.cid, run.cfg, generator)
        plain = _tree_loss(out, images, labels, run.cfg, recursive=True, host_offload=False).item()
    assert kernel_counts() == {**ZERO_COUNTS, "tree_filter_fwd": 4}
    kernel_route = run.metrics["loss_tree"][0].item()
    assert math.isclose(plain, kernel_route, rel_tol=1e-4), (kernel_route, plain)


def test_a_treeenergy_add_step_at_the_main_paths_shape(cuda_device):
    """One step of the ``treeenergy_add`` objective (pCE and the additive
    multi-scale tree term; no gated CRF, no contrast term) at the main
    path's shape from the round's starting weights and first batch: finite
    losses and gradients, the tree term above 0, one MST and one rooting
    launch and four filter launches each way."""
    from fedicra_torch.engine.objective import treeenergy_add_loss

    cfg, cid, model, state, _, batches = main_path_setup(cuda_device)
    model.load_state_dict({**state.params, **state.batch_stats})
    model.train()
    model.zero_grad(set_to_none=True)
    batch = {"image": batches["image"][0].float(), "label": batches["label"][0].long()}
    reset_kernel_counts()
    loss, metrics = treeenergy_add_loss(model, batch, cid, cfg.replace(procedure="treeenergy_add"),
                                        torch.Generator(device=cuda_device).manual_seed(0))
    loss.backward()
    torch.cuda.synchronize()
    values = {k: v.item() for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()) and values["loss_tree"] > 0, values
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert kernel_counts() == tree_on_counts(1, gated_crf=0)


def test_the_main_round_under_amp(cuda_device):
    """The main path's round under ``amp=True``: the round's checks
    (``test_a_round_on_the_card``) with its gated-CRF launches on bf16 y;
    the dtypes of its first step's forwards as JAX's AMP has them (bf16
    logits and heatmaps; fp32 features, decoder stages, DSN aux and every
    BatchNorm's input), a bf16 ``loss_ce`` and an fp32 ``total_loss``; its
    first loss within 5% of the fp32 round's from the same weights, batches
    and dropout draws."""
    fp32 = _round(cuda_device).metrics["total_loss"][0].item()
    run = _round(cuda_device, amp=True)
    _hold_round(run)
    assert run.dtypes == {"logits": {"bfloat16"}, "heatmaps": {"bfloat16"}, "features": {"float32"},
                          "de": {"float32"}, "aux": {"float32"}, "batch_norm input": {"float32"}}
    assert run.metrics["loss_ce"].dtype == torch.bfloat16
    assert run.metrics["total_loss"].dtype == torch.float32
    first = run.metrics["total_loss"][0].item()
    assert abs(first - fp32) <= 0.05 * abs(fp32), (first, fp32)
