"""The work a step needs, counted from the configuration's model module,
shapes and widths, and the card's memory bandwidth.

The counts never read what the port runs, so they read the same work
whatever implements it. The FLOP peak of each precision is in its file,
``precisions/<name>.json``; the bandwidth is one NVIDIA H100 SXM's, NVIDIA's
data sheet, at its full 700 W.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from ..reference.fedicra_round import contrast_forwards, phases

HBM_BYTES_PER_S = 3.35e12
FP32_PEAK_FLOPS = 67e12  # what the tree kernels' operations are held to


def conv_flops(c_in: int, c_out: int, k: int, pixels: int, groups: int = 1) -> int:
    """A convolution's multiply-adds, two FLOPs each (bias adds not counted):
    each output reads C_in / groups input channels over its k x k window."""
    return 2 * (c_in // groups) * c_out * k * k * pixels


def forward_flops(model: ModuleType, config: dict) -> int:
    """One image's forward through the model module ``model``
    (``reference/models/``) at the configuration's widths and size."""
    return sum(conv_flops(*c[1:]) for c in model.convs(config))


def step_flops(model: ModuleType, config: dict) -> Dict[str, int]:
    """The model FLOPs of a step of each phase of the round, by the phase's
    label (``reference.fedicra_round.phases``), counted from the model
    module's convolutions.

    Every step runs the client's own forward and the contrast term's
    forwards with no gradient (K - 1 under FedICRA with a client-conditioned
    model). A step that trains only the head (FedICRA's head phase) adds its
    weight gradient: the out conv reads the last activation, so no input
    gradient is needed. Any other step adds the backward of its own forward:
    each convolution's input gradient but the first's and those of the
    module's ``CONSTANT_INPUT`` (which read no activation: PCS's client
    branch), and the weight gradient of each convolution the phase trains."""
    convs = model.convs(config)
    batch = config["train"]["batch_size"]
    fwd = sum(conv_flops(*c[1:]) for c in convs)
    no_input_grad = {convs[0][0], *getattr(model, "CONSTANT_INPUT", ())}
    input_grad = sum(conv_flops(*c[1:]) for c in convs if c[0] not in no_input_grad)
    names = [n for n, _, _ in model.param_specs(config)]
    out = {}
    for label, live, _, _ in phases(model, config, names):
        live = set(live)
        weight_grad = sum(conv_flops(*c[1:]) for c in convs if f"{c[0]}.weight" in live)
        head_only = all(model.is_head(n) for n in live)
        out[label] = batch * ((1 + contrast_forwards(model, config)) * fwd + weight_grad
                              + (0 if head_only else input_grad))
    return out


def bound_ms(ops: float, nbytes: float, peak_flops: float = FP32_PEAK_FLOPS) -> float:
    """The least time the card could take, the larger of the two bounds."""
    return max(ops / peak_flops, nbytes / HBM_BYTES_PER_S) * 1e3


def tree_chain_work(b: int, h: int, w: int, c: int, d: int, levels: int) -> Dict[str, Tuple[float, float]]:
    """(fp32 operations, bytes) that each tree kernel's function needs at
    least, for one step's four trees of ``b`` images each (guides of ``d``
    channels for the rooting; filters of ``c`` classes). ``levels`` is the
    sum of (BFS levels + 1) over the 4b images: the level offsets' words.

    A frozen copy of ``chip_smoke.tree_chain_work``. Bytes: each input read
    once and each output written once (int32 indices, fp32 values, a byte a
    mask entry). ``tree_mst`` reads the weights [N, E] and writes the mask;
    ``tree_root`` reads the mask and the guides and writes order, parent,
    ppos and w and the level offsets; ``tree_fwd`` reads x and the tree and
    writes y; ``tree_bwd`` (the filter's VJP) reads g, x and the tree and
    writes dx, and on a high tree also reads the guide and writes d embed.
    The filter rows are the mean of a step's four launches (the low tree and
    three high trees). Operations: an FMA counts two."""
    V, E, n = h * w, (h - 1) * w + h * (w - 1), 4 * b
    two_pass = lambda k: (V - 1) * 2 * k + (V - 1) * (2 + 3 * k)
    bwd_low = (b * (V * 3 * c + two_pass(2 * c)), b * 4 * (2 * V * c + 3 * V + V * c))
    edge = (b * ((V - 1) * (12 * c + 4) + (V - 1) * 2 * 3 * c), b * 4 * 2 * V * c)
    return {
        "tree_mst": (0, n * E * 5),
        "tree_root": (n * (V - 1) * (3 * d + 2), n * E + n * V * d * 4 + 4 * (4 * n * V + levels)),
        "tree_fwd": (b * (two_pass(c + 1) + V * c), b * 4 * (V * c + 3 * V + V * c)),
        "tree_bwd": tuple(lo + 3 * e / 4 for lo, e in zip(bwd_low, edge)),
    }


def tree_step_bound_ms(b: int, img: int, c: int, d: int, levels: int) -> float:
    """A step's tree-chain bound: one MST, one rooting, four filter forwards
    and four backwards, each bound on its own."""
    work = tree_chain_work(b, img, img, c, d, levels)
    launches = {"tree_mst": 1, "tree_root": 1, "tree_fwd": 4, "tree_bwd": 4}
    return sum(n * bound_ms(*work[k]) for k, n in launches.items())
