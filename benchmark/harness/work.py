"""The work a step needs, counted from the configuration's shapes and
widths, and the card's memory bandwidth.

The counts never read what the port runs, so they read the same work
whatever implements it. The FLOP peak of each precision is in its file,
``precisions/<name>.json``; the bandwidth is one NVIDIA H100 SXM's, NVIDIA's
data sheet, at its full 700 W.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..reference.unet_lc import check_widths, head_sources

HBM_BYTES_PER_S = 3.35e12
FP32_PEAK_FLOPS = 67e12  # what the tree kernels' operations are held to


def model_convs(in_chns: int, num_classes: int, num_clients: int, img: int,
                widths: dict) -> List[Tuple[str, int, int, int, int]]:
    """Every convolution of one ``unet_lc_multihead`` forward of one image
    at the configuration's ``widths``: (name, C_in, C_out, kernel, output
    pixels)."""
    check_widths(widths)
    f, hidden = widths["features"], widths["dsn_hidden"]
    px = [(img >> s) ** 2 for s in range(5)]
    convs = [("encoder.in_conv.conv1", in_chns, f[0], 3, px[0]),
             ("encoder.in_conv.conv2", f[0], f[0], 3, px[0])]
    for i in range(1, 5):
        convs += [(f"encoder.down{i}.conv1", f[i - 1], f[i], 3, px[i]),
                  (f"encoder.down{i}.conv2", f[i], f[i], 3, px[i])]
    hid = max(f[4] // 16, 1)
    convs += [("pcs.fc1_a", num_clients, f[4], 1, 1), ("pcs.fc1_b", f[4], f[4], 1, 1),
              ("pcs.fc2_a.avg", 2 * f[4], hid, 1, 1), ("pcs.fc2_a.max", 2 * f[4], hid, 1, 1),
              ("pcs.fc2_b.avg", hid, f[4], 1, 1), ("pcs.fc2_b.max", hid, f[4], 1, 1)]
    for i in range(1, 5):
        low, skip = f[5 - i], f[4 - i]
        convs += [(f"decoder.up{i}.conv1x1", low, skip, 1, px[5 - i]),
                  (f"decoder.up{i}.conv1", 2 * skip, skip, 3, px[4 - i]),
                  (f"decoder.up{i}.conv2", skip, skip, 3, px[4 - i])]
    convs.append(("decoder.out_conv", f[0], num_classes, 3, px[0]))
    for i in head_sources(widths):
        convs += [(f"decoder.dsn_head{i}.conv", f[3 - i], hidden, 3, px[3 - i]),
                  (f"decoder.dsn_head{i}.out", hidden, num_classes, 1, px[3 - i])]
    return convs


def conv_flops(c_in: int, c_out: int, k: int, pixels: int) -> int:
    """A convolution's multiply-adds, two FLOPs each (bias adds not counted)."""
    return 2 * c_in * c_out * k * k * pixels


def forward_flops(in_chns: int, num_classes: int, num_clients: int, img: int, widths: dict) -> int:
    return sum(conv_flops(*c[1:]) for c in model_convs(in_chns, num_classes, num_clients, img, widths))


def step_flops(in_chns: int, num_classes: int, num_clients: int, img: int, batch: int,
               widths: dict) -> Dict[str, int]:
    """The model FLOPs of a head step and of a body step of FedICRA's round.

    Both run the client's own forward and K - 1 contrast forwards with no
    gradient. A head step adds the out conv's weight gradient. A body step
    adds the backward of the own forward: each convolution's input gradient
    but the first's and PCS's client branch (which reads no activation), and
    each trainable convolution's weight gradient (all but the out conv and
    PCS, which do not train in the body phase)."""
    convs = model_convs(in_chns, num_classes, num_clients, img, widths)
    fwd = sum(conv_flops(*c[1:]) for c in convs)
    no_input_grad = ("encoder.in_conv.conv1", "pcs.fc1_a", "pcs.fc1_b")
    frozen = ("decoder.out_conv", "pcs.")
    input_grad = sum(conv_flops(*c[1:]) for c in convs if c[0] not in no_input_grad)
    weight_grad = sum(conv_flops(*c[1:]) for c in convs if not c[0].startswith(frozen))
    head_wgrad = conv_flops(*next(c for c in convs if c[0] == "decoder.out_conv")[1:])
    return {"head": batch * (num_clients * fwd + head_wgrad),
            "body": batch * (num_clients * fwd + input_grad + weight_grad)}


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
