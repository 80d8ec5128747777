"""Offline test CLI: per-case CSVs and prediction/GT PNGs from a checkpoint.

Counterpart of ``fedicra_tpu/cli/test.py`` (the reference's test.py):
- metrics per case: dice, jaccard, HD95, ASSD, SE (sensitivity == recall),
  SP, Rec, Pre — 8 columns; ODOC gets _cup (exact class 1) and _disc
  (union >= 1) column groups;
- empty predictions get a 5-pixel dot at (192, 192) before the metrics;
- outputs: result.csv (per case), mean_std_result.csv, and pred/gt PNGs
  (x85 grey levels for ODOC, x127 for binary tasks);
- the test-time client naming shift: ``client0`` is training's ``client1``.

The CSVs are written with the ``csv`` module and the PNGs by a small
greyscale writer on ``zlib``, so the CLI needs neither pandas nor OpenCV;
their columns, rows and pixels are the JAX CLI's. ``--device`` (new) names
the device; by default the CUDA card.

Usage:
  python -m fedicra_torch.cli.test --root_path ../data --img_class odoc \\
      --client client0 --exp myrun --model unet_lc_multihead
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import shutil
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def offline_client_to_train_client(client: str) -> str:
    """test.py's client0..clientN-1 -> training's client1..clientN."""
    if client == "client_all":
        return client
    return f"client{int(client[len('client'):]) + 1}"


def _draw_fallback_dot(pred: np.ndarray) -> np.ndarray:
    """``cv2.circle(pred, (192, 192), 1, 1, -1)`` on an empty prediction:
    the centre and its 4 neighbours (reference test.py:227-234)."""
    if pred.sum() == 0:
        p = pred.astype(np.uint8).copy()
        y, x = 192, 192
        h, w = p.shape[:2]
        for dy, dx in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < h and 0 <= xx < w:
                p[yy, xx] = 1
        return p
    return pred


def case_metrics(pred, gt, device=None) -> Dict[str, float]:
    """8 offline metrics (dice, jaccard, HD95, ASSD, SE, SP, Rec, Pre) of two
    binary masks (numpy arrays or tensors), computed on ``device`` (default
    the CPU)."""
    from ..evaluation.metrics import (
        dice as m_dice,
        jaccard as m_jc,
        precision as m_pre,
        recall as m_rec,
        specificity as m_sp,
        surface_distances,
    )

    p = (torch.as_tensor(np.asarray(pred), device=device) > 0).float()
    g = (torch.as_tensor(np.asarray(gt), device=device) > 0).float()
    if p.sum() == 0:
        return dict(dice=0.0, jaccard=0.0, HD95=0.0, ASSD=0.0, SE=0.0, SP=0.0,
                    Rec=0.0, Pre=0.0)
    sd = surface_distances(p, g)
    rec = float(m_rec(p, g))
    return dict(
        dice=float(m_dice(p, g)),
        jaccard=float(m_jc(p, g)),
        HD95=float(sd["hd95"]),
        ASSD=float(sd["assd"]),
        SE=rec,  # medpy sensitivity == recall
        SP=float(m_sp(p, g)),
        Rec=rec,
        Pre=float(m_pre(p, g)),
    )


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit greyscale PNG of a 2-D uint8 array (no filter, zlib level 6)."""
    a = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = a.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def run_inference(
    model,
    params,
    batch_stats,
    images: np.ndarray,
    case_names: List[str],
    labels: np.ndarray,
    img_class: str,
    test_save_path: str,
    emb_idx: Optional[int] = None,
    device=None,
) -> Dict[str, List[float]]:
    """Predict each case in eval mode, write its pred/gt PNGs and return the
    metric columns (``name`` first)."""
    from ..device import resolve_device
    from ..evaluation.evaluate import predict_labels

    device = resolve_device(device)
    os.makedirs(os.path.join(test_save_path, "pre"), exist_ok=True)
    rows: Dict[str, List] = {"name": []}
    scale = 85.0 if img_class == "odoc" else 127.0
    for i, case in enumerate(case_names):
        img = torch.as_tensor(images[i:i + 1], device=device)
        emb = None
        if emb_idx is not None:
            emb = torch.full((1,), emb_idx, dtype=torch.long, device=device)
        pred = predict_labels(model, params, batch_stats, img, emb_idx=emb)[0].cpu().numpy()
        gt = labels[i]
        item = case.split("/")[-1].split(".")[0]
        write_png(os.path.join(test_save_path, "pre", item + "_pred.png"),
                  (pred * scale).astype(np.uint8))
        write_png(os.path.join(test_save_path, "pre", item + "_gt.png"),
                  (gt * scale).astype(np.uint8))

        pred = _draw_fallback_dot(pred)
        rows["name"].append(case)
        if img_class == "odoc":
            groups = (("_cup", pred == 1, gt == 1), ("_disc", pred >= 1, gt >= 1))
        else:
            groups = (("", pred == 1, gt == 1),)
        for suffix, p, g in groups:
            for k, v in case_metrics(p, g, device).items():
                rows.setdefault(f"{k}{suffix}", []).append(v)
    return rows


def _cell(v) -> str:
    """A value as pandas' ``to_csv`` writes it: a NaN as an empty field."""
    if isinstance(v, float) and math.isnan(v):
        return ""
    return str(v)


def _write_table(path: str, columns: Dict[str, List]) -> None:
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*(columns[k] for k in names)):
            w.writerow([_cell(v) for v in row])


def write_csvs(rows: Dict[str, List[float]], test_save_path: str) -> None:
    """result.csv (one row a case) and mean_std_result.csv (mean, std)."""
    _write_table(os.path.join(test_save_path, "result.csv"), rows)
    stats = {"name": ["mean", "std"]}
    for k, v in rows.items():
        if k != "name":
            stats[k] = [float(np.mean(v)), float(np.std(v))]
    _write_table(os.path.join(test_save_path, "mean_std_result.csv"), stats)


def load_test_weights(snapshot_path: str, client: str, device=None) -> Tuple[dict, str]:
    """The weights to test ``client`` with: ({"params", "batch_stats"}, source).

    The reference's test.py loads the PER-CLIENT best model (saved for every
    client at its own best val dice); personalised strategies need it, since
    the aggregated model can be far worse than the client-adapted ones. So
    ``best_client_{cid}`` is loaded when present, else ``best_global`` (also
    for ``client_all`` and centralized runs). Prints which."""
    from ..device import resolve_device
    from ..utils.checkpoint import CheckpointManager

    device = resolve_device(device)
    ckpt = CheckpointManager(snapshot_path)
    if client != "client_all":
        cid = int(client[len("client"):])
        try:
            state = ckpt.restore_best_client(cid, map_location=device)
        except FileNotFoundError:
            pass
        else:
            print(f"init weight from best_client_{cid}")
            payload = {"params": state["params"], "batch_stats": state["batch_stats"]}
            return payload, f"best_client_{cid}"
    payload = ckpt.restore_best_global(map_location=device)
    print("init weight from best_global")
    return payload, "best_global"


def main(argv=None):
    """Run the CLI; returns the metric columns it wrote."""
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, required=True)
    p.add_argument("--img_class", type=str, default="odoc",
                   choices=["odoc", "faz", "polyp"])
    p.add_argument("--client", type=str, default="client0")
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--model", type=str, default="unet_lc_multihead")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--in_chns", type=int, default=None)
    p.add_argument("--snapshot_root", type=str, default="../model")
    p.add_argument("--device", type=str, default=None,
                   help="device to run on (default: the CUDA card), e.g. 'cpu'")
    args = p.parse_args(argv)

    from ..data.h5io import load_client_split
    from ..device import resolve_device
    from ..engine.config import TASKS
    from ..models import LC_MODELS, net_factory

    device = resolve_device(args.device)
    task = TASKS[args.img_class]
    num_classes = args.num_classes or task["num_classes"]
    in_chns = args.in_chns or task["in_chns"]
    num_clients = len(task["sup_types"])

    root = os.path.join(args.root_path, task["root_subdir"])
    split = load_client_split(root, offline_client_to_train_client(args.client), "val", "mask")

    model = net_factory(args.model, in_chns=in_chns, class_num=num_classes,
                        num_clients=num_clients).to(device)
    payload, _ = load_test_weights(
        os.path.join(args.snapshot_root, args.exp), args.client, device
    )

    test_save_path = os.path.join(args.snapshot_root, f"{args.exp}_test", args.client)
    if os.path.exists(test_save_path):
        shutil.rmtree(test_save_path)
    os.makedirs(test_save_path)

    emb = None
    if args.model in LC_MODELS and args.client != "client_all":
        emb = int(args.client[len("client"):])
    rows = run_inference(
        model, payload["params"], payload["batch_stats"], split.images,
        split.case_names, split.labels, args.img_class, test_save_path,
        emb_idx=emb, device=device,
    )
    write_csvs(rows, test_save_path)
    key = "dice_cup" if args.img_class == "odoc" else "dice"
    print(f"avg dice: {np.mean(rows[key]):.4f}")
    return rows


if __name__ == "__main__":
    main()
