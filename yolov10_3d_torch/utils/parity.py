"""Parity harness: give random weights realistic activations, and compare two
detection lists that may differ by float rounding.

Untrained weights with identity BatchNorm statistics shrink activations layer
by layer, so every class score sits at 0.5 and top-k order is decided by
rounding. ``calibrate`` sets each BatchNorm's running statistics from its
input on a calibration batch and rescales the head's output convs (DFL bin j
centred at -j/2, so boxes span a few strides as a trained model's do, rather
than the frame; class logits between -2 and +2; for the 3D head each
regression branch to the mean and spread of ``HEAD3D_TARGETS``), which
spreads the scores the way a trained model's are spread. A random net is
chaotic, so the calibration batch is the images that are then served
(``smooth_images`` makes them: pixel noise would make the served scores
hinge on resize details).
``match_detections`` pairs detections by class and box and compares those
clear of the selection boundaries, where the selection cannot flip;
``compare_kitti_rows`` does the same for the 3D validator's KITTI rows;
``summary_results`` turns a server's JSON rows back into a Results for them.
"""

from __future__ import annotations

import contextlib
import math
import struct
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.preprocess import _linear_taps, _resample
from ..nn.heads3d import BRANCHES, V10Detect3d

# 3D regression branches after calibration: (mean, std) of every channel.
# Offsets within a cell, 2D sizes of a few strides, depths of tens of metres.
HEAD3D_TARGETS = {"o2d": (0.0, 0.5), "s2d": (4.0, 1.0), "o3d": (0.0, 0.5), "s3d": (0.0, 0.5),
                  "hd": (0.0, 1.0), "dep": (20.0, 5.0), "dep_un": (0.0, 1.0)}


@torch.no_grad()
def calibrate(model: nn.Module, x: torch.Tensor, bn_std: float = 0.5,
              cls_mean: float = -2.0, cls_max: float = 2.0, int8=None) -> nn.Module:
    """Calibrate a YOLOModel on ``x`` (B, 3, H, W), in eval mode.

    One forward sets each BatchNorm's running statistics from its own input,
    layer after layer, so that it normalises that input to mean 0 and std
    ``bn_std``, and every later layer sees calibrated inputs. A random net
    amplifies float rounding layer by layer; at std 0.5 the one2one maps of
    yolov10n differ from the JAX package's by a quarter of what they do at
    std 1. A second forward rescales each head output conv: box logits (DFL
    bin j) per channel to std 1 and mean -j/2; class logits to mean
    ``cls_mean`` and, with one scale for all classes, batch maximum
    ``cls_max``. The class logits of a random net are heavy-tailed, so unit
    variance lets the top scores saturate at 1.0 and tie; pinning the maximum
    keeps every served score below sigmoid(cls_max), on the slope. A v8
    task head's extra maps (``cv4``: mask coefficients, keypoints, angles)
    go to mean 0 per channel and, with one scale for all channels, a pooled
    std of 1 (a channel of a random net with a tiny spread, scaled alone,
    would amplify rounding past the parity bars).

    ``int8`` (an ``nn.quant.Int8Config``) rescales the head on the outputs of
    that int8 forward instead, for serving in int8: the static activation
    scale quantizes a random net's activations coarsely (the [0, 1] image
    to 17 levels), and head scales fitted to the float outputs would
    saturate the int8 scores. The BatchNorm statistics still come from the
    float forward: an int8 conv applies its BatchNorm in the kernel, where
    no hook sees it.

    Both forwards run the plain route (no fused stem, a dense 3D head): the
    serving routes fold the BatchNorms away, where no hook sees them. The
    fused stem's folded weights are rebuilt when next served (they are keyed
    on the tensors' versions); the sparse head folds on every call."""
    model.eval()

    def set_stats(bn, inp):
        t = inp[0]
        bn.running_mean.copy_(t.mean((0, 2, 3)))
        bn.running_var.copy_(t.var((0, 2, 3), unbiased=False) / bn_std**2)

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    try:
        model(x, fast_eval=False)
    finally:
        for h in hooks:
            h.remove()

    head = model.model[model.spec.head_index]
    outs = []  # (output conv, target mean per channel, target std; None: class logits;
    # "pooled": one std over all channels)
    if isinstance(head, V10Detect3d):
        for j, name in enumerate(BRANCHES):
            mean, std = HEAD3D_TARGETS.get(name, (cls_mean, None))
            for seq in (*getattr(head, name), *head.o2m_heads[j]):
                conv = seq[-1]
                outs.append((conv, torch.full((conv.out_channels,), mean,
                                              device=conv.weight.device), std))
    else:
        for name in ("cv2", "cv3", "one2one_cv2", "one2one_cv3", "cv4"):
            for seq in getattr(head, name, ()):
                conv = seq[-1]
                if name == "cv4":  # a v8 task's extra maps: mean 0, one std 1 for all
                    target, std = (torch.zeros(conv.out_channels, device=conv.weight.device),
                                   "pooled")
                elif name.endswith("cv3"):
                    target, std = torch.full((conv.out_channels,), cls_mean,
                                             device=conv.weight.device), None
                else:  # 4 sides x reg_max bins
                    bins = torch.arange(conv.out_channels, device=conv.weight.device)
                    target, std = -0.5 * (bins % (conv.out_channels // 4)).float(), 1.0
                outs.append((conv, target, std))
    seen = {}
    hooks = [conv.register_forward_hook(lambda mod, i, o: seen.__setitem__(mod, o))
             for conv, _, _ in outs]
    try:
        model(x, fast_eval=False, int8=int8)
    finally:
        for h in hooks:
            h.remove()
    for conv, target, std in outs:
        y = seen[conv]
        mu = y.mean((0, 2, 3))
        if std is None:  # class logits, one scale for all classes: the batch max -> cls_max
            sd = ((y - mu[:, None, None]).amax() / (cls_max - cls_mean)).clamp_min(1e-6)
            sd = sd.expand_as(mu)
        elif std == "pooled":  # one scale for all channels: their pooled std -> 1
            sd = (y - mu[:, None, None]).std().clamp_min(1e-6).expand_as(mu)
        else:
            sd = y.std((0, 2, 3)).clamp_min(1e-6) / std
        conv.weight.div_(sd[:, None, None, None])
        conv.bias.copy_((conv.bias - mu) / sd + target)
    return model


@torch.no_grad()
def o2m_near_o2o(model: nn.Module, rel: float = 0.02, seed: int = 0) -> nn.Module:
    """Set a v10Detect3d head's one2many branches to its one2one branches
    (the trainer's init copies them) with every conv weight scaled by
    1 + ``rel`` * N(0, 1): the two branches of a trained net predict nearby
    boxes, so the validator's one2many depth fusion finds clusters, as it
    does not on independent random branches."""
    head = model.model[-1]
    if not isinstance(head, V10Detect3d):
        raise ValueError("o2m_near_o2o needs a v10Detect3d head")
    g = torch.Generator().manual_seed(seed)
    for j, name in enumerate(BRANCHES):
        for dst, src in zip(head.o2m_heads[j].modules(), getattr(head, name).modules()):
            if isinstance(dst, nn.Conv2d):
                noise = torch.randn(src.weight.shape, generator=g).to(src.weight)
                dst.weight.copy_(src.weight * (1 + rel * noise))
                if src.bias is not None:
                    dst.bias.copy_(src.bias)
            elif isinstance(dst, nn.BatchNorm2d):
                dst.load_state_dict(src.state_dict())
    return model


def smooth_images(rng: np.random.Generator, shapes, cell: int = 8):
    """Seeded HWC uint8 images of the given (h, w): coarse noise, one value
    per ``cell`` x ``cell`` block, bilinearly upsampled. The upsampling
    takes the edge pixel with weight 1 outside the source on both axes (cv2
    does so on the columns only, ``resize_linear``): these are the frames
    every parity test's and card probe's bars were set on, and they stay
    the same bytes."""
    out = []
    for h, w in shapes:
        coarse = rng.integers(0, 256, (max(h // cell, 2), max(w // cell, 2), 3), dtype=np.uint8)
        out.append(_resample(coarse, _linear_taps(w, coarse.shape[1], True),
                             _linear_taps(h, coarse.shape[0], True)))
    return out


def _png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an HWC uint8 image (filter 0)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def task_tree(root: Path, task: str, n: int = 8, hw: Tuple[int, int] = (96, 128),
              seed: int = 0, nc: int = 3, kpt_shape: Tuple[int, int] = (17, 3)) -> Path:
    """A seeded YOLO tree of ``n`` PNGs (h, w) = ``hw`` under ``root``
    (``images/``, ``labels/``) with a ``data.yaml``, in ``task``'s label
    format: "detect" boxes, "segment" polygons (ellipses of 8 to 24
    vertices), "pose" boxes with ``kpt_shape`` keypoints (visibility 0, 1
    or 2), "obb" DOTA corner quads (rotated rectangles; every third one
    axis-aligned). Each object is painted into the image. Returns the
    YAML's path."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = rng.integers(0, 120, 3)
        img = np.stack([(base[c] + (yy * (c + 1) + xx * (3 - c)) // 8) % 140 for c in range(3)],
                       -1).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            cls = int(rng.integers(0, nc))
            cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
            a, b = rng.uniform(0.06, 0.2) * w, rng.uniform(0.06, 0.2) * h
            color = rng.integers(140, 256, 3)
            if task == "obb":
                r = 0.0 if len(lines) % 3 == 0 else rng.uniform(-np.pi / 2, np.pi / 2)
                dx = np.array([-a, a, a, -a])
                dy = np.array([-b, -b, b, b])
                px = cx + dx * np.cos(r) - dy * np.sin(r)
                py = cy + dx * np.sin(r) + dy * np.cos(r)
                inside = np.ones((h, w), bool)
                for k in range(4):  # left of every edge of the clockwise quad
                    ex, ey = px[(k + 1) % 4] - px[k], py[(k + 1) % 4] - py[k]
                    inside &= (ex * (yy - py[k]) - ey * (xx - px[k])) >= 0
                img[inside] = color
                pts = np.stack([px / w, py / h], -1).clip(0, 1)
                lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
                continue
            img[((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1] = color
            box = f"{cx / w:.6f} {cy / h:.6f} {2 * a / w:.6f} {2 * b / h:.6f}"
            if task == "segment":
                t = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(8, 25))))
                pts = np.stack([(cx + a * np.cos(t)) / w, (cy + b * np.sin(t)) / h], -1)
                lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in pts.clip(0, 1).reshape(-1)))
            elif task == "pose":
                nk, nd = kpt_shape
                kx = (cx + rng.uniform(-a, a, nk)) / w
                ky = (cy + rng.uniform(-b, b, nk)) / h
                cols = [kx, ky] + ([rng.integers(0, 3, nk).astype(float)] if nd == 3 else [])
                kp = " ".join(f"{v:.6f}" for v in np.stack(cols, -1).reshape(-1))
                lines.append(f"{cls} {box} {kp}")
            else:
                lines.append(f"{cls} {box}")
        (root / "images" / f"{i:04d}.png").write_bytes(_png(img))
        (root / "labels" / f"{i:04d}.txt").write_text("\n".join(lines) + "\n")
    names = "\n".join(f"  {i}: class{i}" for i in range(nc))
    extra = f"kpt_shape: [{kpt_shape[0]}, {kpt_shape[1]}]\n" if task == "pose" else ""
    (root / "data.yaml").write_text(
        f"path: {root}\ntrain: images\nval: images\n{extra}names:\n{names}\n")
    return root / "data.yaml"


@contextlib.contextmanager
def nms_margins():
    """Inside: every NMS (``ops/nms.py``, axis-aligned or rotated) that the
    entering thread runs also records, per image, its IoU decision margin:
    the least |m[i, j] - thr| over the pairs whose comparison decides, a
    kept candidate i before a candidate j that passes conf, with m the
    twin's pairwise matrix. Yields the list the margins are appended to, in
    call order. A margin under a comparison's bar means float rounding may
    flip a keep decision there."""
    from ..kernels import nms as KN
    from ..ops import boxes as B
    from ..ops import nms as N

    record: List[float] = []
    entries, owner = (N.nms_iou, N.nms_rotated), threading.get_ident()

    def margins(m, thr, keep, conf_ok):
        K = m.shape[1]
        later = torch.ones((K, K), dtype=torch.bool, device=m.device).triu(1)
        decides = keep[:, :, None] & conf_ok[:, None, :] & later
        gap = (m.double() - thr).abs().masked_fill(~decides, float("inf"))
        record.extend(gap.flatten(1).amin(1).tolist())

    def iou(boxes, thr, conf_ok):
        keep = entries[0](boxes, thr, conf_ok)
        if threading.get_ident() == owner:
            margins(B.box_iou_pairwise(boxes, boxes), thr, keep, conf_ok)
        return keep

    def rotated(rb, labels, thr, ok):
        keep = entries[1](rb, labels, thr, ok)
        if threading.get_ident() == owner:
            margins(KN.rotated_matrix(rb, labels, ok), thr, keep, ok)
        return keep

    N.nms_iou, N.nms_rotated = iou, rotated
    try:
        yield record
    finally:
        N.nms_iou, N.nms_rotated = entries


def task_labels(task: str, results, labels: Path, top: int = 3) -> None:
    """Rewrite the label file of each Result's image under ``labels`` from
    its ``top`` rows by score, in ``task``'s label format (``task_tree``'s):
    boxes; for "segment" each box as a rectangle polygon; for "pose" the
    box and its keypoints (visibility 2); for "obb" the rotated box's
    corners. Ground truth that a random net's own detections match."""
    for r in results:
        h, w = r.orig_shape
        lines = []
        if task == "obb":
            for j in np.argsort(-r.obb.conf)[:top]:
                q = (r.obb.xyxyxyxy[j] / np.array([w, h])).clip(0, 1)
                lines.append(f"{int(r.obb.cls[j])} " + " ".join(f"{v:.6f}" for v in q.reshape(-1)))
        else:
            b = r.boxes
            for j in np.argsort(-b.conf)[:top]:
                cx, cy, bw, bh = b.xywhn[j]
                tail = f"{cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                if task == "segment":
                    x1, y1, x2, y2 = cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2
                    tail = " ".join(f"{v:.6f}" for v in (x1, y1, x2, y1, x2, y2, x1, y2))
                elif task == "pose":
                    tail += "".join(f" {x / w:.6f} {y / h:.6f} 2"
                                    for x, y in r.keypoints.data[j][:, :2])
                lines.append(f"{int(b.cls[j])} {tail}")
        (Path(labels) / (Path(str(r.path)).stem + ".txt")).write_text("\n".join(lines) + "\n")


def _clear_of_cutoffs(scores: np.ndarray, conf: float, tol: float) -> np.ndarray:
    """Entries more than ``tol`` above both selection boundaries: the
    confidence threshold and the lowest score (the top-k cutoff). Only an
    entry near a boundary can be in one list and not the other."""
    if len(scores) == 0:
        return np.zeros(0, bool)
    return (scores - conf > tol) & (scores - scores.min() > tol)


def match_detections(
    ref: np.ndarray, got: np.ndarray, conf: float, score_tol: float, box_tol: float,
    cols: Optional[Dict[str, Tuple[slice, float]]] = None,
) -> Dict[str, float]:
    """Compare two (n, 6 + m) [x1, y1, x2, y2, score, cls, ...] lists of one
    image.

    Every entry of either list that is clear of the selection boundaries must
    have a partner in the other with the same class, the nearest box within
    ``box_tol`` px (max over the four coordinates) and the score within
    ``score_tol``; and, for each ``cols`` entry name -> (columns, bar), those
    columns within their bar (the 3D columns of ``Boxes3D``). Pairing is by
    (class, box), the stand-in for (class, anchor), never by rank, so ties in
    score do not matter; among equally near boxes (rows clipped to the same
    image edges) the nearest score pairs. Raises AssertionError otherwise. Returns the counts
    and the largest errors."""
    cols = cols or {}
    stats = {"n_ref": len(ref), "n_got": len(got), "n_compared": 0,
             "max_score_err": 0.0, "max_box_err": 0.0,
             **{f"max_{name}_err": 0.0 for name in cols}}
    for a, b, name in ((ref, got, "ref"), (got, ref, "got")):
        for i in np.flatnonzero(_clear_of_cutoffs(a[:, 4], conf, score_tol)):
            same = b[b[:, 5] == a[i, 5]]
            if len(same) == 0:
                raise AssertionError(f"{name}[{i}] class {a[i, 5]:.0f} has no partner")
            box_err = np.abs(same[:, :4] - a[i, :4]).max(1)
            # among equally near boxes (clipped to the same image edges), the nearest score
            tied = np.flatnonzero(box_err == box_err.min())
            j = int(tied[np.abs(same[tied, 4] - a[i, 4]).argmin()])
            score_err = abs(float(same[j, 4] - a[i, 4]))
            if box_err[j] > box_tol or score_err > score_tol:
                raise AssertionError(
                    f"{name}[{i}] {a[i].tolist()} vs nearest {same[j].tolist()}: "
                    f"box err {box_err[j]:.3g} (bar {box_tol}), "
                    f"score err {score_err:.3g} (bar {score_tol})"
                )
            for cname, (sl, tol) in cols.items():
                err = float(np.abs(same[j, sl] - a[i, sl]).max())
                if err > tol:
                    raise AssertionError(f"{name}[{i}] {a[i].tolist()} vs {same[j].tolist()}: "
                                         f"{cname} err {err:.3g} (bar {tol})")
                stats[f"max_{cname}_err"] = max(stats[f"max_{cname}_err"], err)
            stats["n_compared"] += 1
            stats["max_score_err"] = max(stats["max_score_err"], score_err)
            stats["max_box_err"] = max(stats["max_box_err"], float(box_err[j]))
    return stats


def summary_results(rows: List[Dict[str, Any]], shape: Sequence[int]):
    """A Results of an image of (h, w) ``shape`` from its ``summary()`` rows
    (a server's ``detections``), for ``compare_results``: ``boxes`` from
    box, confidence and class; with ``box3d`` rows also ``boxes3d``, whose
    projected centre (not in the rows) is 0."""
    from ..engine.results import Results

    boxes = np.array([[*(r["box"][k] for k in ("x1", "y1", "x2", "y2")), r["confidence"],
                       r["class"]] for r in rows], np.float64).reshape(-1, 6)
    boxes3d = None
    if rows and "box3d" in rows[0]:
        boxes3d = np.array([[*b, 0.0, 0.0, *r["box3d"]["hwl"], r["box3d"]["ry"],
                             *r["box3d"]["xyz"], r["box3d"]["depth_sigma"]]
                            for b, r in zip(boxes, rows)], np.float64)
    img = np.broadcast_to(np.uint8(0), (int(shape[0]), int(shape[1]), 3))
    return Results(img, boxes=boxes, boxes3d=boxes3d)


def compare_results(ref: Sequence, got: Sequence, conf: float, score_tol: float,
                    box_tol: float, cols: Optional[Dict[str, Tuple[slice, float]]] = None
                    ) -> Dict[str, float]:
    """``match_detections`` over two lists of Results; summed counts, max
    errors. With ``cols`` the rows compared are ``boxes3d.data``."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(ref)} vs {len(got)} results")
    total: Dict[str, float] = {"n_ref": 0, "n_got": 0, "n_compared": 0, "max_score_err": 0.0,
                               "max_box_err": 0.0}
    for r, g in zip(ref, got):
        a, b = (x.boxes3d.data if cols else x.boxes.data for x in (r, g))
        s = match_detections(np.asarray(a, np.float64), np.asarray(b, np.float64), conf,
                             score_tol, box_tol, cols)
        for k, v in s.items():
            total[k] = total.get(k, 0) + v if k.startswith("n_") else max(total.get(k, 0.0), v)
    return total


def _wrap(a: np.ndarray) -> np.ndarray:
    """Angles to (-pi, pi]."""
    return np.pi - np.mod(np.pi - a, 2 * np.pi)


def compare_kitti_rows(ref: Dict[str, Sequence], got: Dict[str, Sequence], score_tol: float,
                       box_tol: float, rel_tol: float, angle_tol: float,
                       ref_bins: Optional[Dict[str, Sequence[int]]] = None,
                       got_bins: Optional[Dict[str, Sequence[int]]] = None,
                       ref_centres: Optional[Dict[str, Sequence]] = None,
                       got_centres: Optional[Dict[str, Sequence]] = None,
                       lookup_hw: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
    """Compare two ``Detection3DValidator.results`` (image file -> KITTI rows
    [cls, alpha, x1, y1, x2, y2, h, w, l, x, y, z, ry, score]), with their
    heading bins (``Detection3DValidator.bins``).

    Each image must have the same number of rows and the same classes. Each
    ``ref`` row is paired with the ``got`` row of its class with the nearest
    2D box, and must meet:
    - 2D box within ``box_tol`` px;
    - score within ``score_tol`` + ``rel_tol`` * max(1, |ln score|) *
      score: the KITTI score is sigmoid(logit) * exp(-dep_un), the sigmoid
      held to ``score_tol`` and dep_un to ``rel_tol`` of max(1, |dep_un|)
      (|ln score| is |dep_un| where either is large; a random net puts
      dep_un 28 below 0 and the score at 1e12);
    - h, w, l within ``rel_tol`` relative (absolute below 1 m: a residual
      can bring a size near 0), depth z within ``rel_tol`` relative, x and
      y within ``rel_tol`` of z;
    - alpha and ry within ``angle_tol`` (mod 2 pi) where the two rows have
      the same heading bin (every pair when no bins are given); pairs whose
      bins differ are counted in ``n_bin_flips``;
    - with the rows' projected 3D centres (``Detection3DValidator.centres``)
      and the ``use_dino_depth`` map's size ``lookup_hw``: the centres within
      ``box_tol`` px. Where the two centres straddle a pixel edge, the two
      rows read their depths from neighbouring pixels of the teacher's map
      (``engine/validator3d.py`` ``dino_pixel``). Such pairs are counted in
      ``n_lookup_flips``, and their depth and x/y checks are skipped: x and
      y are the depth along the centre's ray.
    Raises AssertionError otherwise; returns the counts and largest errors."""
    from ..engine.validator3d import dino_pixel

    stats = {"n_rows": 0, "n_bin_flips": 0, "n_lookup_flips": 0}
    if set(ref) != set(got):
        raise AssertionError(f"image files differ: {sorted(set(ref) ^ set(got))}")
    for name in sorted(ref):
        a = np.asarray(ref[name], np.float64).reshape(-1, 14)
        b = np.asarray(got[name], np.float64).reshape(-1, 14)
        if len(a) != len(b) or sorted(a[:, 0]) != sorted(b[:, 0]):
            raise AssertionError(f"{name}: {len(a)} rows of classes {sorted(a[:, 0])} vs "
                                 f"{len(b)} of {sorted(b[:, 0])}")
        bins_a = list(ref_bins[name]) if ref_bins else [0] * len(a)
        bins_b = list(got_bins[name]) if got_bins else [0] * len(b)
        free = np.ones(len(b), bool)
        for i, r in enumerate(a):
            cand = np.flatnonzero(free & (b[:, 0] == r[0]))
            box_err = np.abs(b[cand, 2:6] - r[2:6]).max(1)
            j = int(cand[box_err.argmin()])
            free[j] = False
            g = b[j]
            # name: (error, bar)
            checks = {
                "box_err": (float(box_err.min()), box_tol),
                "score_err": (abs(g[13] - r[13]), score_tol + rel_tol * abs(r[13]) * max(
                    1.0, abs(math.log(abs(r[13]))))),
                "score_rel_err": (abs(g[13] - r[13]) / abs(r[13]), np.inf),
                "dim_rel_err": (float((np.abs(g[6:9] - r[6:9]) / np.maximum(np.abs(r[6:9]), 1)
                                       ).max()), rel_tol),
                "depth_rel_err": (abs(g[11] - r[11]) / abs(r[11]), rel_tol),
                "xy_err_over_z": (float(np.abs(g[9:11] - r[9:11]).max() / abs(r[11])), rel_tol),
            }
            if lookup_hw is not None:
                ca = np.asarray(ref_centres[name][i], np.float64)
                cb = np.asarray(got_centres[name][j], np.float64)
                checks["centre_err"] = (float(np.abs(cb - ca).max()), box_tol)
                if tuple(map(int, dino_pixel(ca, lookup_hw))) != tuple(
                        map(int, dino_pixel(cb, lookup_hw))):
                    stats["n_lookup_flips"] += 1
                    del checks["depth_rel_err"], checks["xy_err_over_z"]
            if bins_a[i] != bins_b[j]:
                stats["n_bin_flips"] += 1
            else:
                checks["angle_err"] = (max(abs(float(_wrap(g[k] - r[k]))) for k in (1, 12)),
                                       angle_tol)
            for k, (err, bar) in checks.items():
                if not err <= bar:
                    raise AssertionError(f"{name} row {i} {r.tolist()} vs {g.tolist()}: "
                                         f"{k} {err:.3g} (bar {bar:.3g})")
                stats[f"max_{k}"] = max(stats.get(f"max_{k}", 0.0), err)
            stats["n_rows"] += 1
    return stats
