"""Waymo-protocol 3D detection metrics (the port's copy of
``yolov10_3d_tpu/eval/waymo_eval.py``, on the port's own
``eval/kitti_eval.py`` ``d3_box_overlap``).

A numpy implementation of the protocol of Waymo's metric config: per-class
3D IoU thresholds (VEHICLE 0.7, PEDESTRIAN/CYCLIST/SIGN 0.5), Hungarian
matching (scipy's ``linear_sum_assignment``), OBJECT_TYPE and RANGE
breakdowns ([0, 30), [30, 50), [50, inf) metres), difficulty levels L1/L2,
11 score cutoffs, and the heading-weighted APH beside AP.

Boxes are camera-frame 7-vectors [x, y, z, l, h, w, ry] (location, dims,
heading), as in the KITTI evaluator, so the Waymo dataset's KITTI-format
prediction rows feed it directly.

As in the JAX module, the score cutoffs are the 11 quantiles of the
detection scores (not the proto library's cutoff search), and AP is the
precision-envelope integral over those samples.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .kitti_eval import d3_box_overlap

TYPE_NAMES = {0: "VEHICLE", 1: "PEDESTRIAN", 2: "CYCLIST", 3: "SIGN"}
IOU_PER_TYPE = {0: 0.7, 1: 0.5, 2: 0.5, 3: 0.5}
RANGES = ((0.0, 30.0), (30.0, 50.0), (50.0, float("inf")))


def _heading_accuracy(dt_ry: np.ndarray, gt_ry: np.ndarray) -> np.ndarray:
    """Waymo APH weight: 1 - min(|d|, 2pi - |d|) / pi per matched pair."""
    d = np.abs(dt_ry - gt_ry) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return 1.0 - d / np.pi


def _match_frame(gt_boxes: np.ndarray, dt_boxes: np.ndarray, iou_thr: float):
    """Hungarian matching (TYPE_HUNGARIAN) on 3D IoU; returns
    (dt_match_gt_idx (D,), ious (D,)) with -1 for unmatched."""
    D, G = len(dt_boxes), len(gt_boxes)
    out = np.full(D, -1, np.int64)
    iou_out = np.zeros(D)
    if D == 0 or G == 0:
        return out, iou_out
    iou = d3_box_overlap(gt_boxes, dt_boxes)  # (G, D)
    # zero sub-threshold pairs before the assignment (as the Waymo matcher
    # does): otherwise two below-threshold pairs can outscore one valid
    # match and suppress it
    iou = np.where(iou >= iou_thr, iou, 0.0)
    from scipy.optimize import linear_sum_assignment

    gi, di = linear_sum_assignment(-iou)
    for g, d in zip(gi, di):
        if iou[g, d] >= iou_thr:
            out[d] = g
            iou_out[d] = iou[g, d]
    return out, iou_out


def _pr_curves(
    scores: np.ndarray, matched: np.ndarray, heading_w: np.ndarray, num_gt: int,
    num_cutoffs: int = 11,
):
    """AP + APH from per-detection (score, matched?, heading weight)."""
    if num_gt == 0:
        return 0.0, 0.0, 0.0
    if len(scores) == 0:
        return 0.0, 0.0, 0.0
    cutoffs = np.quantile(scores, np.linspace(0, 1, num_cutoffs))
    recalls, precisions, precisions_h, recalls_h = [], [], [], []
    for c in cutoffs[::-1]:
        keep = scores >= c
        tp = float(matched[keep].sum())
        fp = float((~matched[keep]).sum())
        tph = float(heading_w[keep][matched[keep]].sum())
        if tp + fp == 0:
            continue
        recalls.append(tp / num_gt)
        precisions.append(tp / (tp + fp))
        recalls_h.append(tph / num_gt)
        precisions_h.append(tph / (tp + fp))
    if not recalls:
        return 0.0, 0.0, 0.0

    def integrate(rs, ps):
        rs = np.array([0.0] + rs)
        ps = np.array([ps[0]] + ps)
        # precision envelope
        for i in range(len(ps) - 2, -1, -1):
            ps[i] = max(ps[i], ps[i + 1])
        return float(np.sum((rs[1:] - rs[:-1]) * ps[1:]))

    ap = integrate(recalls, precisions)
    aph = integrate(recalls_h, precisions_h)
    # Recall@Precision>=0.95 (the config's recall_at_precision)
    r95 = max((r for r, p in zip(recalls, precisions) if p >= 0.95), default=0.0)
    return ap, aph, r95


def waymo_detection_metrics(
    gt_frames: Dict[int, Dict[str, np.ndarray]],
    dt_frames: Dict[int, Dict[str, np.ndarray]],
    iou_per_type: Optional[Dict[int, float]] = None,
    num_cutoffs: int = 11,
) -> Dict[str, float]:
    """gt_frames[fid] = {boxes7 (G,7), type (G,), difficulty (G,) in {1,2}};
    dt_frames[fid] = {boxes7 (D,7), type (D,), score (D,)}.
    Returns {"{TYPE}_L{level}/AP|APH|Recall@0.95", "RANGE_{TYPE}_[lo,hi)_L{level}/AP"}.
    """
    iou_per_type = iou_per_type or IOU_PER_TYPE
    out: Dict[str, float] = {}
    all_fids = sorted(set(gt_frames) | set(dt_frames), key=str)
    types = sorted(
        {int(t) for f in gt_frames.values() for t in np.asarray(f["type"]).tolist()}
        | {int(t) for f in dt_frames.values() for t in np.asarray(f["type"]).tolist()}
    )
    for typ in types:
        thr = iou_per_type.get(typ, 0.5)
        # per-frame matching once per type; breakdowns reuse the matches
        recs = []  # (score, matched, heading_w, gt_range, dt_range, gt_diff)
        gt_meta = []  # (range, difficulty) of every gt of this type
        for fid in all_fids:
            g = gt_frames.get(fid)
            d = dt_frames.get(fid)
            g_sel = (
                np.asarray(g["type"]) == typ if g is not None else np.zeros(0, bool)
            )
            d_sel = (
                np.asarray(d["type"]) == typ if d is not None else np.zeros(0, bool)
            )
            gb = np.asarray(g["boxes7"], np.float64)[g_sel] if g is not None else np.zeros((0, 7))
            db = np.asarray(d["boxes7"], np.float64)[d_sel] if d is not None else np.zeros((0, 7))
            gdiff = (
                np.asarray(
                    g.get("difficulty", np.ones(len(np.asarray(g["type"])))),
                    np.int64,
                )[g_sel]  # the default sized to the unfiltered frame
                if g is not None else np.zeros(0, np.int64)
            )
            score = np.asarray(d["score"], np.float64)[d_sel] if d is not None else np.zeros(0)
            m, _ = _match_frame(gb, db, thr)
            grange = np.sqrt(gb[:, 0] ** 2 + gb[:, 2] ** 2) if len(gb) else np.zeros(0)
            drange = np.sqrt(db[:, 0] ** 2 + db[:, 2] ** 2) if len(db) else np.zeros(0)
            hw = np.where(
                m >= 0, _heading_accuracy(db[:, 6], gb[m, 6]) if len(gb) else 0.0, 0.0
            )
            # matched dets inherit the gt's range/difficulty for breakdowns
            mrange = np.where(m >= 0, grange[m] if len(gb) else 0.0, drange)
            mdiff = np.where(m >= 0, gdiff[m] if len(gb) else 2, 2)
            for i in range(len(db)):
                recs.append((score[i], m[i] >= 0, hw[i], mrange[i], mdiff[i]))
            for i in range(len(gb)):
                gt_meta.append((grange[i], gdiff[i]))
        recs_arr = (
            np.array(recs, np.float64) if recs else np.zeros((0, 5), np.float64)
        )
        gt_arr = np.array(gt_meta, np.float64) if gt_meta else np.zeros((0, 2))
        name = TYPE_NAMES.get(typ, f"TYPE{typ}")
        for level in (1, 2):
            lvl_gt = gt_arr[gt_arr[:, 1] <= level] if len(gt_arr) else gt_arr
            # L-level: dets matched to harder gts don't count as TP at L1
            sel = (recs_arr[:, 4] <= level) | (recs_arr[:, 1] == 0)
            r = recs_arr[sel]
            ap, aph, r95 = _pr_curves(
                r[:, 0], r[:, 1] > 0, r[:, 2], len(lvl_gt), num_cutoffs
            )
            out[f"{name}_L{level}/AP"] = ap
            out[f"{name}_L{level}/APH"] = aph
            out[f"{name}_L{level}/Recall@0.95"] = r95
            for lo, hi in RANGES:
                gsel = lvl_gt[(lvl_gt[:, 0] >= lo) & (lvl_gt[:, 0] < hi)] if len(lvl_gt) else lvl_gt
                dsel = r[(r[:, 3] >= lo) & (r[:, 3] < hi)]
                ap_r, aph_r, _ = _pr_curves(
                    dsel[:, 0], dsel[:, 1] > 0, dsel[:, 2], len(gsel), num_cutoffs
                )
                hi_s = "+inf" if hi == float("inf") else f"{int(hi)}"
                out[f"RANGE_{name}_[{int(lo)}, {hi_s})_L{level}/AP"] = ap_r
                out[f"RANGE_{name}_[{int(lo)}, {hi_s})_L{level}/APH"] = aph_r
    return out


def kitti_rows_to_frames(
    results: Dict[str, List]
) -> Dict[int, Dict[str, np.ndarray]]:
    """KITTI-style prediction rows (``data/kitti.py`` ``decode_preds``:
    [cls, alpha, x1, y1, x2, y2, h, w, l, x, y, z, ry, score]) -> Waymo
    frames (the ground-truth frames come from ``data/waymo.py``)."""
    frames = {}
    for fname, rows in results.items():
        fid = int(str(fname).split(".")[0])
        rows = np.asarray(rows, np.float64).reshape(-1, 14)
        boxes7 = np.stack(
            [rows[:, 9], rows[:, 10], rows[:, 11], rows[:, 8], rows[:, 6], rows[:, 7], rows[:, 12]],
            -1,
        ) if len(rows) else np.zeros((0, 7))
        frames[fid] = {
            "boxes7": boxes7,
            "type": rows[:, 0].astype(np.int64) if len(rows) else np.zeros(0, np.int64),
            "score": rows[:, 13] if len(rows) else np.zeros(0),
            "difficulty": np.ones(len(rows), np.int64),
        }
    return frames
