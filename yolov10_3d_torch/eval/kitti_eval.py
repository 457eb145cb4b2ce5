"""KITTI AP evaluator (the port's copy of ``yolov10_3d_tpu/eval/kitti_eval.py``),
numpy on the host:
  - rotated BEV IoU by convex-polygon intersection (candidate points =
    vertices inside + edge crossings, angle-sorted shoelace), or by the
    C++ clip of ``native/kitti_iou.cc`` when g++ builds it (``iou_route``);
  - 3D IoU = BEV intersection * y-extent overlap / volume union;
  - the official difficulty filtering, DontCare handling, 41-recall-point
    threshold selection, AP11 / AP40.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

CLASS_NAMES = ["car", "pedestrian", "cyclist"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.30, 0.50]
N_SAMPLE_PTS = 41
NO_DETECTION = -10_000_000.0

# min overlap per metric (bbox, bev, 3d) x class, the "moderate" table
MIN_OVERLAPS = {
    "car": (0.7, 0.7, 0.7),
    "pedestrian": (0.5, 0.5, 0.5),
    "cyclist": (0.5, 0.5, 0.5),
}


# ---------------------------------------------------------------- rotated IoU
def rect_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) = (cx, cz, l, w, ry) -> (N, 4, 2) BEV corners.

    KITTI camera frame: x right, z forward; ry rotates around y. A box's BEV
    footprint has length l along local x and width w along local z."""
    cx, cz, l, w, ry = boxes.T
    cos, sin = np.cos(ry), np.sin(ry)
    dx = np.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    dz = np.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    x = cx[:, None] + dx * cos[:, None] + dz * sin[:, None]
    z = cz[:, None] - dx * sin[:, None] + dz * cos[:, None]
    return np.stack([x, z], -1)


def _polygon_areas(pts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Shoelace over angle-sorted valid candidate points.

    pts: (P, K, 2), valid: (P, K) bool. Invalid points are collapsed onto the
    centroid so they contribute zero to the shoelace sum."""
    P, K, _ = pts.shape
    n = valid.sum(-1)  # (P,)
    safe_n = np.maximum(n, 1)
    centroid = (pts * valid[..., None]).sum(1) / safe_n[:, None]
    rel = np.where(valid[..., None], pts - centroid[:, None], 0.0)
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, 1e9)  # invalid sort to the end
    order = np.argsort(ang, axis=-1)
    rel_sorted = np.take_along_axis(rel, order[..., None], axis=1)
    valid_sorted = np.take_along_axis(valid, order, axis=1)
    # close the polygon: for each position, next valid index is (i+1) % n
    idx = np.arange(K)[None, :].repeat(P, 0)
    nxt = np.where(idx + 1 < n[:, None], idx + 1, 0)
    nxt_pts = np.take_along_axis(rel_sorted, nxt[..., None], axis=1)
    cross = rel_sorted[..., 0] * nxt_pts[..., 1] - rel_sorted[..., 1] * nxt_pts[..., 0]
    cross = np.where(valid_sorted, cross, 0.0)
    area = np.abs(cross.sum(-1)) / 2
    return np.where(n >= 3, area, 0.0)


def _points_in_quad(pts: np.ndarray, quad: np.ndarray, eps=1e-8) -> np.ndarray:
    """pts (P, K, 2) in convex quad (P, 4, 2) (counterclockwise or clockwise).
    Returns (P, K) bool via same-side-of-all-edges."""
    a = quad  # (P,4,2)
    b = np.roll(quad, -1, axis=1)
    edge = b - a  # (P,4,2)
    rel = pts[:, :, None, :] - a[:, None, :, :]  # (P,K,4,2)
    cross = edge[:, None, :, 0] * rel[..., 1] - edge[:, None, :, 1] * rel[..., 0]
    return (cross >= -eps).all(-1) | (cross <= eps).all(-1)


def _segment_intersections(q1: np.ndarray, q2: np.ndarray):
    """All 16 edge-pair intersection points of two quads.
    q1, q2: (P, 4, 2). Returns pts (P, 16, 2), valid (P, 16)."""
    a = q1[:, :, None, :]                      # (P,4,1,2) seg1 start
    b = np.roll(q1, -1, axis=1)[:, :, None, :]
    c = q2[:, None, :, :]                      # (P,1,4,2) seg2 start
    d = np.roll(q2, -1, axis=1)[:, None, :, :]
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # (P,4,4)
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    qp = c - a
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    hit = (np.abs(denom) >= 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pt = a + t[..., None] * r
    P = q1.shape[0]
    return pt.reshape(P, 16, 2), hit.reshape(P, 16)


def rotated_intersection_area(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """All-pairs BEV intersection area. boxes (N, 5)/(M, 5) -> (N, M)."""
    N, M = len(boxes1), len(boxes2)
    if N == 0 or M == 0:
        return np.zeros((N, M))
    c1 = rect_corners(boxes1)  # (N,4,2)
    c2 = rect_corners(boxes2)
    q1 = np.repeat(c1, M, axis=0)            # (N*M,4,2)
    q2 = np.tile(c2, (N, 1, 1))
    in12 = _points_in_quad(q1, q2)           # verts of 1 inside 2
    in21 = _points_in_quad(q2, q1)
    xpts, xval = _segment_intersections(q1, q2)
    pts = np.concatenate([q1, q2, xpts], axis=1)          # (P, 24, 2)
    valid = np.concatenate([in12, in21, xval], axis=1)
    return _polygon_areas(pts, valid).reshape(N, M)


def iou_route() -> str:
    """The rotated IoU's route: "native" when the C++ library of
    ``native/kitti_iou.cc`` builds and loads, else "numpy"."""
    from .. import native

    return "native" if native.get_lib() is not None else "numpy"


def bev_iou(boxes1: np.ndarray, boxes2: np.ndarray, criterion: int = -1) -> np.ndarray:
    """Rotated BEV IoU, boxes (*, 5); criterion -1 union, 0 area of boxes1,
    1 area of boxes2. By the route of ``iou_route()``."""
    if len(boxes1) and len(boxes2) and iou_route() == "native":
        from .. import native

        return native.rotated_iou(boxes1, boxes2, criterion).astype(np.float64)
    inter = rotated_intersection_area(boxes1, boxes2)
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    if criterion == -1:
        denom = a1 + a2 - inter
    elif criterion == 0:
        denom = a1
    else:
        denom = a2
    return inter / np.maximum(denom, 1e-12)


def d3_box_overlap(gt_boxes: np.ndarray, dt_boxes: np.ndarray, criterion: int = -1) -> np.ndarray:
    """3D IoU, boxes (N, 7) = (x, y, z, l, h, w, ry) in the camera frame,
    y the bottom of the box; by the route of ``iou_route()``."""
    N, M = len(gt_boxes), len(dt_boxes)
    if N == 0 or M == 0:
        return np.zeros((N, M))
    if iou_route() == "native":
        from .. import native

        return native.iou_3d(gt_boxes, dt_boxes, criterion).astype(np.float64)
    bev1 = gt_boxes[:, [0, 2, 3, 5, 6]]  # x, z, l, w, ry
    bev2 = dt_boxes[:, [0, 2, 3, 5, 6]]
    inter_bev = rotated_intersection_area(bev1, bev2)
    # y extents: [y - h, y]
    y1_hi = gt_boxes[:, 1][:, None]
    y1_lo = (gt_boxes[:, 1] - gt_boxes[:, 4])[:, None]
    y2_hi = dt_boxes[:, 1][None, :]
    y2_lo = (dt_boxes[:, 1] - dt_boxes[:, 4])[None, :]
    ih = np.clip(np.minimum(y1_hi, y2_hi) - np.maximum(y1_lo, y2_lo), 0, None)
    inter = inter_bev * ih
    v1 = (gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5])[:, None]
    v2 = (dt_boxes[:, 3] * dt_boxes[:, 4] * dt_boxes[:, 5])[None, :]
    if criterion == -1:
        denom = v1 + v2 - inter
    elif criterion == 0:
        denom = v1
    else:
        denom = v2
    return inter / np.maximum(denom, 1e-12)


def image_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4),(M,4) xyxy image boxes -> IoU (for the bbox metric)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


# ------------------------------------------------------------------- protocol
def _load_annos(label_dir: str, ids: List[str]) -> List[Dict[str, np.ndarray]]:
    annos = []
    for i in ids:
        rows = []
        p = Path(label_dir) / f"{i}.txt" if not i.endswith(".txt") else Path(label_dir) / i
        for line in p.read_text().splitlines():
            v = line.split()
            if len(v) < 15:
                continue
            rows.append(v)
        annos.append(
            {
                "name": np.array([r[0] for r in rows]),
                "truncated": np.array([float(r[1]) for r in rows]),
                "occluded": np.array([float(r[2]) for r in rows]),
                "alpha": np.array([float(r[3]) for r in rows]),
                "bbox": np.array([[float(x) for x in r[4:8]] for r in rows]).reshape(-1, 4),
                "dimensions": np.array([[float(x) for x in r[8:11]] for r in rows]).reshape(-1, 3),  # h, w, l
                "location": np.array([[float(x) for x in r[11:14]] for r in rows]).reshape(-1, 3),
                "rotation_y": np.array([float(r[14]) for r in rows]),
                "score": np.array([float(r[15]) if len(r) > 15 else 1.0 for r in rows]),
            }
        )
    return annos


def clean_data(gt: Dict, dt: Dict, cls_name: str, difficulty: int):
    """Official per-class/difficulty validity split (devkit cleanData)."""
    ignored_gt, dc_bboxes = [], []
    num_valid_gt = 0
    for i in range(len(gt["name"])):
        name = gt["name"][i].lower()
        if name == cls_name:
            valid = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid = 0
        elif cls_name == "car" and name == "van":
            valid = 0
        else:
            valid = -1
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        ignore = (
            gt["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if name == "dontcare":
            dc_bboxes.append(gt["bbox"][i])
    ignored_dt = []
    for i in range(len(dt["name"])):
        height = dt["bbox"][i, 3] - dt["bbox"][i, 1]
        if dt["name"][i].lower() != cls_name:
            ignored_dt.append(-1)
        elif height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        else:
            ignored_dt.append(0)
    return (
        num_valid_gt,
        np.array(ignored_gt, int),
        np.array(ignored_dt, int),
        np.array(dc_bboxes).reshape(-1, 4),
    )


def _overlap_matrix(gt: Dict, dt: Dict, metric: int) -> np.ndarray:
    """(n_gt, n_dt) overlap for metric 0=bbox, 1=bev, 2=3d."""
    if metric == 0:
        return image_box_iou(gt["bbox"], dt["bbox"])
    def to7(a):
        loc, dim, ry = a["location"], a["dimensions"], a["rotation_y"]
        # (x, y, z, l, h, w, ry)
        return np.concatenate(
            [loc, dim[:, 2:3], dim[:, 0:1], dim[:, 1:2], ry[:, None]], axis=1
        )
    g, d = to7(gt), to7(dt)
    if metric == 1:
        return bev_iou(g[:, [0, 2, 3, 5, 6]], d[:, [0, 2, 3, 5, 6]])
    return d3_box_overlap(g, d)


def compute_statistics(
    overlaps, gt, dt, ignored_gt, ignored_det, dc_bboxes, metric,
    min_overlap, thresh=0.0, compute_fp=False, compute_aos=False,
):
    """One image's tp/fp/fn/aos at a score threshold (devkit
    computeStatistics)."""
    dt_scores = dt["score"]
    dt_alphas = dt["alpha"]
    gt_alphas = gt["alpha"]
    dt_bboxes = dt["bbox"]
    n_gt, n_dt = len(ignored_gt), len(ignored_det)
    assigned = np.zeros(n_dt, bool)
    ignored_threshold = dt_scores < thresh if compute_fp else np.zeros(n_dt, bool)

    tp = fp = fn = similarity = 0.0
    thresholds = []
    delta = []
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_dt):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[i, j]
            score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and score > valid_detection:
                det_idx = j
                valid_detection = score
            elif (
                compute_fp and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp and overlap > min_overlap
                and valid_detection == NO_DETECTION and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(n_dt):
            if not (assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            dc_overlap = image_box_iou(dc_bboxes, dt_bboxes)  # criterion 0 in devkit
            # devkit uses overlap w.r.t. det area for dontcare
            area_dt = (dt_bboxes[:, 2] - dt_bboxes[:, 0]) * (dt_bboxes[:, 3] - dt_bboxes[:, 1])
            lt = np.maximum(dc_bboxes[:, None, :2], dt_bboxes[None, :, :2])
            rb = np.minimum(dc_bboxes[:, None, 2:], dt_bboxes[None, :, 2:])
            inter = np.clip(rb - lt, 0, None).prod(-1)
            dc_overlap = inter / np.maximum(area_dt[None, :], 1e-12)
            for j in range(n_dt):
                if assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                    continue
                if (dc_overlap[:, j] > min_overlap).any():
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + math.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if tp > 0 or fp > 0 else -1.0
    return tp, fp, fn, similarity, thresholds


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = N_SAMPLE_PTS):
    """Score thresholds at evenly spaced recall points (devkit getThresholds)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def eval_class(
    gt_annos: List[Dict], dt_annos: List[Dict], cls_name: str, difficulty: int,
    metric: int, min_overlap: float, compute_aos: bool = False,
):
    """Per-(class, difficulty, metric) PR curve (devkit eval_class)."""
    n = len(gt_annos)
    cleaned = [clean_data(gt_annos[i], dt_annos[i], cls_name, difficulty) for i in range(n)]
    overlaps = [_overlap_matrix(gt_annos[i], dt_annos[i], metric) for i in range(n)]

    all_thresholds = []
    total_valid_gt = 0
    for i in range(n):
        num_valid, ignored_gt, ignored_det, dc = cleaned[i]
        total_valid_gt += num_valid
        _, _, _, _, ths = compute_statistics(
            overlaps[i], gt_annos[i], dt_annos[i], ignored_gt, ignored_det, dc,
            metric, min_overlap, compute_fp=False,
        )
        all_thresholds += list(ths)
    if total_valid_gt == 0:
        return None
    thresholds = get_thresholds(np.array(all_thresholds), total_valid_gt)
    if len(thresholds) == 0:
        return {
            "precision": np.zeros(N_SAMPLE_PTS),
            "recall": np.zeros(N_SAMPLE_PTS),
            "aos": np.zeros(N_SAMPLE_PTS),
        }

    pr = np.zeros((len(thresholds), 4))  # tp, fp, fn, similarity
    for i in range(n):
        num_valid, ignored_gt, ignored_det, dc = cleaned[i]
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics(
                overlaps[i], gt_annos[i], dt_annos[i], ignored_gt, ignored_det,
                dc, metric, min_overlap, thresh=thresh, compute_fp=True,
                compute_aos=compute_aos,
            )
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if sim != -1:
                pr[t, 3] += sim

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for t in range(len(thresholds)):
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-12)
        recall[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-12)
        if compute_aos:
            aos[t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-12)
    # right-max interpolation
    for t in range(N_SAMPLE_PTS):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()
    return {"precision": precision, "recall": recall, "aos": aos}


def _ap(precision: np.ndarray, mode: int = 40) -> float:
    if mode == 40:  # R40: mean of the 40 points after recall 0
        return float(precision[1:41].sum() / 40 * 100)
    # AP11: samples at recall 0, 0.1, ..., 1.0 (indices 0, 4, ..., 40)
    return float(precision[0::4].sum() / 11 * 100)


def eval_from_scratch(
    gt_dir: str, det_dir: str, ap_mode: int = 40, classes=None, compute_aos: bool = True,
) -> Dict[str, Tuple[float, float, float]]:
    """Evaluate detection txts against GT labels; returns
    {"bbox@ov": (easy, moderate, hard), "bev@ov": ..., "3d@ov": ..., "aos@ov"...}
    for each class's official min overlap; the fitness reads "3d@0.70" index 1
    (moderate)."""
    det_files = sorted(Path(det_dir).glob("*.txt"))
    ids = [f.name for f in det_files]
    gt_annos = _load_annos(gt_dir, ids)
    dt_annos = _load_annos(det_dir, ids)

    # Cyclist, Pedestrian, then Car: the tables returned are the last class's
    # (Car), as the official evaluator's are
    classes = classes or ["cyclist", "pedestrian", "car"]
    results: Dict[str, List[float]] = {}
    for cls in classes:
        results = {}
        ov_bbox, ov_bev, ov_3d = MIN_OVERLAPS[cls]
        for metric, name, ov in ((0, "bbox", ov_bbox), (1, "bev", ov_bev), (2, "3d", ov_3d)):
            key = f"{name}@{ov:.2f}"
            vals = []
            for difficulty in range(3):
                r = eval_class(
                    gt_annos, dt_annos, cls, difficulty, metric, ov,
                    compute_aos=(metric == 0 and compute_aos),
                )
                if r is None:
                    vals.append(0.0)
                    continue
                vals.append(_ap(r["precision"], ap_mode))
                if metric == 0 and compute_aos:
                    results.setdefault(f"aos@{ov:.2f}", []).append(_ap(r["aos"], ap_mode))
            results[key] = vals
    return {k: tuple(v) for k, v in results.items()}
