"""Detection metrics (the port's copy of the 2D part of
``yolov10_3d_tpu/utils/metrics.py``: AP per class, prediction matching,
``DetMetrics`` and the task metrics: mask IoU, keypoint OKS and rotated
probiou, ``SegmentMetrics``, ``PoseMetrics`` and ``OBBMetrics``). Numpy, on
the host: the device produces fixed-shape rows per image.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP over the monotone precision envelope
    (COCO-style)."""
    # close the curve at recall 0 (precision 1) and recall 1 (precision 0),
    # then take the running max from the right: the precision envelope
    r_closed = np.concatenate(([0.0], recall, [1.0]))
    envelope = np.concatenate(([1.0], precision, [0.0]))[::-1]
    envelope = np.maximum.accumulate(envelope)[::-1]
    grid = np.linspace(0, 1, 101)
    trapezoid = getattr(np, "trapezoid", np.trapz)
    ap = trapezoid(np.interp(grid, r_closed, envelope), grid)
    return ap, envelope, r_closed


# shared confidence grid all per-class curves are resampled onto (the
# protocol fixes 1000 points; the max-F1 operating point is picked on it)
_CONF_GRID = np.linspace(0, 1, 1000)


def _resample_by_conf(conf_desc: np.ndarray, values: np.ndarray, fill: float):
    """Linearly resample a curve parameterised by DESCENDING confidence onto
    _CONF_GRID. np.interp wants ascending abscissae, so interpolate on the
    negated axis; ``fill`` extends the curve above the highest confidence."""
    return np.interp(-_CONF_GRID, -conf_desc, values, left=fill)


def ap_per_class(
    tp: np.ndarray,          # (N, T) bool, T IoU thresholds
    conf: np.ndarray,        # (N,)
    pred_cls: np.ndarray,    # (N,)
    target_cls: np.ndarray,  # (M,)
    eps: float = 1e-16,
):
    """Per-class P/R/AP curves. Returns dict with tp, fp, p, r, f1, ap
    (nc, T), unique_classes. Detections are bucketed per class once, and
    precision is cum_hits / rank (tp / (tp + fp) for boolean hits).
    """
    # stable tie order matters: ties keep ascending original index (a
    # reversed argsort would anti-stabilize them)
    desc = np.argsort(-conf, kind="stable")
    tp, conf, pred_cls = tp[desc], conf[desc], pred_cls[desc]
    classes, gt_counts = np.unique(target_cls, return_counts=True)
    n_cls, n_thr = classes.shape[0], tp.shape[1]

    ap = np.zeros((n_cls, n_thr))
    p_curve = np.zeros((n_cls, _CONF_GRID.size))
    r_curve = np.zeros((n_cls, _CONF_GRID.size))
    for row, (cls_id, n_gt) in enumerate(zip(classes, gt_counts)):
        sel = pred_cls == cls_id
        if n_gt == 0 or not sel.any():
            continue
        hits = tp[sel].astype(np.float64)         # (n_det, T), conf-descending
        cum_hits = np.cumsum(hits, axis=0)
        rank = np.arange(1, hits.shape[0] + 1)[:, None]
        recall = cum_hits / (n_gt + eps)
        precision = cum_hits / rank               # == tp / (tp + fp)
        # curves on the shared grid use the first IoU threshold (0.5)
        r_curve[row] = _resample_by_conf(conf[sel], recall[:, 0], fill=0.0)
        p_curve[row] = _resample_by_conf(conf[sel], precision[:, 0], fill=1.0)
        for t in range(n_thr):
            ap[row, t] = compute_ap(recall[:, t], precision[:, t])[0]

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()  # max-F1 confidence index
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_c = (r * gt_counts).round()
    fp_c = (tp_c / (p + eps) - tp_c).round()
    return {
        "tp": tp_c, "fp": fp_c, "p": p, "r": r, "f1": f1, "ap": ap,
        "unique_classes": classes.astype(int), "nt": gt_counts,
        "p_curve": p_curve, "r_curve": r_curve, "f1_curve": f1_curve,
        "x": _CONF_GRID.copy(),  # callers may scale the grid for plots
    }


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def match_predictions(
    pred_classes: np.ndarray,  # (N,)
    true_classes: np.ndarray,  # (M,)
    iou: np.ndarray,           # (M, N) pairwise IoU labels x detections
    iouv: np.ndarray,          # (T,) thresholds
) -> np.ndarray:
    """Two-round claim matching over IoU thresholds. Returns (N, T) bool.

    Every detection claims its single best class-matched label; every label
    then accepts the claim of the EARLIEST claiming detection (detections
    arrive confidence-sorted, so the most confident, not the highest IoU):
    one argmax per detection, then one scatter in descending-index order so
    that the earliest claimant lands last.
    """
    n, t = pred_classes.shape[0], iouv.shape[0]
    correct = np.zeros((n, t), bool)
    if n == 0 or true_classes.shape[0] == 0:
        return correct
    iou = np.where(true_classes[:, None] == pred_classes[None, :], iou, 0.0)
    best_label = iou.argmax(axis=0)              # each detection's claim
    best_iou = iou[best_label, np.arange(n)]     # strength of that claim
    desc = np.arange(n)[::-1]                    # descending: earliest writes last
    for i, threshold in enumerate(iouv):
        claimants = desc[best_iou[desc] >= threshold]
        winner = np.full(true_classes.shape[0], -1, np.int64)
        winner[best_label[claimants]] = claimants   # earliest claim per label
        correct[winner[winner >= 0], i] = True
    return correct


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs IoU, xyxy, numpy: (M,4),(N,4) -> (M,N)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


class DetMetrics:
    """mAP accumulation.

    update(tp (N,10) bool, conf (N,), pred_cls (N,), target_cls (M,)) per
    image; results() -> dict incl. mAP50, mAP50-95, mp, mr, fitness."""

    def __init__(self, nc: int = 80, names: Optional[Dict[int, str]] = None):
        self.nc = nc
        self.names = names or {}
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.reset()

    def reset(self):
        self._tp: List[np.ndarray] = []
        self._conf: List[np.ndarray] = []
        self._pred_cls: List[np.ndarray] = []
        self._target_cls: List[np.ndarray] = []

    def update(self, tp, conf, pred_cls, target_cls):
        self._tp.append(np.asarray(tp))
        self._conf.append(np.asarray(conf))
        self._pred_cls.append(np.asarray(pred_cls))
        self._target_cls.append(np.asarray(target_cls))

    def process_batch(self, pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls):
        """Convenience: match + update for one image (xyxy numpy)."""
        if len(pred_boxes) == 0:
            self.update(
                np.zeros((0, len(self.iouv)), bool), np.zeros(0), np.zeros(0), gt_cls
            )
            return
        if len(gt_boxes) == 0:
            self.update(
                np.zeros((len(pred_boxes), len(self.iouv)), bool),
                pred_scores, pred_cls, np.zeros(0),
            )
            return
        iou = box_iou_np(np.asarray(gt_boxes), np.asarray(pred_boxes))
        tp = match_predictions(np.asarray(pred_cls), np.asarray(gt_cls), iou, self.iouv)
        self.update(tp, pred_scores, pred_cls, gt_cls)

    def results(self) -> Dict[str, float]:
        if not self._tp:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "mp": 0.0, "mr": 0.0, "fitness": 0.0}
        tp = np.concatenate(self._tp)
        conf = np.concatenate(self._conf)
        pred_cls = np.concatenate(self._pred_cls)
        target_cls = np.concatenate(self._target_cls)
        if tp.shape[0] == 0 or target_cls.shape[0] == 0:
            return {"mAP50": 0.0, "mAP50-95": 0.0, "mp": 0.0, "mr": 0.0, "fitness": 0.0}
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        ap50 = res["ap"][:, 0].mean() if res["ap"].size else 0.0
        ap = res["ap"].mean() if res["ap"].size else 0.0
        out = {
            "mAP50": float(ap50),
            "mAP50-95": float(ap),
            "mp": float(res["p"].mean()),
            "mr": float(res["r"].mean()),
        }
        # fitness = 0.1*mAP50 + 0.9*mAP50-95
        out["fitness"] = 0.1 * out["mAP50"] + 0.9 * out["mAP50-95"]
        out["ap_class"] = res["unique_classes"]
        out["ap50_per_class"] = res["ap"][:, 0]
        out["ap_per_class"] = res["ap"].mean(1)
        return out


def mask_iou(gt_masks: np.ndarray, pred_masks: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs mask IoU: gt (M, H*W), pred (N, H*W) binary -> (M, N)."""
    gt = gt_masks.reshape(gt_masks.shape[0], -1).astype(np.float32)
    pr = pred_masks.reshape(pred_masks.shape[0], -1).astype(np.float32)
    inter = gt @ pr.T
    union = gt.sum(1)[:, None] + pr.sum(1)[None] - inter
    return inter / (union + eps)


# COCO's 17-keypoint OKS sigmas
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
                      1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def kpt_iou(gt_kpts: np.ndarray, pred_kpts: np.ndarray, area: np.ndarray,
            sigma: Optional[np.ndarray] = None, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity of gt (M, K, 2 | 3) and pred (N, K, 2 | 3)
    keypoints -> (M, N); ``area`` (M,) the gt boxes' areas (times 0.53 in
    the caller); COCO's sigmas for 17 keypoints, 1 / K each otherwise."""
    K = gt_kpts.shape[1]
    sigma = sigma if sigma is not None else (OKS_SIGMA if K == 17 else np.ones(K) / K)
    d2 = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2
          + (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)
    kpt_mask = ((gt_kpts[..., 2] != 0) if gt_kpts.shape[-1] == 3
                else np.ones(gt_kpts.shape[:2], bool))
    e = d2 / ((2 * sigma) ** 2)[None, None] / (area[:, None, None] + eps) / 2
    return (np.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


def probiou_np(obb1: np.ndarray, obb2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """All-pairs rotated probabilistic IoU: (M, 5), (N, 5) xywhr -> (M, N)."""
    x1, y1 = obb1[:, 0:1], obb1[:, 1:2]
    x2, y2 = obb2[:, 0], obb2[:, 1]

    def cov(b):
        w, h, r = b[:, 2], b[:, 3], b[:, 4]
        a, bb = (w ** 2) / 12, (h ** 2) / 12
        cos, sin = np.cos(r), np.sin(r)
        return a * cos ** 2 + bb * sin ** 2, a * sin ** 2 + bb * cos ** 2, (a - bb) * cos * sin

    a1, b1, c1 = (v[:, None] for v in cov(obb1))
    a2, b2, c2 = cov(obb2)
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (
        (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps) * 0.5
    t3 = np.log(
        ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
        / (4 * np.sqrt(np.clip(a1 * b1 - c1 ** 2, 0, None) * np.clip(a2 * b2 - c2 ** 2, 0, None))
           + eps) + eps) * 0.5
    bd = np.clip(t1 + t2 + t3, eps, 100.0)
    return 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)


def _task_results(box: Dict, task: Dict, tag: str, name: str) -> Dict:
    """Box metrics as ``metrics/<k>(B)``, the task's as ``metrics/<k>(<tag>)``,
    ``fitness_box`` and ``fitness_<name>``, the box keys bare, and fitness
    the sum of the two fitnesses."""
    out = {f"metrics/{k}(B)" if k != "fitness" else "fitness_box": v
           for k, v in box.items() if np.isscalar(v)}
    out.update({f"metrics/{k}({tag})" if k != "fitness" else f"fitness_{name}": v
                for k, v in task.items() if np.isscalar(v)})
    out.update({k: v for k, v in box.items() if np.isscalar(v)})
    out["fitness"] = box["fitness"] + task["fitness"]
    return out


class SegmentMetrics(DetMetrics):
    """Box and mask mAP; the mask matches by mask IoU."""

    def __init__(self, nc: int = 80, names: Optional[Dict[int, str]] = None):
        super().__init__(nc, names)
        self.mask = DetMetrics(nc, names)

    def process_batch_seg(self, pred_boxes, pred_scores, pred_cls, pred_masks, gt_boxes,
                          gt_cls, gt_masks):
        self.process_batch(pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls)
        if len(pred_scores) == 0 or len(gt_cls) == 0:
            self.mask.process_batch(pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls)
            return
        iou = mask_iou(np.asarray(gt_masks), np.asarray(pred_masks))
        tp = match_predictions(np.asarray(pred_cls), np.asarray(gt_cls), iou, self.iouv)
        self.mask.update(tp, pred_scores, pred_cls, gt_cls)

    def results(self) -> Dict[str, float]:
        return _task_results(super().results(), self.mask.results(), "M", "mask")


class PoseMetrics(DetMetrics):
    """Box and pose mAP; the pose matches by OKS."""

    def __init__(self, nc: int = 1, names: Optional[Dict[int, str]] = None):
        super().__init__(nc, names)
        self.pose = DetMetrics(nc, names)

    def process_batch_pose(self, pred_boxes, pred_scores, pred_cls, pred_kpts, gt_boxes,
                           gt_cls, gt_kpts):
        self.process_batch(pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls)
        if len(pred_scores) == 0 or len(gt_cls) == 0:
            self.pose.process_batch(pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls)
            return
        g = np.asarray(gt_boxes)
        area = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]) * 0.53
        iou = kpt_iou(np.asarray(gt_kpts), np.asarray(pred_kpts), area)
        tp = match_predictions(np.asarray(pred_cls), np.asarray(gt_cls), iou, self.iouv)
        self.pose.update(tp, pred_scores, pred_cls, gt_cls)

    def results(self) -> Dict[str, float]:
        return _task_results(super().results(), self.pose.results(), "P", "pose")


class OBBMetrics(DetMetrics):
    """Rotated-box mAP, matched by probiou; ``process_batch`` takes xywhr."""

    def process_batch(self, pred_rboxes, pred_scores, pred_cls, gt_rboxes, gt_cls):
        if len(pred_rboxes) == 0:
            self.update(np.zeros((0, len(self.iouv)), bool), np.zeros(0), np.zeros(0), gt_cls)
            return
        if len(gt_rboxes) == 0:
            self.update(np.zeros((len(pred_rboxes), len(self.iouv)), bool), pred_scores,
                        pred_cls, np.zeros(0))
            return
        iou = probiou_np(np.asarray(gt_rboxes), np.asarray(pred_rboxes))
        tp = match_predictions(np.asarray(pred_cls), np.asarray(gt_cls), iou, self.iouv)
        self.update(tp, pred_scores, pred_cls, gt_cls)
