"""Hierarchical Task Learning loss weights (port of
``yolov10_3d_tpu/train/htl.py``): MonoDLE's epoch-wise weighting of the 12
3D loss terms from a dependency graph, on the host in numpy.

Terms with no predecessors keep weight 1; a dependent term ramps in as
``time ** (1 - control)``, where control is the product of its predecessors'
normalised improvement over a trailing 5-epoch window. The weights are
normalised to sum to half the number of terms (6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# term index (in train/loss3d.py ITEM_KEYS order) -> predecessor term indices:
# dep <- box2d, s3d; o3d, s3d, hd <- box2d
LOSS_GRAPH: Dict[int, List[int]] = {
    0: [],  # box2d_om
    1: [],  # cls_om
    2: [0, 4],  # dep_om <- box2d_om, s3d_om
    3: [0],  # o3d_om <- box2d_om
    4: [0],  # s3d_om <- box2d_om
    5: [0],  # hd_om <- box2d_om
    6: [],  # box2d_oo
    7: [],  # cls_oo
    8: [6, 10],  # dep_oo <- box2d_oo, s3d_oo
    9: [6],  # o3d_oo
    10: [6],  # s3d_oo
    11: [6],  # hd_oo
}


class HierarchicalTaskLearning:
    """``compute_weight(current_loss, epoch)`` -> the (12,) float32 weights."""

    def __init__(self, stat_epoch_nums: int = 5, max_epochs: int = 200):
        self.stat_epoch_nums = stat_epoch_nums
        self.max_epochs = max_epochs
        self.past_losses: List[np.ndarray] = []
        self.init_diff: Optional[np.ndarray] = None

    def state_dict(self) -> Dict:
        return {
            "past_losses": [list(map(float, v)) for v in self.past_losses],
            "init_diff": list(map(float, self.init_diff)) if self.init_diff is not None else None,
        }

    def load_state_dict(self, d: Dict) -> None:
        self.past_losses = [np.asarray(v, np.float64) for v in d.get("past_losses", [])]
        di = d.get("init_diff")
        self.init_diff = np.asarray(di, np.float64) if di is not None else None

    def compute_weight(self, current_loss: Sequence[float], epoch: int) -> np.ndarray:
        current = np.asarray(current_loss, np.float64)
        n = len(LOSS_GRAPH)
        weights = np.array([1.0 if not LOSS_GRAPH[i] else 0.0 for i in range(n)], np.float64)
        if len(self.past_losses) == self.stat_epoch_nums:
            past = np.stack(self.past_losses)  # (S, 12)
            mean_diff = (past[:-2] - past[2:]).mean(0)
            if self.init_diff is None:
                self.init_diff = mean_diff.copy()
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(self.init_diff != 0, mean_diff / self.init_diff, 0.0)
            c_weights = 1.0 - np.maximum(ratio, 0.0)
            time_value = min((epoch - self.stat_epoch_nums)
                             / max(self.max_epochs - self.stat_epoch_nums, 1), 1.0)
            time_value = max(time_value, 0.0)
            for i, preds in LOSS_GRAPH.items():
                if preds:
                    control = 1.0
                    for p in preds:
                        control *= c_weights[p]
                    weights[i] = time_value ** (1.0 - control)
            if not np.all(np.isfinite(weights)):
                # an infinite weight must become 0 too, or it would take the
                # whole normalised budget
                weights = np.nan_to_num(weights, nan=0.0, posinf=0.0, neginf=0.0)
            self.past_losses.pop(0)
        self.past_losses.append(current)
        s = weights.sum()
        if s <= 0:
            return np.ones(n, np.float32) * (n / 2) / n
        return (weights / s * (n / 2)).astype(np.float32)
