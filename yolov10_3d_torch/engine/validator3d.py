"""3D detection validator (port of ``yolov10_3d_tpu/engine/validator3d.py``):
KITTI AP40 of a YOLOv10-3D model (on a Waymo or Omni3D dataset, that
dataset's own fitness: ``get_stats``).

Per batch: one host-to-device copy of the uint8 frames, the forward, the 3D
decode and the top-k on the model's device under ``torch.inference_mode``,
and one copy back of (B, K, 37) rows: the 35 regression values, the RAW score
logit and the label (``decode_preds`` applies the sigmoid and the
depth-uncertainty factor itself, so the Predictor's forward, which returns
sigmoid scores, is not reused). On the host: the optional one2many depth
fusion, the KITTI rows in the original frame, the 2D mAP bookkeeping; after
the last batch the rows are written as KITTI text files and the AP40
evaluator runs. Fitness is 3D AP40, moderate, at IoU 0.7. With
``use_dino_depth`` (and the one2many fusion off) each row's depth is the
frozen DINOv2 teacher's (``dino_path``, ``models/dino.py``), run on the
model's device on the batch's frames.

The forward's route is the JAX validator's: the sparse one2one head while
``max_det <= SPARSE_K``, the head's options allow it and the one2many
depth fusion is off, the dense
one2one maps otherwise, and with ``use_o2m_depth`` the one2many maps too,
decoded and cut to ``5 * max_det``. The validator runs no fused serving stem
and no hand kernel: cuDNN convs (on the card), the plain ``decode_detect3d``
and ``ops/topk.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.kitti import KITTIDataset
from ..eval.kitti_eval import eval_from_scratch
from ..models.dino import load_dino_teacher
from ..nn.heads3d import SPARSE_K
from ..ops.postprocess import decode_detect3d, v10_3d_postprocess
from ..utils.metrics import DetMetrics, box_iou_np


def aggregate_o2m_depth(
    predsO: np.ndarray, predsM: np.ndarray, thres: float = 0.1, grid_points: int = 500
) -> np.ndarray:
    """Refine the one2one depths (column 33) with the one2many cluster: for
    each one2one detection, gather the same-class one2many detections with
    IoU > 0.9, weight their depths by exp(-uncertainty) (weights <= ``thres``
    drop), fit a weighted Gaussian KDE (Silverman bandwidth, as sklearn's
    KernelDensity) and take its mode over a ``grid_points`` grid between the
    cluster's extreme depths. A detection with no partner keeps its depth.

    Rows: bbox (4), c3d (2), s3d (3), hd (24), dep, dep_un, score, label.
    """
    predsO = predsO.copy()
    B, N = predsO.shape[:2]
    M = predsM.shape[1]
    for i in range(B):
        iou = box_iou_np(predsO[i, :, :4], predsM[i, :, :4])  # (N, M)
        # column 0 = the o2o detection itself, columns 1.. = the o2m cluster
        depths = np.concatenate(
            [predsO[i, :, 33:34], np.broadcast_to(predsM[i, :, 33], (N, M))], 1
        )  # (N, M+1)
        uncerts = np.concatenate(
            [predsO[i, :, 34:35], np.broadcast_to(predsM[i, :, 34], (N, M))], 1
        )
        same_cls = np.concatenate(
            [np.ones((N, 1), bool), predsM[i, :, 36][None] == predsO[i, :, 36:37]], 1
        )
        matches = np.concatenate([np.ones((N, 1), bool), iou > 0.9], 1)
        w = np.exp(-uncerts)
        mask = matches & same_cls & (w > thres)
        n = mask.sum(1)
        rows = np.nonzero(n > 1)[0]
        if rows.size == 0:
            continue
        # each row compacted to its masked columns
        kmax = int(n.max())
        order = np.argsort(~mask[rows], axis=1, kind="stable")[:, :kmax]
        sub_mask = np.take_along_axis(mask[rows], order, 1)  # (R, kmax)
        d = np.where(sub_mask, np.take_along_axis(depths[rows], order, 1), np.nan)
        wv = np.where(sub_mask, np.take_along_axis(w[rows], order, 1), 0.0)
        nr = n[rows].astype(np.float64)
        # Silverman's bandwidth as sklearn computes it, h = (n (d + 2) / 4)^(-1 / (d + 4))
        # with d = 1; the grid's argmax ignores the KDE's normalisation
        h = (nr * 3.0 / 4.0) ** (-0.2)  # (R,)
        dmin, dmax = np.nanmin(d, 1), np.nanmax(d, 1)
        grid = dmin[:, None] + (dmax - dmin)[:, None] * np.linspace(0.0, 1.0, grid_points)[None]
        z = (grid[:, :, None] - np.nan_to_num(d)[:, None, :]) / h[:, None, None]
        density = np.einsum("rgk,rk->rg", np.exp(-0.5 * z * z), wv)  # (R, G)
        predsO[i, rows, 33] = np.take_along_axis(
            grid, np.argmax(density, 1)[:, None], 1
        )[:, 0]
    return predsO


def dino_pixel(centres: np.ndarray, hw) -> Tuple[np.ndarray, np.ndarray]:
    """The depth-map pixel (row, column) that ``use_dino_depth`` reads for
    projected 3D centres (..., 2: x, y in model-input pixels) on an (H, W)
    map: each coordinate truncated to int and clamped to the map."""
    c = np.asarray(centres)
    return (np.clip(c[..., 1].astype(np.int64), 0, hw[0] - 1),
            np.clip(c[..., 0].astype(np.int64), 0, hw[1] - 1))


def build_3d_dataset(data_name, path, mode: str, args: Optional[Mapping[str, Any]] = None):
    """The 3D dataset named by the data YAML's file name: KITTI, Waymo or
    Omni3D (the JAX ``build_3d_dataset``)."""
    name = str(data_name).lower()
    if "kitti" in name:
        return KITTIDataset(root=path, split="train" if mode == "train" else "val", args=args)
    if "waymo" in name:
        from ..data.waymo import WaymoDataset

        return WaymoDataset(root=path, split=mode, args=args)
    if "omni" in name:
        from ..data.omni3d import Omni3Dataset

        return Omni3Dataset(root=path, split=mode, args=args)
    raise ValueError(f"unknown 3D dataset for {data_name!r}")


class Detection3DValidator:
    """KITTI AP40 of ``model`` (a v10Detect3d YOLOModel) on its device.

    After a call, ``results`` holds the KITTI rows per image file (before the
    text formatting), ``bins`` their heading bins, ``table`` the AP40 tables of ``eval_from_scratch`` and
    ``timings`` the seconds spent waiting on the loader, on the device
    (forward + decode + top-k; CUDA events on the card), in the DINOv2
    teacher (``use_dino_depth``: its forward and the depth lookup), on the
    host rows (one2many fusion, ``decode_preds``, 2D metrics,
    ``save_results``) and in ``eval_from_scratch`` (or a Waymo or Omni3D
    dataset's ``get_stats``), with the total and the image count."""

    def __init__(self, model, spec, args: Optional[Mapping[str, Any]] = None, names=None):
        self.args = dict(args or {})
        if spec.head_module != "v10Detect3d":
            raise ValueError(f"the 3D validator needs a v10Detect3d head, not {spec.head_module}")
        self.model = model.eval()
        self.spec = spec
        self.names = names or {i: str(i) for i in range(spec.nc)}
        self.device = next(model.parameters()).device
        self.dtype = next(model.parameters()).dtype  # float32; float64 for a reference run
        self.results: Dict[str, List] = {}
        self.bins: Dict[str, List[int]] = {}
        self.centres: Dict[str, List[Tuple[float, float]]] = {}
        self.table: Dict[str, Tuple[float, float, float]] = {}
        self.timings: Dict[str, float] = {}
        self.dino_teacher = None  # loaded from dino_path at the first use_dino_depth batch

    def route(self, max_det: int, with_o2m: bool) -> str:
        """The head's route for these settings: "sparse" (``max_det <=
        SPARSE_K`` and a head whose options allow it), "dense" or "dense+o2m"."""
        if with_o2m:
            return "dense+o2m"
        head = self.model.model[self.spec.head_index]
        return "sparse" if max_det <= SPARSE_K and head.sparse_ok else "dense"

    def dino_depth(self, preds: np.ndarray, img: np.ndarray) -> np.ndarray:
        """``use_dino_depth``: each row's depth (column 33) replaced by the
        frozen DINOv2 teacher's depth map of the frames at the row's
        projected centre (columns 4:6, model-input pixels, truncated to int
        and clamped to the map). The teacher (``dino_path``) runs on the
        model's device."""
        if self.dino_teacher is None:
            path = self.args.get("dino_path")
            if not path:
                raise ValueError("use_dino_depth=True requires dino_path to point at a saved "
                                 "DinoDepther/dinov2 state dict")
            self.dino_teacher = load_dino_teacher(str(path), device=self.device)
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        depth_maps = self.dino_teacher(x.permute(0, 3, 1, 2).float().div(255.0))[0].cpu().numpy()
        preds = preds.copy()
        cy, cx = dino_pixel(preds[..., 4:6], depth_maps.shape[1:])
        preds[..., 33] = depth_maps[np.arange(preds.shape[0])[:, None], cy, cx]
        return preds

    @torch.inference_mode()
    def _forward(self, img: np.ndarray, max_det: int, with_o2m: bool
                 ) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
        """uint8 NHWC frames -> (one2one rows (B, max_det, 37), one2many rows
        (B, 5 max_det, 37) or None, device seconds)."""
        nc = self.spec.nc
        x = torch.from_numpy(img).to(self.device)
        cuda = x.is_cuda
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        x = x.permute(0, 3, 1, 2).to(self.dtype).div(255.0).contiguous()
        out = self.model(x, fast_eval=not with_o2m,
                         sparse=self.route(max_det, with_o2m) == "sparse")
        strides = self.spec.strides[: len(out["one2one"])]

        def rows(feats, k):
            reg, scores, labels = v10_3d_postprocess(decode_detect3d(feats, strides, nc), k, nc)
            return torch.cat([reg, scores[..., None], labels[..., None].float()], -1)

        parts = [rows(out["one2one"], max_det)]
        if with_o2m:
            parts.append(rows(out["one2many"], max_det * 5))
        if cuda:
            end.record()
        host = torch.cat(parts, 1).cpu().numpy()  # the one copy back
        seconds = (start.elapsed_time(end) / 1e3 if cuda else time.perf_counter() - t0)
        return host[:, :max_det], (host[:, max_det:] if with_o2m else None), seconds

    def __call__(
        self,
        dataset: KITTIDataset,
        dataloader,
        save_dir: str = "runs/val3d",
        conf_threshold: float = 0.001,
        max_det: int = 50,
        use_o2m_depth: bool = False,
    ) -> Dict[str, Any]:
        """``dataloader`` yields dict batches of ``dataset`` items (img,
        img_id, trans_inv, gt_bboxes, gt_labels, mask_gt, ...)."""
        use_o2m_depth = use_o2m_depth or bool(self.args.get("use_o2m_depth", False))
        use_dino_depth = bool(self.args.get("use_dino_depth", False))
        max_det = int(max_det)
        metrics2d = DetMetrics(nc=self.spec.nc, names=self.names)
        all_results: Dict[str, List] = {}
        all_bins: Dict[str, List[int]] = {}
        all_centres: Dict[str, List[Tuple[float, float]]] = {}
        t = dict.fromkeys(("loader", "device", "teacher", "host", "eval"), 0.0)
        n_images = 0
        t_start = time.perf_counter()
        batches = iter(dataloader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t["loader"] += time.perf_counter() - t0
            if batch is None:
                break
            img = batch["img"]
            preds, predsM, seconds = self._forward(img, max_det, use_o2m_depth)
            t["device"] += seconds
            t0 = time.perf_counter()
            reg, scores, labels = preds[..., :35], preds[..., 35], preds[..., 36].astype(np.int32)
            if use_o2m_depth:
                preds = aggregate_o2m_depth(preds, predsM)
                reg = preds[..., :35]
            elif use_dino_depth:  # as JAX: the teacher's depth only without the o2m fusion
                t1 = time.perf_counter()
                preds = self.dino_depth(preds, img)
                reg = preds[..., :35]
                t["teacher"] += time.perf_counter() - t1
                t0 += time.perf_counter() - t1  # the host rows' clock skips the teacher
            img_ids = np.asarray(batch["img_id"]).reshape(-1)
            calibs = [dataset.get_calib(int(i)) for i in img_ids]
            im_files = [f"{int(i):06d}.txt" for i in img_ids]
            all_results.update(dataset.decode_preds(
                preds, calibs, im_files, np.asarray(batch["trans_inv"]),
                threshold=conf_threshold, bins=all_bins, centres=all_centres))

            # 2D mAP in the model frame
            B, H, W = img.shape[:3]
            for b in range(B):
                keep = 1 / (1 + np.exp(-scores[b])) > 0.25
                mask = np.asarray(batch["mask_gt"][b])
                gt_xywh = np.asarray(batch["gt_bboxes"][b])[mask] * np.array(
                    [W, H, W, H], np.float32)
                gt_xyxy = np.concatenate(
                    [gt_xywh[:, :2] - gt_xywh[:, 2:] / 2, gt_xywh[:, :2] + gt_xywh[:, 2:] / 2],
                    -1)
                metrics2d.process_batch(
                    reg[b][:, :4][keep],
                    1 / (1 + np.exp(-scores[b][keep])),
                    labels[b][keep],
                    gt_xyxy,
                    np.asarray(batch["gt_labels"][b])[mask],
                )
            n_images += B
            t["host"] += time.perf_counter() - t0

        if dataset.label_dir is not None:  # KITTI: dataset.get_stats in two timed steps
            t0 = time.perf_counter()
            pred_dir = dataset.save_results(all_results, save_dir)
            t["host"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            self.table = eval_from_scratch(str(dataset.label_dir), pred_dir, ap_mode=40)
            t["eval"] = time.perf_counter() - t0
            ap3d_moderate = self.table["3d@0.70"][1]
        else:  # Waymo, Omni3D: their own fitness (the ground truth written from the JSON)
            t0 = time.perf_counter()
            ap3d_moderate = dataset.get_stats(all_results, save_dir)
            t["eval"] = time.perf_counter() - t0
            self.table = dataset.table
        self.results, self.bins, self.centres = all_results, all_bins, all_centres
        self.timings = {**t, "total": time.perf_counter() - t_start, "images": n_images}

        out = metrics2d.results()
        out["metrics/3D"] = float(ap3d_moderate)
        out["fitness"] = float(ap3d_moderate)
        return out
