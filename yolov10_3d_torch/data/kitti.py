"""KITTI monocular-3D dataset (the port's copy of ``yolov10_3d_tpu/data/kitti.py``
``KITTIDataset``: the ``train``/``trainval`` splits, which augment, and the
``val``/``test`` splits, which do not).

Each frame is warped to the fixed input resolution (1280x384 by default) by
the centre/scale affine, and each valid object becomes one row of padded
``max_objs`` label arrays: the 2D box, the projected 3D centre, the depth,
the 12-bin heading and the size residual against the class mean. The
training splits flip the frame (with its labels and calibration), crop it at
a random scale and shift, and blend in a partner frame of the same
intrinsics (mixup), drawing from one ``np.random.default_rng(seed)`` per
dataset in the JAX dataset's order; with ``load_depth_maps`` each item also
carries the FGDM target ``depth_map``, built from the instance masks under
``deepseg/training/image_2``. The frame is decoded by the port's own codec
(``data/image_io.py``, PIL's rule, PNG or JPEG); ``warp_affine_bilinear``, ``warp_affine_nearest`` and ``blend`` give
PIL's ``Image.transform(AFFINE, BILINEAR)``, ``Image.transform(AFFINE,
NEAREST, fillcolor=...)`` and ``Image.blend`` bit for bit.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from .image_io import imread
from .kitti_utils import (
    CLS2ID, CLS_MEAN_SIZE, CLASS_NAMES, Calibration, Object3d, affine_transform, angle2class,
    class2angle, get_affine_transform, get_objects_from_label,
)

MAX_OBJS = 50
RESOLUTION = np.array([1280, 384])  # W, H
SEG_BACKGROUND = 51  # the instance masks' background value


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """uint8 ``a + alpha * (b - a)`` in float32, truncated: PIL's ``Image.blend``."""
    a32 = a.astype(np.float32)
    return (a32 + np.float32(alpha) * (b.astype(np.float32) - a32)).astype(np.uint8)


def _coord(v: np.ndarray) -> np.ndarray:
    """PIL's COORD: -1 below 0, else truncation to int."""
    return np.where(v < 0.0, -1, v.astype(np.int64))


def _running(start: float, step: float, n: int) -> np.ndarray:
    """start, start + step, ... (n values) added one step at a time in
    float64, as PIL's loops accumulate them."""
    steps = np.full(n, step, np.float64)
    steps[0] = start
    return np.cumsum(steps)


def warp_affine_nearest(img: np.ndarray, trans_inv: np.ndarray, size, fill: int = 0
                        ) -> np.ndarray:
    """HW(C) ``img`` resampled onto ``size`` (W, H) by its nearest pixel through
    ``trans_inv``; pixels that map outside the source keep ``fill``. PIL's
    ``Image.transform(size, AFFINE, trans_inv, NEAREST, fillcolor=fill)``
    rule for rule: a pure scale (zero off-diagonals) tabulates columns in
    float64; otherwise 16.16 fixed point. PIL steps in float64 where the
    frame's corners map beyond +-32768; no KITTI crop does, and such a
    matrix raises."""
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    a = [float(v) for v in np.asarray(trans_inv, np.float64).reshape(-1)[:6]]
    out = np.full((H, W) + img.shape[2:], fill, img.dtype)
    if a[1] == 0 and a[3] == 0:
        xin = _coord(_running(a[2] + a[0] * 0.5, a[0], W))
        yin = _coord(_running(a[5] + a[4] * 0.5, a[4], H))
        xok = np.nonzero((xin >= 0) & (xin < w))[0]
        if xok.size:
            xmin, xmax = int(xok[0]), int(xok[-1]) + 1
            xtab = np.zeros(W, np.int64)
            xtab[xok] = xin[xok]
            rows = np.nonzero((yin >= 0) & (yin < h))[0]
            out[rows[:, None], np.arange(xmin, xmax)[None]] = img[
                yin[rows][:, None], xtab[None, xmin:xmax]]
        return out

    def fits(x, y):
        return abs(x * a[0] + y * a[1] + a[2]) < 32768.0 and abs(x * a[3] + y * a[4] + a[5]) < 32768.0

    if not (fits(0, 0) and fits(W, H) and fits(0, H) and fits(W, 0)):
        raise NotImplementedError(f"affine {a} maps the frame beyond PIL's fixed-point range")
    fix = [int(np.floor(v * 65536.0 + 0.5)) for v in
           (a[0], a[1], a[2] + a[0] * 0.5 + a[1] * 0.5, a[3], a[4],
            a[5] + a[3] * 0.5 + a[4] * 0.5)]
    ys, xs = np.arange(H, dtype=np.int64)[:, None], np.arange(W, dtype=np.int64)[None]
    xin = (fix[2] + ys * fix[1] + xs * fix[0]) >> 16
    yin = (fix[5] + ys * fix[4] + xs * fix[3]) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out[ok] = img[yin[ok], xin[ok]]
    return out


def warp_affine_bilinear(img: np.ndarray, trans_inv: np.ndarray, size) -> np.ndarray:
    """HWC uint8 ``img`` resampled onto ``size`` (W, H): output pixel (x, y)
    samples the source at ``trans_inv`` @ (x + 0.5, y + 0.5, 1), bilinearly
    between the pixel centres, in float64, truncated to uint8. A sample
    outside the source is 0; a tap beyond the edge takes the edge pixel.
    These are the rules of PIL's ``Image.transform(size, Image.AFFINE,
    trans_inv, Image.BILINEAR)``, which the JAX dataset calls."""
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    a = [float(v) for v in np.asarray(trans_inv, np.float64).reshape(-1)[:6]]
    xo = np.arange(W, dtype=np.float64)[None, :] + 0.5
    yo = np.arange(H, dtype=np.float64)[:, None] + 0.5
    xin = a[0] * xo + a[1] * yo + a[2]
    yin = a[3] * xo + a[4] * yo + a[5]
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    xs, ys = xin - 0.5, yin - 0.5
    x, y = np.floor(xs), np.floor(ys)
    dx, dy = (xs - x)[..., None], (ys - y)[..., None]
    x, y = x.astype(np.int64), y.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0, y1 = np.clip(y, 0, h - 1), np.clip(y + 1, 0, h - 1)
    src = img.astype(np.int64)

    def row(yy):  # the lerp along x on rows yy
        left = src[yy, x0]
        return left + (src[yy, x1] - left) * dx

    v1 = row(y0)
    v2 = np.where(((y + 1 >= 0) & (y + 1 < h))[..., None], row(y1), v1)
    v = v1 + (v2 - v1) * dy
    return np.where(inside[..., None], v, 0).astype(np.uint8)


class KITTIDataset:
    """root: the KITTI root holding training/{image_2,label_2,calib} and
    ImageSets/{train,val,trainval,test}.txt, or a split file directly.
    ``args`` is a mapping of the dataset options, with the JAX defaults:
    ``kitti_resolution``, ``cam_dis``, ``min_depth_threshold`` (1),
    ``max_depth_threshold`` (120), ``load_depth_maps``, and for the training
    splits ``fliplr`` (0.5), ``random_crop`` (0.5), ``min_scale`` (0.8),
    ``max_scale`` (1.2), ``translate`` (0.1), ``mixup`` (0.5) and ``seed``
    (5). Items drawn in order from one dataset are the JAX dataset's; a
    loader that reads items on several threads draws in thread order, in
    the port as in JAX."""

    def __init__(self, root, split: str = "val", args: Optional[Mapping[str, Any]] = None,
                 max_objs: int = MAX_OBJS):
        args = dict(args or {})
        self.max_objs = max_objs
        res = args.get("kitti_resolution")
        self.resolution = np.array(res) if res else RESOLUTION.copy()
        self.cls_mean_size = CLS_MEAN_SIZE.copy()
        self.writelist = list(CLASS_NAMES)
        self.use_camera_dis = bool(args.get("cam_dis", False))
        self.min_depth_thres = float(args.get("min_depth_threshold", 1.0))
        self.max_depth_threshold = float(args.get("max_depth_threshold", 120.0))
        self.random_flip = float(args.get("fliplr", 0.5))
        self.random_crop = float(args.get("random_crop", 0.5))
        self.min_scale = float(args.get("min_scale", 0.8))
        self.max_scale = float(args.get("max_scale", 1.2))
        self.shift = float(args.get("translate", 0.1))
        self.mixup = float(args.get("mixup", 0.5))
        self.seed = int(args.get("seed", 5))
        self.rng = np.random.default_rng(self.seed)

        root = Path(root)
        if root.is_file():  # a split file
            split_file = root
            root = root.parent.parent
        else:
            if root.name in ("training", "testing"):
                root = root.parent
            split_file = root / "ImageSets" / f"{split}.txt"
        self.split = split
        self.idx_list = [x.strip() for x in Path(split_file).read_text().splitlines() if x.strip()]
        self.data_dir = root / ("testing" if split == "test" else "training")
        self.image_dir = self.data_dir / "image_2"
        self.calib_dir = self.data_dir / "calib"
        self.label_dir = self.data_dir / "label_2"
        self.augmenting = split in ("train", "trainval")
        self.load_depth_maps = bool(args.get("load_depth_maps", False)) and split != "test"
        self.depth_dir = root / "deepseg" / "training" / "image_2"
        if self.load_depth_maps and not self.depth_dir.exists():
            raise FileNotFoundError(
                f"load_depth_maps=True but no segmentation dir at {self.depth_dir}")

    def __len__(self):
        return len(self.idx_list)

    # -- raw accessors --
    def get_image(self, idx: int) -> np.ndarray:
        """HWC RGB uint8 of frame ``idx`` (``.png`` or ``.jpg``) by PIL's
        rule, as the JAX dataset reads it (``Image.open(...).convert("RGB")``)."""
        for ext in (".png", ".jpg"):
            p = self.image_dir / f"{idx:06d}{ext}"
            if p.exists():
                return imread(p, "pil")
        raise FileNotFoundError(self.image_dir / f"{idx:06d}.png")

    def get_label(self, idx: int) -> List[Object3d]:
        return get_objects_from_label(self.label_dir / f"{idx:06d}.txt")

    def get_calib(self, idx: int) -> Calibration:
        return Calibration(self.calib_dir / f"{idx:06d}.txt")

    def get_segmentation(self, idx: int) -> np.ndarray:
        """The (H, W) uint8 instance mask of frame ``idx``: each pixel the
        label-file row of its object, the background SEG_BACKGROUND."""
        return imread(self.depth_dir / f"{idx:06d}_seg.png", "pil")[..., 0]

    def sample_id(self, item: int) -> int:
        return int(self.idx_list[item])

    def _object_valid(self, obj, scale: float) -> bool:
        """KITTI's validity filter: a written class, a known difficulty, in
        front of the minimum depth, truncation <= 0.5, occlusion <= 2."""
        if obj.cls_type not in self.writelist:
            return False
        if obj.level_str == "UnKnown" or obj.pos[-1] * scale < self.min_depth_thres:
            return False
        if obj.trucation > 0.5 or obj.occlusion > 2:
            return False
        return True

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        rng = self.rng
        index = self.sample_id(item)
        img = self.get_image(index)
        img_size = np.array([img.shape[1], img.shape[0]], np.float64)  # W, H
        center = img_size / 2
        crop_size = img_size.copy()
        calib = self.get_calib(index)
        scale = 1.0
        random_flip_flag = random_mix_flag = False

        seg_mask = self.get_segmentation(index) if self.load_depth_maps else None
        seg_mask_tmp = None

        if self.augmenting:  # the draws in the JAX dataset's order
            if rng.random() < 0.5 and self.mixup:
                random_mix_flag = True
            if rng.random() < self.random_flip:
                random_flip_flag = True
                img = img[:, ::-1]
                if seg_mask is not None:
                    seg_mask = seg_mask[:, ::-1]
            if rng.random() < self.random_crop:
                var = (self.max_scale - self.min_scale) / 2
                mean = (self.max_scale + self.min_scale) / 2
                scale = float(np.clip(rng.standard_normal() * var + mean, self.min_scale,
                                      self.max_scale))
                crop_size = img_size * scale
                center[0] += img_size[0] * float(np.clip(rng.standard_normal() * self.shift,
                                                         -2 * self.shift, 2 * self.shift))
                center[1] += img_size[1] * float(np.clip(rng.standard_normal() * self.shift,
                                                         -2 * self.shift, 2 * self.shift))

        mix_index = None
        if random_mix_flag:
            random_mix_flag = False
            for _ in range(50):  # a partner with the same intrinsics, size and room for labels
                cand = self.sample_id(int(rng.integers(len(self))))
                calib_tmp = self.get_calib(cand)
                if (calib_tmp.cu == calib.cu and calib_tmp.cv == calib.cv
                        and calib_tmp.fu == calib.fu and calib_tmp.fv == calib.fv):
                    img_tmp = self.get_image(cand)
                    if (img_tmp.shape[1], img_tmp.shape[0]) == tuple(img_size.astype(int)):
                        if len(self.get_label(index)) + len(self.get_label(cand)) < self.max_objs:
                            if self.load_depth_maps:
                                seg_mask_tmp = self.get_segmentation(cand)
                            if random_flip_flag:
                                img_tmp = img_tmp[:, ::-1]
                                if seg_mask_tmp is not None:
                                    seg_mask_tmp = seg_mask_tmp[:, ::-1]
                            img = blend(img, img_tmp, 0.5)
                            random_mix_flag = True
                            mix_index = cand
                            break

        trans, trans_inv = get_affine_transform(center, crop_size, 0, self.resolution, inv=1)
        seg_arrays = None
        if self.load_depth_maps:  # nearest warp, background 51 outside the frame
            seg_arrays = [warp_affine_nearest(m, trans_inv, self.resolution, fill=SEG_BACKGROUND)
                          for m in (seg_mask, seg_mask_tmp) if m is not None]
        depth_maps: List[np.ndarray] = []

        M = self.max_objs
        out = {
            "img": warp_affine_bilinear(np.ascontiguousarray(img), trans_inv,
                                        self.resolution),  # HWC uint8
            "gt_labels": np.zeros((M,), np.int32),
            "gt_bboxes": np.zeros((M, 4), np.float32),
            "gt_center_2d": np.zeros((M, 2), np.float32),
            "gt_size_2d": np.zeros((M, 2), np.float32),
            "gt_center_3d": np.zeros((M, 2), np.float32),
            "gt_size_3d": np.zeros((M, 3), np.float32),
            "gt_depth": np.zeros((M,), np.float32),
            "gt_heading_bin": np.zeros((M,), np.float32),
            "gt_heading_res": np.zeros((M,), np.float32),
            "mask_gt": np.zeros((M,), bool),
            "mean_sizes": self.cls_mean_size.astype(np.float32),
            "mixed": np.array(random_mix_flag, np.uint8),
        }
        # the calibration vector scaled into the resized frame
        rw = self.resolution[0] / img_size[0]
        rh = self.resolution[1] / img_size[1]
        out["calib"] = np.array(
            [calib.cu * rw, calib.cv * rh, calib.fu * rw, calib.fv * rh,
             calib.tx * rw, calib.ty * rh],
            np.float32,
        )
        out["img_id"] = np.array(index, np.int64)
        out["trans_inv"] = trans_inv.astype(np.float32)
        out["ori_shape"] = np.array([img_size[1], img_size[0]], np.float32)  # h, w

        if self.split == "test":
            return out

        count = 0
        sources = [index] + ([mix_index] if random_mix_flag and mix_index is not None else [])
        for src_i, src_index in enumerate(sources):
            objects = self.get_label(src_index)
            use_calib = calib
            if random_flip_flag:  # the labels and the calibration of the flipped frame
                use_calib = Calibration({"P2": calib.P2, "R0": calib.R0,
                                         "Tr_velo2cam": calib.V2C})
                use_calib.flip(img_size)
                for obj in objects:
                    x1, _, x2, _ = obj.box2d
                    obj.box2d[0], obj.box2d[2] = img_size[0] - x2, img_size[0] - x1
                    obj.ry = math.pi - obj.ry
                    obj.pos[0] *= -1
                    if obj.ry > math.pi:
                        obj.ry -= 2 * math.pi
                    if obj.ry < -math.pi:
                        obj.ry += 2 * math.pi

            for obj in objects[: min(len(objects), self.max_objs - count)]:
                if not self._object_valid(obj, scale):
                    continue
                bbox_2d = obj.box2d.copy()
                bbox_2d[:2] = affine_transform(bbox_2d[:2], trans)
                bbox_2d[2:] = affine_transform(bbox_2d[2:], trans)
                size_2d = bbox_2d[2:] - bbox_2d[:2]
                center_2d = (bbox_2d[:2] + bbox_2d[2:]) / 2

                center_3d_cam = obj.pos + [0, -obj.h / 2, 0]
                c3d_img, _ = use_calib.rect_to_img(center_3d_cam.reshape(1, 3))
                center_3d = affine_transform(c3d_img[0], trans)
                if not (0 <= int(center_3d[0]) < self.resolution[0]):
                    continue
                if not (0 <= int(center_3d[1]) < self.resolution[1]):
                    continue
                depth = obj.pos[-1] * scale
                if depth > self.max_depth_threshold:
                    continue
                if seg_arrays is not None:  # the object's depth plane on its mask
                    seg = seg_arrays[min(src_i, len(seg_arrays) - 1)]
                    depth_maps.append(np.where(seg == obj.line_index, depth, 1000.0))

                heading_angle = use_calib.ry2alpha(obj.ry, (obj.box2d[0] + obj.box2d[2]) / 2)
                if heading_angle > math.pi:
                    heading_angle -= 2 * math.pi
                if heading_angle < -math.pi:
                    heading_angle += 2 * math.pi
                hbin, hres = angle2class(heading_angle)

                cls_id = CLS2ID[obj.cls_type]
                j = count
                out["gt_labels"][j] = cls_id
                cxcywh = np.array([center_2d[0], center_2d[1], size_2d[0], size_2d[1]],
                                  np.float32)
                out["gt_bboxes"][j] = np.clip(cxcywh / self.resolution[[0, 1, 0, 1]], 0, 1)
                out["gt_center_2d"][j] = center_2d
                out["gt_size_2d"][j] = size_2d
                out["gt_center_3d"][j] = center_3d
                out["gt_size_3d"][j] = (
                    np.array([obj.h, obj.w, obj.l], np.float32) - self.cls_mean_size[cls_id]
                )
                if self.use_camera_dis:
                    out["gt_depth"][j] = float(np.linalg.norm(center_3d_cam * scale))
                else:
                    out["gt_depth"][j] = depth
                out["gt_heading_bin"][j] = hbin
                out["gt_heading_res"][j] = hres
                out["mask_gt"][j] = True
                count += 1
                if count >= self.max_objs:
                    break

        if self.load_depth_maps:  # the nearest plane per pixel; beyond the threshold: background
            if depth_maps:
                dm = np.minimum.reduce(depth_maps)
                dm = np.where(dm > self.max_depth_threshold, 0.0, dm)
            else:
                dm = np.zeros(seg_arrays[0].shape, np.float64)
            out["depth_map"] = dm.astype(np.float32)
        return out

    # -- evaluation I/O --
    def save_results(self, results: Dict[str, List], output_dir) -> str:
        """KITTI rows -> one ``preds/<id>.txt`` per image; returns the folder."""
        out_dir = Path(output_dir) / "preds"
        out_dir.mkdir(parents=True, exist_ok=True)
        for img_file, rows in results.items():
            lines = []
            for r in rows:
                name = CLASS_NAMES[int(r[0])]
                vals = " ".join(f"{v:.2f}" for v in r[1:])
                lines.append(f"{name} 0.0 0 {vals}")
            (out_dir / img_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return str(out_dir)

    def get_stats(self, results: Dict[str, List], save_dir) -> float:
        """Write the predictions and run the AP40 evaluator; fitness is 3D
        AP40, moderate, at IoU 0.7."""
        from ..eval.kitti_eval import eval_from_scratch

        pred_dir = self.save_results(results, save_dir)
        result = eval_from_scratch(str(self.label_dir), pred_dir, ap_mode=40)
        return result["3d@0.70"][1]

    def decode_preds(
        self, preds: np.ndarray, calibs: List[Calibration], im_files: List[str],
        inv_trans: np.ndarray, threshold: float = 0.001, bins: Optional[Dict] = None,
    ) -> Dict[str, List]:
        """Top-k predictions (B, K, 37): bbox (4), projected 3D centre (2),
        s3d (3), heading (24), depth, depth uncertainty, raw score logit,
        label -> KITTI rows [cls, alpha, x1, y1, x2, y2, h, w, l, x, y, z,
        ry, score] per image, in the original frame. The score is
        sigmoid(logit) * exp(-uncertainty); rows below ``threshold`` drop.
        A ``bins`` dict receives each image's heading bin per row."""
        results = {}
        for i in range(preds.shape[0]):
            rows, row_bins = [], []
            for j in range(preds.shape[1]):
                p = preds[i, j]
                score_raw = p[35]
                cls_id = int(p[36])
                bbox = p[:4]
                c3d = p[4:6]
                s3d = p[6:9] + self.cls_mean_size[cls_id]
                hd = p[9:33]
                dep = p[33]
                sigma = float(np.exp(-p[34]))
                score = float(1 / (1 + np.exp(-score_raw))) * sigma
                if score < threshold:
                    continue
                hbin = int(np.argmax(hd[:12]))
                hres = float(hd[12:][hbin])
                alpha = class2angle(hbin, hres, to_label_format=True)
                c3d_orig = affine_transform(c3d, inv_trans[i])
                if self.use_camera_dis:
                    loc = calibs[i].camera_dis_to_rect(c3d_orig[0], c3d_orig[1], dep)[0]
                else:
                    loc = calibs[i].img_to_rect(c3d_orig[0], c3d_orig[1], dep)[0]
                loc = loc.copy()
                loc[1] += s3d[0] / 2
                # the 2D box back in the original frame
                p1 = affine_transform(bbox[:2], inv_trans[i])
                p2 = affine_transform(bbox[2:], inv_trans[i])
                x_c = (p1[0] + p2[0]) / 2
                ry = calibs[i].alpha2ry(alpha, x_c)
                rows.append(
                    [cls_id, alpha, p1[0], p1[1], p2[0], p2[1]]
                    + s3d.tolist() + loc.tolist() + [ry, score]
                )
                row_bins.append(hbin)
            results[im_files[i]] = rows
            if bins is not None:
                bins[im_files[i]] = row_bins
        return results
