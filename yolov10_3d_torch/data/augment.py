"""The host training augmentation for detection (port of
``yolov10_3d_tpu/data/augment.py``): mosaic (4 or 9 images), the random
affine or perspective warp with its candidate filter, mixup, the HSV jitter
and the flips, chained by ``train_augment`` as the JAX package chains them.

Labels are (n, 5) cls + xyxy in absolute pixels throughout. Every random
draw comes from the caller's ``np.random.Generator`` in the JAX package's
order, so one seed yields the JAX package's items bit for bit: its cv2
operations are the rules of ``data/cv2_rules.py``, run by the host library
``native/host_aug.py`` (``NATIVE``, the default) or by the numpy rules
themselves (``TWIN``), which give the same bytes.

Left out of the JAX module: ``copy_paste`` acts only on segment polygons
(the segment task, ROADMAP queue 1, item 13), and
``albumentations_transform`` is unreachable there (``albumentations`` is no
key of ``get_cfg``, so its probability is 0 and it draws nothing). The
per-instance ``points`` of the pose, OBB and segment tasks are left out with
them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

from ..native import host_aug
from . import cv2_rules
from .preprocess import letterbox, resize_linear

Item = Tuple[np.ndarray, np.ndarray]  # (img HWC RGB uint8, labels (n, 5) cls + xyxy px)


class HostOps(NamedTuple):
    """The cv2 operations the augmentation calls (``cv2_rules`` signatures)."""

    warp_affine: Callable
    warp_perspective: Callable
    resize: Callable
    hsv_lut: Callable


NATIVE = HostOps(host_aug.warp_affine, host_aug.warp_perspective, host_aug.resize_linear,
                 host_aug.hsv_lut)
TWIN = HostOps(cv2_rules.warp_affine, cv2_rules.warp_perspective, resize_linear,
               cv2_rules.hsv_lut)


def random_hsv(img: np.ndarray, rng: np.random.Generator, hgain=0.015, sgain=0.7, vgain=0.4,
               ops: HostOps = NATIVE) -> np.ndarray:
    """HSV jitter through one 3-channel table (JAX ``random_hsv``)."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        dtype = img.dtype
        x = np.arange(0, 256, dtype=r.dtype)
        lut = np.stack([((x * r[0]) % 180).astype(dtype), np.clip(x * r[1], 0, 255).astype(dtype),
                        np.clip(x * r[2], 0, 255).astype(dtype)], -1)
        img = ops.hsv_lut(img, lut)
    return img


def random_flip_lr(img: np.ndarray, labels: np.ndarray, rng: np.random.Generator, p=0.5):
    """Horizontal flip with probability p."""
    if rng.random() < p:
        img = np.ascontiguousarray(img[:, ::-1])
        w = img.shape[1]
        if len(labels):
            x1 = labels[:, 1].copy()
            labels[:, 1] = w - labels[:, 3]
            labels[:, 3] = w - x1
    return img, labels


def random_flip_ud(img: np.ndarray, labels: np.ndarray, rng: np.random.Generator, p=0.0):
    """Vertical flip with probability p (no draw when p is 0)."""
    if p and rng.random() < p:
        img = np.ascontiguousarray(img[::-1])
        h = img.shape[0]
        if len(labels):
            y1 = labels[:, 2].copy()
            labels[:, 2] = h - labels[:, 4]
            labels[:, 4] = h - y1
    return img, labels


def mosaic4(items: List[Item], imgsz: Tuple[int, int], rng: np.random.Generator) -> Item:
    """Four images around a random centre on a (2h, 2w) grey canvas."""
    sh, sw = imgsz
    yc = int(rng.uniform(sh // 2, 2 * sh - sh // 2))
    xc = int(rng.uniform(sw // 2, 2 * sw - sw // 2))
    canvas = np.full((sh * 2, sw * 2, 3), 114, np.uint8)
    out = []
    for i, (img, labels) in enumerate(items):
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, sw * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(sh * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, sw * 2), min(sh * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        if len(labels):
            lab = labels.copy()
            lab[:, [1, 3]] += x1a - x1b
            lab[:, [2, 4]] += y1a - y1b
            out.append(lab)
    labels = np.concatenate(out) if out else np.zeros((0, 5), np.float32)
    labels[:, 1:] = labels[:, 1:].clip(0, [sw * 2, sh * 2, sw * 2, sh * 2])
    return canvas, labels


def mosaic9(items: List[Item], imgsz: Tuple[int, int], rng: np.random.Generator,
            ops: HostOps = NATIVE) -> Item:
    """Nine images in a 3x3 grid (each shrunk to fit imgsz), cropped to a
    (2h, 2w) window at a random offset."""
    sh, sw = imgsz
    canvas = np.full((sh * 3, sw * 3, 3), 114, np.uint8)
    hp = wp = -1  # the previous tile's h, w
    out = []
    for i, (img, labels) in enumerate(items):
        h, w = img.shape[:2]
        r = min(sh / h, sw / w)
        if r < 1.0:
            img = ops.resize(img, (max(int(w * r), 1), max(int(h * r), 1)))
            if len(labels):
                labels = labels.copy()
                labels[:, 1:5] *= r
            h, w = img.shape[:2]
        if i == 0:  # centre
            c = sw, sh, sw + w, sh + h
            h0, w0 = h, w
        elif i == 1:  # top
            c = sw, sh - h, sw + w, sh
        elif i == 2:  # top right
            c = sw + wp, sh - h, sw + wp + w, sh
        elif i == 3:  # right
            c = sw + w0, sh, sw + w0 + w, sh + h
        elif i == 4:  # bottom right
            c = sw + w0, sh + hp, sw + w0 + w, sh + hp + h
        elif i == 5:  # bottom
            c = sw + w0 - w, sh + h0, sw + w0, sh + h0 + h
        elif i == 6:  # bottom left
            c = sw + w0 - wp - w, sh + h0, sw + w0 - wp, sh + h0 + h
        elif i == 7:  # left
            c = sw - w, sh + h0 - h, sw, sh + h0
        else:  # top left
            c = sw - w, sh + h0 - hp - h, sw, sh + h0 - hp
        pad_x, pad_y = c[:2]
        x1, y1 = max(c[0], 0), max(c[1], 0)
        x2, y2 = min(c[2], 3 * sw), min(c[3], 3 * sh)
        canvas[y1:y2, x1:x2] = img[y1 - pad_y:y2 - pad_y, x1 - pad_x:x2 - pad_x]
        if len(labels):
            lab = labels.copy()
            lab[:, [1, 3]] += pad_x
            lab[:, [2, 4]] += pad_y
            out.append(lab)
        hp, wp = h, w
    yc = int(rng.uniform(0, sh))
    xc = int(rng.uniform(0, sw))
    canvas = canvas[yc:yc + 2 * sh, xc:xc + 2 * sw]
    labels = np.concatenate(out) if out else np.zeros((0, 5), np.float32)
    if len(labels):
        labels[:, [1, 3]] -= xc
        labels[:, [2, 4]] -= yc
        labels[:, 1:] = labels[:, 1:].clip(0, [sw * 2, sh * 2, sw * 2, sh * 2])
        wh = labels[:, 3:5] - labels[:, 1:3]
        labels = labels[(wh > 2).all(1)]
    return canvas, labels


def random_perspective(img: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
                       degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
                       border: Tuple[int, int] = (0, 0), ops: HostOps = NATIVE) -> Item:
    """The random affine (or perspective) warp of the canvas to its size
    plus 2·border, the boxes' corners through the same matrix, and the
    candidate filter."""
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2_rules.get_rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = ops.warp_perspective(img, M, (w, h), (114, 114, 114))
        else:
            img = ops.warp_affine(img, M[:2], (w, h), (114, 114, 114))

    n = len(labels)
    if n:
        boxes = labels[:, 1:5]
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        # the candidate filter: more than 2 px each way, more than 10% of the
        # scaled area left, aspect ratio under 100
        w1 = boxes[:, 2] - boxes[:, 0]
        h1 = boxes[:, 3] - boxes[:, 1]
        w2 = new[:, 2] - new[:, 0]
        h2 = new[:, 3] - new[:, 1]
        ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
        keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * s ** 2 + 1e-16) > 0.1) & (ar < 100)
        labels = labels[keep]
        labels[:, 1:5] = new[keep]
    return img, labels


def mixup(img1: np.ndarray, labels1: np.ndarray, img2: np.ndarray, labels2: np.ndarray,
          rng: np.random.Generator) -> Item:
    """Beta(32, 32) blend of two images; the labels of both."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([labels1, labels2], 0)


def train_augment(get_item: Callable[[int], Item], index: int, n_items: int,
                  rng: np.random.Generator, imgsz: Tuple[int, int], hyp: Dict[str, float],
                  ops: HostOps = NATIVE) -> Item:
    """The v8 training pipeline: mosaic (probability ``mosaic``; 9 images
    with probability ``mosaic9``) or the letterbox, the random warp (the
    mosaic canvas 2s to s), mixup with a second warped mosaic (probability
    ``mixup``, mosaic samples only), HSV, vertical and horizontal flips.
    ``get_item(i)`` loads the raw sample i as (img, labels)."""
    sh, sw = imgsz

    def warp(img, labels, border):
        return random_perspective(
            img, labels, rng, degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.4),
            shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0),
            border=border, ops=ops)

    use_mosaic = rng.random() < hyp.get("mosaic", 1.0)
    if use_mosaic:
        if rng.random() < hyp.get("mosaic9", 0.0):
            idxs = [index] + [int(rng.integers(0, n_items)) for _ in range(8)]
            img, labels = mosaic9([get_item(i) for i in idxs], imgsz, rng, ops)
        else:
            idxs = [index] + [int(rng.integers(0, n_items)) for _ in range(3)]
            img, labels = mosaic4([get_item(i) for i in idxs], imgsz, rng)
        border = (-sh // 2, -sw // 2)
    else:
        img, labels = get_item(index)
        img, ratio, (dw, dh) = letterbox(img, (sh, sw), resize=ops.resize)
        if len(labels):
            labels[:, [1, 3]] = labels[:, [1, 3]] * ratio + dw
            labels[:, [2, 4]] = labels[:, [2, 4]] * ratio + dh
        border = (0, 0)
    img, labels = warp(img, labels, border)
    if use_mosaic and rng.random() < hyp.get("mixup", 0.0):
        img2, labels2 = mosaic4([get_item(int(rng.integers(0, n_items))) for _ in range(4)],
                                imgsz, rng)
        img2, labels2 = warp(img2, labels2, (-sh // 2, -sw // 2))
        img, labels = mixup(img, labels, img2, labels2, rng)
    img = random_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                     hyp.get("hsv_v", 0.4), ops)
    img, labels = random_flip_ud(img, labels, rng, hyp.get("flipud", 0.0))
    return random_flip_lr(img, labels, rng, hyp.get("fliplr", 0.5))
