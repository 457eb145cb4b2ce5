"""YOLO-format detection dataset and loader (port of
``yolov10_3d_tpu/data/dataset.py``: the host augmentation mode, the tile
mode of the device-augmentation path, and the validation mode).

In host mode (``augment=True, device_aug=False``, or ``device_aug=True``
once ``mosaic`` is 0) ``YOLODataset`` returns the sample augmented on the
host by ``data/augment.py`` ``train_augment``, its mosaic partners served
from a buffer of recently decoded samples, with its labels padded to
``max_boxes``. In tile mode (``augment=True, device_aug=True`` while
``mosaic > 0``) it returns the four letterboxed uint8 tiles of a mosaic (the
sample and three partners drawn from ``self.rng``) with their labels in
tile-frame pixels; ``ops/device_aug.py`` does the rest on the device. In
validation mode (``augment=False``) it returns the image letterboxed without
upscaling, to imgsz or, after ``set_rectangle``, to its batch's shape, and
its labels padded. ``cache`` keeps decoded images in memory (``"ram"``) or
as ``<stem>.npy`` beside each image (``"disk"``, read back memory-mapped).
``DataLoader`` batches any of them, in a seeded per-epoch order or in file
order, with ``rect`` as whole batches of like aspect ratio and with
``multi_scale`` each batch's images resized by a scale of a fixed ladder.

Images are decoded without cv2 or PIL, by cv2's rule (``data/image_io.py``:
JPEG, PNG and BMP; ``decode_png`` is re-exported here).
"""

from __future__ import annotations

import hashlib
import os
import queue
import zipfile
from collections import deque
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .augment import NATIVE, HostOps, train_augment
from .image_io import IMG_FORMATS, decode_png, image_size, imread  # noqa: F401  (decode_png: re-exported)
from .preprocess import letterbox

PARTNER_BUFFER = 32  # samples kept for host mode's mosaic partners (JAX's buffer_size)
SCALE_CHOICES = (0.75, 1.0, 1.25)  # multi_scale's ladder (JAX's scale_choices)


def img2label_path(img_path: str) -> str:
    """.../images/.../x.png -> .../labels/.../x.txt (the last ``images`` only)."""
    import os

    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    p = str(img_path)
    if sa in p:
        p = sb.join(p.rsplit(sa, 1))
    return str(Path(p).with_suffix(".txt"))


def _atomic_write(path: Path, write) -> None:
    """``write(f)`` into a file beside ``path``, then renamed onto it: a
    reader (another rank of a data-parallel run) sees the whole file or
    none."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_image(path: str) -> np.ndarray:
    """HWC RGB uint8 of an image file by cv2's rule, as the JAX dataset reads
    (``cv2.imread``, EXIF orientation applied; ``data/image_io.py``)."""
    return imread(path, "cv2")


class YOLODataset:
    """Detection dataset over YOLO-format labels. In tile mode item ``i`` is
    {tiles (4, H, W, 3) uint8, tile_labels (4, M, 5) cls + xyxy px in the
    tile frame, tile_mask (4, M) bool} for the mosaic of sample i and three
    partners drawn from ``self.rng``; in host and validation mode it is {img
    (H, W, 3) uint8, gt_labels (M,), gt_bboxes (M, 4) normalized xywh,
    mask_gt (M,), im_id}, the image augmented (``train_augment`` with
    ``self.rng``, the cv2 operations from ``ops``) or letterboxed to imgsz
    (or its ``rect_shapes`` entry) without upscaling. ``img_path`` is a
    directory of images or a .txt list of image paths; labels live under the
    parallel ``labels`` directory. ``cache``: None, ``"ram"`` or ``"disk"``
    (any other value caches nothing, as in JAX)."""

    def __init__(
        self,
        img_path: Union[str, Path],
        imgsz: Union[int, Tuple[int, int]] = 640,
        hyp: Optional[Dict] = None,
        max_boxes: int = 100,
        fraction: float = 1.0,
        single_cls: bool = False,
        seed: int = 0,
        augment: bool = True,
        device_aug: bool = True,
        ops: HostOps = NATIVE,
        cache: Optional[str] = None,
    ):
        self.augment = augment
        self.device_aug = device_aug
        self.ops = ops
        self.imgsz = (imgsz, imgsz) if isinstance(imgsz, int) else (imgsz[1], imgsz[0])
        self.hyp = dict(hyp or {})
        self.max_boxes = max_boxes
        self.single_cls = single_cls
        self.rng = np.random.default_rng(seed)
        self.im_files = self._scan(img_path)
        if fraction < 1.0:
            self.im_files = self.im_files[: max(1, round(len(self.im_files) * fraction))]
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.cache = cache
        self._ram: List[Optional[np.ndarray]] = [None] * len(self.im_files)
        self.rect_shapes: Optional[np.ndarray] = None  # (N, 2) h, w after set_rectangle
        self.labels = self._load_labels(Path(img_path))
        # the mosaic partners of host mode come from recently decoded samples
        self._buffer: deque = deque(maxlen=PARTNER_BUFFER)

    # -- labels, cached in labels.cache.npz beside the images --
    def _labels_hash(self) -> str:
        """Content hash over image and label paths, sizes and mtimes."""
        h = hashlib.sha256()
        for f in self.im_files + self.label_files:
            p = Path(f)
            st = p.stat() if p.exists() else None
            h.update(f.encode())
            h.update(str((st.st_size, st.st_mtime_ns) if st else None).encode())
        return h.hexdigest()

    def _parse_label_file(self, i: int) -> np.ndarray:
        """(n, 5) cls + normalized xywh rows; rows of fewer than 5 values are
        skipped and coordinates clipped to [0, 1]."""
        lp = Path(self.label_files[i])
        if not lp.exists():
            return np.zeros((0, 5), np.float32)
        rows = []
        for line in lp.read_text().splitlines():
            vals = line.split()
            if len(vals) < 5:
                continue
            row = [float(v) for v in vals[:5]]
            if not all(0.0 <= v <= 1.0 for v in row[1:5]):
                row[1:5] = list(np.clip(row[1:5], 0.0, 1.0))
            rows.append(row)
        return np.array(rows, np.float32) if rows else np.zeros((0, 5), np.float32)

    def _load_labels(self, root: Path) -> List[np.ndarray]:
        cache_path = (root if root.is_dir() else root.parent) / "labels.cache.npz"
        want = self._labels_hash()
        try:
            z = np.load(cache_path, allow_pickle=False)
            if str(z["hash"]) == want and int(z["n"]) == len(self.im_files):
                return [z[f"l{i}"] for i in range(len(self.im_files))]
        except (FileNotFoundError, KeyError, ValueError, OSError, zipfile.BadZipFile):
            pass
        labels = [self._parse_label_file(i) for i in range(len(self.im_files))]
        try:  # written whole or not at all: data-parallel ranks read it meanwhile
            _atomic_write(cache_path, lambda f: np.savez_compressed(
                f, hash=want, n=len(labels), **{f"l{i}": lab for i, lab in enumerate(labels)}))
        except OSError:  # a read-only dataset directory: the cache is optional
            pass
        return labels

    @staticmethod
    def _scan(img_path) -> List[str]:
        p = Path(img_path)
        if p.is_file() and p.suffix == ".txt":
            lines = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
            return [ln if Path(ln).is_absolute() else str((p.parent / ln).resolve())
                    for ln in lines]
        if p.is_dir():
            files = sorted(str(f) for f in p.rglob("*") if f.suffix[1:].lower() in IMG_FORMATS)
            if not files:
                raise FileNotFoundError(f"no images found under {p}")
            return files
        raise FileNotFoundError(f"invalid dataset path {img_path}")

    def __len__(self) -> int:
        return len(self.im_files)

    # -- the image cache --
    def _disk_cache_path(self, i: int) -> Path:
        p = Path(self.im_files[i])
        return p.parent / (p.stem + ".npy")

    def _load_cached_image(self, i: int) -> np.ndarray:
        """Image i: kept in ``_ram`` after its first decode (``"ram"``), or
        read from its ``.npy`` memory-mapped, written there after its first
        decode (``"disk"``; a directory that cannot be written caches
        nothing)."""
        if self.cache == "ram":
            if self._ram[i] is None:
                self._ram[i] = _load_image(self.im_files[i])
            return self._ram[i]
        if self.cache == "disk":
            npy = self._disk_cache_path(i)
            if npy.exists():
                return np.load(npy, mmap_mode="r")
            img = _load_image(self.im_files[i])
            try:
                _atomic_write(npy, lambda f: np.save(f, img))
            except OSError:
                pass
            return img
        return _load_image(self.im_files[i])

    # -- rect batches --
    def image_shapes(self) -> np.ndarray:
        """(N, 2) h, w of every image from its header (``image_size``: the
        size as stored, EXIF orientation not applied, as PIL's size)."""
        if getattr(self, "_shapes", None) is None:
            out = np.zeros((len(self.im_files), 2), np.int64)
            for i, f in enumerate(self.im_files):
                w, h = image_size(Path(f).read_bytes(), f)
                out[i] = (h, w)
            self._shapes = out
        return self._shapes

    def set_rectangle(self, batch_size: int, stride: int = 32, pad: float = 0.0) -> np.ndarray:
        """Sort the images by aspect ratio h / w (stable) and give each batch
        of ``batch_size`` one stride-aligned shape: ``rect_shapes`` (N, 2)
        h, w. The files, labels and caches are reordered with the images,
        training sets too (their augmented items ignore the shapes)."""
        shapes = self.image_shapes().astype(np.float64)
        ar = shapes[:, 0] / shapes[:, 1]
        order = np.argsort(ar, kind="stable")
        self.im_files = [self.im_files[i] for i in order]
        self.label_files = [self.label_files[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        self._ram = [self._ram[i] for i in order]
        self._shapes = self._shapes[order]
        ar = ar[order]
        h0, w0 = self.imgsz
        self.rect_shapes = np.zeros((len(ar), 2), np.int64)
        for b in range(int(np.ceil(len(ar) / batch_size))):
            sel = slice(b * batch_size, (b + 1) * batch_size)
            mini, maxi = ar[sel].min(), ar[sel].max()
            shape = [1.0, 1.0]
            if maxi < 1:
                shape = [maxi, 1.0]
            elif mini > 1:
                shape = [1.0, 1.0 / mini]
            self.rect_shapes[sel] = np.ceil(np.array(shape) * np.array([h0, w0]) / stride
                                            + pad).astype(int) * stride
        return self.rect_shapes

    def _raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(img HWC RGB uint8, labels (n, 5) cls + xyxy px)."""
        img = np.asarray(self._load_cached_image(i))
        h, w = img.shape[:2]
        lab = self.labels[i]
        if not len(lab):
            return img, np.zeros((0, 5), np.float32)
        cls = np.zeros_like(lab[:, 0]) if self.single_cls else lab[:, 0]
        cx, cy, bw, bh = lab[:, 1] * w, lab[:, 2] * h, lab[:, 3] * w, lab[:, 4] * h
        labels = np.stack([cls, cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                          -1).astype(np.float32)
        return img, labels

    @property
    def tile_mode(self) -> bool:
        """Tiles for the device augmentation, until ``close_mosaic``."""
        return self.augment and self.device_aug and self.hyp.get("mosaic", 1.0) > 0

    def close_mosaic(self) -> None:
        """No mosaic and no mixup from here on: the last epochs' host path."""
        self.hyp["mosaic"] = 0.0
        self.hyp["mixup"] = 0.0

    def _make_buffered_raw(self, primary: int, rng: Optional[np.random.Generator] = None,
                           buf: Optional[deque] = None, fresh: Optional[list] = None):
        """``get_item(i)`` for ``train_augment``: the primary sample is always
        decoded (and joins the buffer); a partner is drawn from the buffer
        once it holds min(maxlen, 4) samples, else decoded and added. ``rng``
        and ``buf`` default to the dataset's own; the decoded samples are
        also appended to ``fresh``."""
        rng = self.rng if rng is None else rng
        buf = self._buffer if buf is None else buf

        def get_item(i: int):
            if i != primary and buf.maxlen and len(buf) >= min(buf.maxlen, 4):
                img, labels = buf[int(rng.integers(len(buf)))]
                return img, labels.copy()
            img, labels = self._raw(i)
            if buf.maxlen:
                buf.append((img, labels))
                if fresh is not None:
                    fresh.append((img, labels))
            return img, labels.copy()

        return get_item

    def host_item(self, i: int, rng: Optional[np.random.Generator] = None,
                  buf: Optional[deque] = None, fresh: Optional[list] = None
                  ) -> Dict[str, np.ndarray]:
        """Sample i augmented on the host, in the fixed (max_boxes, ...) layout."""
        img, labels = train_augment(self._make_buffered_raw(i, rng, buf, fresh), i, len(self),
                                    self.rng if rng is None else rng, self.imgsz, self.hyp,
                                    self.ops)
        return self._format_detect(img, labels, i)

    def tile_indices(self, i: int) -> List[int]:
        """Sample i and its three mosaic partners, drawn from ``self.rng``."""
        return [i] + [int(self.rng.integers(0, len(self))) for _ in range(3)]

    def load_tiles(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        """The four samples ``idxs`` letterboxed to imgsz, with their labels."""
        th, tw = self.imgsz
        M = self.max_boxes
        tiles = np.zeros((4, th, tw, 3), np.uint8)
        tlab = np.zeros((4, M, 5), np.float32)
        tmask = np.zeros((4, M), bool)
        for t, j in enumerate(idxs):
            img, labels = self._raw(j)
            tiles[t], ratio, (dw, dh) = letterbox(img, (th, tw), scaleup=True)
            n = min(len(labels), M)
            if n:
                lab = labels[:n].copy()
                lab[:, [1, 3]] = lab[:, [1, 3]] * ratio + dw
                lab[:, [2, 4]] = lab[:, [2, 4]] * ratio + dh
                tlab[t, :n] = lab
                tmask[t, :n] = True
        return {"tiles": tiles, "tile_labels": tlab, "tile_mask": tmask}

    def tiles_item(self, i: int) -> Dict[str, np.ndarray]:
        return self.load_tiles(self.tile_indices(i))

    def val_item(self, i: int) -> Dict[str, np.ndarray]:
        """Image ``i`` letterboxed to imgsz (its rect shape after
        ``set_rectangle``) without upscaling, its labels in the fixed
        (max_boxes, ...) layout."""
        img, labels = self._raw(i)
        target = tuple(self.rect_shapes[i]) if self.rect_shapes is not None else self.imgsz
        img, ratio, (dw, dh) = letterbox(img, target, scaleup=False)
        if len(labels):
            labels = labels.copy()
            labels[:, [1, 3]] = labels[:, [1, 3]] * ratio + dw
            labels[:, [2, 4]] = labels[:, [2, 4]] * ratio + dh
        return self._format_detect(img, labels, i)

    def _format_detect(self, img: np.ndarray, labels: np.ndarray, i: int) -> Dict[str, np.ndarray]:
        """(n, 5) cls + xyxy px labels padded to the fixed (M, ...) layout."""
        h, w = img.shape[:2]
        M = self.max_boxes
        gt_labels = np.zeros((M,), np.int32)
        gt_bboxes = np.zeros((M, 4), np.float32)
        mask = np.zeros((M,), bool)
        n = min(len(labels), M)
        if n:
            lab = labels[:n]
            gt_labels[:n] = lab[:, 0].astype(np.int32)
            xyxy = lab[:, 1:5]
            xywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2, xyxy[:, 2:] - xyxy[:, :2]], -1)
            gt_bboxes[:n] = xywh / np.array([w, h, w, h], np.float32)
            mask[:n] = (xywh[:, 2] > 1) & (xywh[:, 3] > 1)
        return {"img": np.ascontiguousarray(img), "gt_labels": gt_labels, "gt_bboxes": gt_bboxes,
                "mask_gt": mask, "im_id": np.asarray(i, np.int64)}

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.tile_mode:
            return self.tiles_item(i)
        return self.host_item(i) if self.augment else self.val_item(i)


def batch_scale(seed: int, epoch: int, b: int,
                choices: Sequence[float] = SCALE_CHOICES) -> float:
    """multi_scale's scale of batch ``b`` of an epoch: a draw of
    ``default_rng((seed + epoch) * 100003 + b)`` from the ladder (JAX's
    ``_batch_scale``)."""
    return float(np.random.default_rng((seed + epoch) * 100003 + b).choice(choices))


def resize_batch(batch: Dict[str, np.ndarray], scale: float, resize=NATIVE.resize,
                 stride: int = 32) -> Dict[str, np.ndarray]:
    """The stacked images of ``batch["img"]`` (B, H, W, C) resized by
    ``scale`` to stride-aligned sides, image by image with cv2's
    INTER_LINEAR rule (``resize(img, (w, h))``), the other keys untouched
    (normalized boxes do not change; JAX's ``_resize_batch``). A batch
    without ``img`` (tiles) is returned as it is."""
    if "img" not in batch or scale == 1.0:
        return batch
    img = batch["img"]
    h, w = img.shape[1:3]
    nh = max(int(round(h * scale / stride)) * stride, stride)
    nw = max(int(round(w * scale / stride)) * stride, stride)
    if (nh, nw) == (h, w):
        return batch
    out = np.empty((img.shape[0], nh, nw, img.shape[3]), img.dtype)
    for i in range(img.shape[0]):
        out[i] = resize(np.ascontiguousarray(img[i]), (nw, nh))
    return {**batch, "img": out}


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


class DataLoader:
    """Batches of a ``YOLODataset`` as torch tensors (pinned when asked): in
    the order of ``np.random.default_rng(seed + epoch)`` with ``shuffle``,
    else in file order; the short last batch dropped with ``drop_last``
    (training), kept without (validation). With ``rect`` the dataset is
    sorted by aspect ratio (``set_rectangle``, at the first call) and cut
    into whole batches, which ``shuffle`` permutes; with ``multi_scale``
    each batch's images are resized by ``batch_scale`` (``resize_batch``,
    the dataset's ``ops.resize``). These follow JAX's ``_batches``,
    ``_batch_scale`` and ``_resize_batch``.

    ``workers=0`` loads in the caller's thread, item by item, as the JAX
    loader does on one thread. Otherwise a producer thread makes the draws
    that order the batch (so a batch does not depend on thread timing) and
    loads the items on a pool of ``workers`` threads, two batches ahead: in
    tile mode it draws every sample's mosaic partners in order; in host mode
    it draws one generator seed per sample in order, each sample's partners
    come from the buffer as it stood at the batch's start, and the samples it
    decoded join the buffer in order after the batch. The threads are
    stopped and joined when the iteration ends, fails or is abandoned."""

    PREFETCH = 2

    def __init__(self, dataset: YOLODataset, batch_size: int, seed: int = 0, workers: int = 4,
                 pin_memory: bool = False, shuffle: bool = True, drop_last: bool = True,
                 rect: bool = False, multi_scale: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.workers = max(0, int(workers))
        self.pin_memory = pin_memory
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rect = rect
        self.multi_scale = multi_scale
        self.epoch = 0

    def __len__(self) -> int:
        return len(self._batches())

    def _batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        bs = self.batch_size
        if self.rect and hasattr(self.dataset, "set_rectangle"):
            if self.dataset.rect_shapes is None:
                self.dataset.set_rectangle(bs)
            batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
            if self.shuffle:
                perm = np.random.default_rng(self.seed + self.epoch).permutation(len(batches))
                batches = [batches[i] for i in perm]
        else:
            if self.shuffle:
                np.random.default_rng(self.seed + self.epoch).shuffle(idx)
            batches = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        return [b for b in batches if len(b) == bs] if self.drop_last else batches

    def _collate(self, sel: np.ndarray, map_fn=None, scale: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
        ds = self.dataset
        if ds.tile_mode:
            idxs = [ds.tile_indices(int(i)) for i in sel]  # draws in order
            items = list((map_fn or map)(ds.load_tiles, idxs))
        elif not ds.augment:
            items = list((map_fn or map)(ds.val_item, [int(i) for i in sel]))
        elif map_fn is None:
            items = [ds.host_item(int(i)) for i in sel]
        else:
            seeds = [int(ds.rng.integers(2**63)) for _ in sel]  # draws in order
            start = tuple(ds._buffer)

            def load(k: int):
                fresh: list = []
                buf = deque(start, maxlen=ds._buffer.maxlen)
                item = ds.host_item(int(sel[k]), np.random.default_rng(seeds[k]), buf, fresh)
                return item, fresh

            done = list(map_fn(load, range(len(sel))))
            items = [item for item, _ in done]
            for _, fresh in done:
                ds._buffer.extend(fresh)
        stacked = resize_batch({k: np.stack([it[k] for it in items]) for k in items[0]}, scale,
                               ds.ops.resize)
        out = {k: torch.from_numpy(v) for k, v in stacked.items()}
        return {k: v.pin_memory() for k, v in out.items()} if self.pin_memory else out

    def _scale(self, b: int) -> float:
        return batch_scale(self.seed, self.epoch, b) if self.multi_scale else 1.0

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = self._batches()
        if self.workers == 0:
            for b, sel in enumerate(batches):
                yield self._collate(sel, scale=self._scale(b))
            self.epoch += 1
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="yolo-loader")

        def put(item) -> bool:  # False once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b, sel in enumerate(batches):
                    if stop.is_set() or not put(self._collate(sel, pool.map, self._scale(b))):
                        return
                put(_END)
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failure(e))

        producer = threading.Thread(target=produce, name="yolo-loader-producer", daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _Failure):
                    raise item.error
                yield item
            self.epoch += 1
        finally:
            stop.set()
            producer.join()
            pool.shutdown(wait=True, cancel_futures=True)


class DictLoader:
    """Batches of a dataset whose items are dicts of numpy arrays
    (``KITTIDataset``), each key stacked, as the JAX DataLoader collates them:
    in order with the last batch kept short (validation), or with
    ``shuffle`` (training) in the order of ``np.random.default_rng(seed +
    epoch)``, the short last batch dropped (set ``epoch`` before each epoch).
    ``workers=0`` loads in the caller's thread, so a dataset that draws from
    its own generator (the KITTI training splits) yields the same items as
    the JAX loader on one thread; otherwise a pool of ``workers`` threads
    loads the next batch's items while the caller works on this one, and is
    joined when the iteration ends, fails or is abandoned. ``multi_scale``
    resizes each batch's ``img`` as ``DataLoader`` does and leaves every
    other key as it is, pixel coordinates and calibration included: the
    JAX loader does the same to a 3D batch."""

    def __init__(self, dataset, batch_size: int, workers: int = 0, shuffle: bool = False,
                 seed: int = 0, multi_scale: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.workers = max(0, int(workers))
        self.shuffle = shuffle
        self.seed = seed
        self.multi_scale = multi_scale
        self.epoch = 0

    def __len__(self) -> int:
        return len(self._batches())

    def _batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        bs = self.batch_size
        if not self.shuffle:
            return [idx[i:i + bs] for i in range(0, len(idx), bs)]
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i:i + bs] for i in range(0, len(idx) - bs + 1, bs)]

    @staticmethod
    def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _scaled(self, batch: Dict[str, np.ndarray], b: int) -> Dict[str, np.ndarray]:
        if not self.multi_scale:
            return batch
        return resize_batch(batch, batch_scale(self.seed, self.epoch, b))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        if self.workers == 0:
            for b, sel in enumerate(batches):
                yield self._scaled(self.collate([self.dataset[int(i)] for i in sel]), b)
            return
        pool = ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="dict-loader")
        try:
            load = self.dataset.__getitem__
            pending = [pool.submit(load, int(i)) for i in batches[0]] if batches else []
            for b in range(len(batches)):
                items = [f.result() for f in pending]
                pending = ([pool.submit(load, int(i)) for i in batches[b + 1]]
                           if b + 1 < len(batches) else [])
                yield self._scaled(self.collate(items), b)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
