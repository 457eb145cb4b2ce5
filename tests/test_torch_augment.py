"""The port's training data path against the JAX package on the CPU: K4's
twin (the HSV jitter), the device augmentation fed JAX's random draws, the
PNG decoder, the tile-mode dataset, the loader's batch order, the loader's
threads, and a one-epoch run of ``YOLOv10.train``."""

import colorsys
import csv
import gc
import struct
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolov10_3d_tpu.ops.device_aug import device_train_augment as jax_device_train_augment
from yolov10_3d_tpu.ops.pallas_preprocess import hsv_jitter as jax_hsv_jitter
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.dataset import DataLoader, YOLODataset, decode_png
from yolov10_3d_torch.kernels import hsv as K4
from yolov10_3d_torch.ops.device_aug import augment_core, device_train_augment

HYP = {"mosaic": 1.0}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is as fast, and the test
    workers that run side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hsv_twin_matches_tpu_kernel_and_colorsys():
    """The twin against the Pallas kernel in interpret mode (1e-6), with
    identity gains against the input (1e-5) and against colorsys per pixel
    (1e-4), as tests/test_pallas_preprocess.py holds the TPU kernel. The
    image has grey pixels and pixels on every hue-sector boundary."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (3, 8, 128, 3)).astype(np.float32)
    imgs[:, 0, :6] = [[0.5, 0.5, 0.5], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]]
    imgs[:, 1, :2] = 0.0
    gains = np.array([[1.0, 1.0, 1.0], [0.95, 1.3, 0.8], [1.015, 0.3, 1.4]], np.float32)
    want = np.asarray(jax_hsv_jitter(jnp.asarray(imgs), jnp.asarray(gains), interpret=True))
    got = K4.hsv_jitter(torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(gains)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], imgs[0], rtol=0, atol=1e-5)
    for b in (1, 2):
        for y, x in [(0, 0), (0, 3), (1, 0), (3, 50), (7, 127)]:
            h, s, v = colorsys.rgb_to_hsv(*imgs[b, y, x])
            h = (h * gains[b][0]) % 1.0
            s = min(max(s * gains[b][1], 0.0), 1.0)
            v = min(max(v * gains[b][2], 0.0), 1.0)
            np.testing.assert_allclose(got[b, y, x], colorsys.hsv_to_rgb(h, s, v), atol=1e-4)


def test_hsv_wrapper_refuses_what_it_cannot_launch():
    """No silent fallback: the CUDA wrapper refuses CPU tensors, the
    dispatcher refuses other devices and runs the twin on the CPU without
    counting a launch."""
    img, gains = torch.zeros((1, 3, 4, 4)), torch.ones((1, 3))
    with pytest.raises(ValueError, match="CUDA"):
        K4.hsv_jitter_cuda(img, gains)
    with pytest.raises(ValueError, match="unsupported device"):
        K4.hsv_jitter(img.to("meta"), gains.to("meta"))
    before = K4.launch_counts["hsv_jitter"]
    assert K4.hsv_jitter(img, gains).shape == img.shape
    assert K4.launch_counts["hsv_jitter"] == before


def _tiles_case(seed, B=2, H=32, W=32, M=6):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, (B, 4, H, W, 3)).astype(np.uint8)
    xy = rng.uniform(-4, W - 4, (B, 4, M, 2))
    wh = rng.uniform(1, 20, (B, 4, M, 2))
    labels = np.concatenate([rng.integers(0, 80, (B, 4, M, 1)), xy, xy + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(B, 4, M)) < 0.8
    return tiles, labels, mask


def _jax_draws(key, B, H, W, crop, hsv_gains, fliplr):
    """The draws of the JAX device_train_augment for ``key``."""
    k_oy, k_ox, k_hsv, k_flip = jax.random.split(key, 4)
    oy = jax.random.randint(k_oy, (B,), 0, max(2 * H - crop[0], 0) + 1)
    ox = jax.random.randint(k_ox, (B,), 0, max(2 * W - crop[1], 0) + 1)
    r3 = jax.random.uniform(k_hsv, (B, 3), minval=-1.0, maxval=1.0)
    gains = 1.0 + r3 * jnp.asarray(hsv_gains)
    flip = jax.random.uniform(k_flip, (B,)) < fliplr
    return {k: torch.from_numpy(np.array(v)) for k, v in
            {"oy": oy, "ox": ox, "gains": gains, "flip": flip}.items()}


@pytest.mark.parametrize("fliplr", [0.0, 1.0])
def test_device_augment_matches_jax_given_its_draws(fliplr):
    """The port's core fed the JAX function's draws, against its output:
    image within 1e-5, normalized boxes within 1e-5 px at the output size,
    labels and mask_gt equal. Boxes cut by the crop, too thin after it, and
    more than max_boxes are all in the case."""
    tiles, labels, mask = _tiles_case(int(fliplr))
    gains_hyp, key = (0.015, 0.7, 0.4), jax.random.PRNGKey(7)
    want = jax_device_train_augment(jnp.asarray(tiles), jnp.asarray(labels), jnp.asarray(mask),
                                    key, out_hw=(32, 32), crop_hw=(32, 32), max_boxes=15,
                                    hsv_gains=gains_hyp, fliplr=fliplr)
    d = _jax_draws(key, 2, 32, 32, (32, 32), gains_hyp, fliplr)
    got = augment_core(torch.from_numpy(tiles), torch.from_numpy(labels), torch.from_numpy(mask),
                       **d, out_hw=(32, 32), crop_hw=(32, 32), max_boxes=15)
    m = np.asarray(want["mask_gt"])
    assert 0 < m.sum() < m.size
    np.testing.assert_array_equal(got["mask_gt"].numpy(), m)
    np.testing.assert_array_equal(got["gt_labels"].numpy()[m], np.asarray(want["gt_labels"])[m])
    np.testing.assert_allclose(got["gt_bboxes"].numpy() * 32, np.asarray(want["gt_bboxes"]) * 32,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["img"].permute(0, 2, 3, 1).numpy(), np.asarray(want["img"]),
                               rtol=0, atol=1e-5)


def test_device_augment_draws_and_unported_resize():
    """The draws' wrapper at out_hw and, with a crop of another size (once
    refused), the resize to out_hw: images in [0, 1] at out_hw, boxes
    normalized to it (held to JAX in ``test_torch_train_options.py``)."""
    tiles, labels, mask = _tiles_case(3)
    args = [torch.from_numpy(a) for a in (tiles, labels, mask)]
    for crop in ((32, 32), (40, 48), (24, 20)):
        out = device_train_augment(*args, torch.Generator().manual_seed(0), out_hw=(32, 32),
                                   crop_hw=crop, max_boxes=10)
        assert out["img"].shape == (2, 3, 32, 32) and out["gt_bboxes"].shape == (2, 10, 4)
        assert 0.0 <= float(out["img"].min()) and float(out["img"].max()) <= 1.0
        assert float(out["gt_bboxes"].max()) <= 1.0 and bool(out["mask_gt"].any())


def _png(img, filters):
    """A PNG of an HWC uint8 image (or HW grey) with the given filter type on
    each row, cycling."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        ft = filters[y % len(filters)]
        x = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        if ft == 0:
            f = x
        elif ft == 1:
            f = x - left
        elif ft == 2:
            f = x - prior
        elif ft == 3:
            f = x - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            f = x - pred
        raw += bytes([ft]) + bytes((f & 255).astype(np.uint8))
        prior = x

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_all_filters(channels, tmp_path):
    """Every filter type on every colour type the decoder takes, against the
    pixels; and PIL's own PNGs, against PIL's decode."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 11, channels) if channels > 1 else (13, 11)).astype(np.uint8)
    got = decode_png(_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(decode_png(_png(img, [0])), got)  # unfiltered fast path
    grey = img[..., None] if channels == 1 else img[..., :1]
    rgb = np.repeat(grey, 3, 2) if channels <= 2 else img[..., :3]
    np.testing.assert_array_equal(got, rgb)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img, mode).save(tmp_path / "x.png")
    want = np.asarray(Image.open(tmp_path / "x.png").convert("RGB"))
    np.testing.assert_array_equal(decode_png((tmp_path / "x.png").read_bytes()), want)


def test_png_decoder_refuses_other_formats(tmp_path):
    """A palette PNG now decodes (to PIL's pixels); bytes that are not a PNG
    still raise, and the formats the port leaves out name their item."""
    img = np.random.default_rng(0).integers(0, 256, (4, 4, 3), np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "p.png")
    want = np.asarray(Image.open(tmp_path / "p.png").convert("RGB"))
    np.testing.assert_array_equal(decode_png((tmp_path / "p.png").read_bytes()), want)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff")
    from yolov10_3d_torch.data.dataset import _load_image

    Image.fromarray(img).save(tmp_path / "x.webp")
    with pytest.raises(NotImplementedError, match="item 21"):
        _load_image(str(tmp_path / "x.webp"))


def make_png_tree(root, n=10, seed=0):
    """A YOLO tree of n PNGs of mixed sizes and colour types with 1-3 painted
    boxes each (PIL for RGB, cv2 for grey), and its data.yaml."""
    import cv2

    rng = np.random.default_rng(seed)
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y0:y0 + bh, x0:x0 + bw] = rng.integers(80, 256, 3)
            lines.append(f"{int(rng.integers(0, 3))} {(x0 + bw / 2) / w:.6f} "
                         f"{(y0 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
        path = root / "images" / "train" / f"{i}.png"
        if i % 3 == 2:
            cv2.imwrite(str(path), img[..., 0])
        else:
            Image.fromarray(img).save(path)
        (root / "labels" / "train" / f"{i}.txt").write_text("\n".join(lines))
    (root / "data.yaml").write_text(
        f"path: {root}\ntrain: images/train\nval: images/train\nnames:\n  0: a\n  1: b\n  2: c\n")
    return root / "data.yaml"


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    return make_png_tree(tmp_path_factory.mktemp("pngs"))


def test_tiles_item_matches_jax(png_tree):
    """tiles_item for a seed: the same partners, tiles within one grey level
    (the port's resize against cv2's), labels within 1e-4 px."""
    root = png_tree.parent / "images" / "train"
    jds = JaxYOLODataset(root, imgsz=64, augment=True, hyp=HYP, seed=3, device_aug=True,
                         max_boxes=5)
    pds = YOLODataset(root, imgsz=64, hyp=HYP, seed=3, max_boxes=5)
    assert len(pds) == len(jds) == 10 and pds.im_files == jds.im_files
    for i in range(len(pds)):
        want, got = jds.tiles_item(i), pds.tiles_item(i)
        np.testing.assert_array_equal(got["tile_mask"], want["tile_mask"])
        np.testing.assert_allclose(got["tile_labels"], want["tile_labels"], rtol=0, atol=1e-4)
        assert np.abs(got["tiles"].astype(int) - want["tiles"]).max() <= 1


def test_loader_matches_jax_order_and_batches(png_tree):
    """The batch order for a seed and epoch equals JAX's, with the short
    last batch dropped; the first batch's content equals a one-thread JAX
    loader's (whose partner draws then come in order) with any number of
    workers."""
    root = png_tree.parent / "images" / "train"
    jl = JaxDataLoader(JaxYOLODataset(root, imgsz=64, augment=True, hyp=HYP, seed=1,
                                      device_aug=True, max_boxes=5), 4, seed=5, num_threads=1)
    for epoch in (0, 3):
        pl = DataLoader(YOLODataset(root, imgsz=64, hyp=HYP, seed=1, max_boxes=5), 4, seed=5)
        jl.epoch = pl.epoch = epoch
        want, got = jl._batches(), pl._batches()
        assert len(got) == len(pl) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    jl.epoch = 0
    want = next(iter(jl))
    for workers in (0, 3):
        pl = DataLoader(YOLODataset(root, imgsz=64, hyp=HYP, seed=1, max_boxes=5), 4, seed=5,
                        workers=workers)
        got = next(iter(pl))
        np.testing.assert_allclose(got["tile_labels"].numpy(), want["tile_labels"], atol=1e-4)
        assert np.abs(got["tiles"].numpy().astype(int) - want["tiles"]).max() <= 1


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("yolo-loader")]


def test_loader_leaves_no_thread(png_tree):
    """The producer and the pool are joined when an iteration ends, when it
    is abandoned after one batch and when the dataset raises."""
    root = png_tree.parent / "images" / "train"
    pl = DataLoader(YOLODataset(root, imgsz=64, hyp=HYP, max_boxes=5), 2, workers=3)
    assert len(list(pl)) == 5 and pl.epoch == 1
    assert not _loader_threads()
    it = iter(pl)
    next(it)
    assert _loader_threads()
    del it
    gc.collect()
    assert not _loader_threads()
    assert pl.epoch == 1  # an abandoned epoch does not count
    pl.dataset.im_files[3] = str(root / "missing.png")
    with pytest.raises(FileNotFoundError):
        list(pl)
    assert not _loader_threads()


def test_train_one_epoch_on_cpu(png_tree, tmp_path, monkeypatch):
    """``YOLOv10(..., device="cpu").train`` for one epoch at 64x64, batch 2,
    with device augmentation: finite epoch losses in a results.csv row, the
    HSV jitter's twin run once per step, and the facade then serving the
    trained EMA weights with the dataset's classes."""
    calls = []
    twin = K4.hsv_jitter_torch
    monkeypatch.setattr(K4, "hsv_jitter_torch", lambda *a: calls.append(1) or twin(*a))
    model = YOLOv10("yolov10n.yaml", device="cpu")
    state = model.train(data=str(png_tree), imgsz=64, batch=2, epochs=1, device_aug=True,
                        val=False, save=False, workers=0, save_dir=str(tmp_path / "run"))
    assert state.step == 5 and len(calls) == 5
    with open(tmp_path / "run" / "results.csv") as f:
        (row,) = list(csv.DictReader(f))
    terms = ["loss", "box_om", "cls_om", "dfl_om", "box_oo", "cls_oo", "dfl_oo"]
    assert all(np.isfinite(float(row[k])) for k in terms + ["lr", "time"])
    assert float(row["loss"]) > 0 and row["epoch"] == "0"
    assert model.spec.nc == 3 and model.names == {0: "a", 1: "b", 2: "c"}
    ema = state.ema_state_dict()
    for k, v in model.model.state_dict().items():
        torch.testing.assert_close(v, ema[k], rtol=0, atol=0)
    (res,) = model.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, conf=0.0)
    assert res.boxes.data.shape[1] == 6


@pytest.mark.parametrize("option,item", [
    ({"device_aug": False}, "9a"), ({"degrees": 10.0}, "9a"), ({"close_mosaic": 1}, "9a"),
    ({"rect": True}, "9e"), ({"multi_scale": True}, "9e"), ({"cache": "ram"}, "9e"),
    ({"device": "cpu,cpu"}, "9g"),
])
def test_unported_training_options_raise(png_tree, option, item, monkeypatch):
    """Each training option of the JAX trainer that the port once refused
    now trains. The three of item 9a (the host augmentation) train, as in
    the JAX trainer, on the host path. Those of item 9e train on the host
    path at 128 px and feed the step exactly the batches of JAX's
    DataLoader over JAX's dataset with the same options (rect: the dataset
    sorted by aspect ratio and its batches permuted whole; multi_scale:
    batches resized to 96 and 160; cache: the images kept in memory). A
    device list of two CPU ranks (item 9g) trains one float32 step on the
    global batch of 4 at 128 px (at 64 px each rank's target-score sum
    clamps to 1, so a per-rank normaliser would not show): its results.csv
    terms within rtol 2e-4 of a one-process run's, its update and BN
    statistics within the lockstep bars (``_hold_dp_update``; the two runs
    differ in the order of float32 sums only, and over five steps float32
    chaos moves a running mean by 2%)."""
    kw = dict(data=str(png_tree), imgsz=64, batch=2, epochs=1, device_aug=True, val=False,
              save=False, workers=0)
    if item == "9a":
        model = YOLOv10("yolov10n.yaml", device="cpu")
        assert model.train(**{**kw, **option}).step == 5
        assert not model.trainer.train_ds.tile_mode
        return
    if item == "9e":
        from yolov10_3d_torch.engine.trainer import DetectionTrainer

        seen, real = [], DetectionTrainer.to_device
        monkeypatch.setattr(DetectionTrainer, "to_device",
                            lambda self, b: seen.append({k: np.array(v) for k, v in b.items()})
                            or real(self, b))
        model = YOLOv10("yolov10n.yaml", device="cpu")
        kw = {**kw, "device_aug": False, "imgsz": 128, "mosaic": 1.0, **option}
        assert model.train(**kw).step == 5
        args = model.trainer.args
        root = png_tree.parent / "images" / "train"
        jds = JaxYOLODataset(root, imgsz=128, augment=True, hyp=dict(args), seed=args["seed"],
                             cache=args["cache"] or None)
        jl = JaxDataLoader(jds, 2, seed=args["seed"], num_threads=1, rect=bool(args["rect"]),
                           multi_scale=bool(args["multi_scale"]))
        want = list(jl)
        assert len(seen) == len(want) == 5
        for got, w in zip(seen, want):
            for k, v in w.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        shapes = {b["img"].shape[1:3] for b in want}
        if "multi_scale" in option:
            assert shapes - {(128, 128)}, shapes
        if "rect" in option:
            assert model.trainer.train_ds.im_files == jds.im_files != sorted(jds.im_files)
        if "cache" in option:
            assert all(im is not None for im in model.trainer.train_ds._ram)
        return
    # one float32 step of 2 images a rank (amp, the default, would compare bfloat16 noise)
    runs, kw = {}, {**kw, "batch": 4, "fraction": 0.4, "amp": False, "imgsz": 128}
    from yolov10_3d_torch.train.state import TrainState

    starts, create = [], TrainState.create.__func__
    monkeypatch.setattr(TrainState, "create", classmethod(
        lambda cls, m, o: starts.append({k: v.clone() for k, v in m.state_dict().items()})
        or create(cls, m, o)))
    for name, device in (("dp", option["device"]), ("one", "cpu")):
        model = YOLOv10("yolov10n.yaml", device="cpu")
        state = model.train(**{**kw, "device": device, "save_dir": str(png_tree.parent / name)})
        assert state.step == 1
        with open(png_tree.parent / name / "results.csv") as f:
            (row,) = list(csv.DictReader(f))
        runs[name] = (row, {k: v.clone() for k, v in state.model.state_dict().items()})
    (row, got), (row1, want) = runs["dp"], runs["one"]
    for k in ("loss", "box_om", "cls_om", "dfl_om", "box_oo", "cls_oo", "dfl_oo"):
        np.testing.assert_allclose(float(row[k]), float(row1[k]), rtol=2e-4,
                                   atol=2e-4 * float(row1["loss"]), err_msg=k)
    _hold_dp_update(starts, got, want)


def _hold_dp_update(starts, got, want):
    """Both runs from one start (the two captured starts equal): every
    parameter's update within 2e-3 of its largest element plus 1e-4 of the
    model's largest update plus one float32 spacing of the parameter, the
    BN statistics within 1e-5."""
    start, other = starts
    assert all(torch.equal(start[k], other[k]) for k in start)
    params = [k for k, v in want.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))]
    big = max(float((want[k] - start[k]).abs().max()) for k in params)
    for k in params:
        top = float((want[k] - start[k]).abs().max())
        ulp = float(np.spacing(np.float32(float(start[k].abs().max()))))
        torch.testing.assert_close(got[k] - start[k], want[k] - start[k], rtol=0,
                                   atol=2e-3 * top + 1e-4 * big + ulp, msg=k)
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5, msg=k)
