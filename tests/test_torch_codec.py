"""The port's image codec (``data/image_io.py``, ``native/image_codec.cc``)
against cv2 5.0 and Pillow 12, and against its numpy rules
(``data/codec_rules.py``) stage by stage.

Decoding is held bit for bit to ``cv2.imread`` + ``COLOR_BGR2RGB`` under
cv2's rule and to ``Image.open(...).convert("RGB")`` under PIL's: JPEG in
4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, baseline and progressive, with and
without restart intervals, grey, at 1x1, 7x9, 17x300 and 123x211, with EXIF
orientations 1-8 (cv2 turns the image, PIL does not); PNG at every bit
depth and colour type, each row filter, interlaced or not; BMP in each
layout. Encoding is held to the bytes of ``Image.save(f, "JPEG")`` and of
``cv2.imencode(".jpg")`` (quality 95). The committed fixtures of
``tests/data/codec`` are held to their digests too, which is how the card
machine (no cv2, no PIL) checks them.
"""

import io
import json
import hashlib
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import _image_files as F
from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_torch.data import codec_rules as R
from yolov10_3d_torch.data import image_io
from yolov10_3d_torch.native import image_codec

FIXTURES = Path(__file__).resolve().parent / "data" / "codec"
SIZES = [(1, 1), (7, 9), (17, 300), (123, 211)]


def cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_both_rules(data: bytes) -> None:
    for rule, want in (("cv2", cv2_rgb(data)), ("pil", pil_rgb(data))):
        got = image_io.decode_bytes(data, rule)
        assert got.shape == want.shape, rule
        np.testing.assert_array_equal(got, want, err_msg=rule)


def pil_jpeg(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def cv2_jpeg(img, *params) -> bytes:
    return cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(params))[1].tobytes()


@pytest.mark.parametrize("size", SIZES)
def test_jpeg_decode_matches_cv2_and_pil(size):
    """Every sampling, baseline and progressive, restart intervals, grey."""
    img = F.smooth(*size, seed=size[0] * 1000 + size[1])
    files = [pil_jpeg(img, subsampling=s, progressive=p) for s in (0, 1, 2) for p in (False, True)]
    for samp in (0x121111, 0x411111, 0x221111):
        files.append(cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
                              cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
        files.append(cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
                              cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1))
    files += [pil_jpeg(img[..., 0]), pil_jpeg(img[..., 1], progressive=True)]
    for data in files:
        assert_both_rules(data)


@pytest.mark.parametrize("endian", ["II", "MM"])
def test_jpeg_exif_orientation(endian):
    """cv2 turns the image by its EXIF orientation (123x211 comes back
    211x123 at orientations 5-8); PIL leaves it as stored."""
    jpg = pil_jpeg(F.smooth(123, 211, 3))
    for o in range(1, 9):
        data = F.with_exif(jpg, o, endian)
        assert_both_rules(data)
        assert image_io.decode_bytes(data, "cv2").shape[:2] == ((211, 123) if o >= 5 else (123, 211))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decode_matches_cv2_and_pil(ctype):
    """Every bit depth of the colour type, each filter and a mix of them,
    interlaced or not; palettes with tRNS; a grey 16-bit image above 255
    (cv2 keeps the high byte, PIL clips)."""
    rng = np.random.default_rng(ctype)
    ch = F.PNG_CHANNELS[ctype]
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}[ctype]
    for depth in depths:
        for interlace in (False, True):
            for ft in (-1, 0, 1, 2, 3, 4):
                for h, w in ((1, 1), (13, 11)):
                    pal = trns = None
                    if ctype == 3:
                        n = int(rng.integers(1, 2 ** depth + 1))
                        pal, trns = rng.integers(0, 256, (n, 3)), bytes([5] * min(n, 3))
                        s = rng.integers(0, n, (h, w, 1))
                    else:
                        s = rng.integers(0, 2 ** depth, (h, w, ch))
                    assert_both_rules(F.png(s, depth, ctype, pal, trns, interlace, ft,
                                            seed=int(rng.integers(1 << 30))))


def test_png_exif_orientation_turns_under_cv2_only():
    s = np.random.default_rng(1).integers(0, 256, (5, 9, 3))
    data = F.png(s, 8, 2, exif_orientation=6)
    assert_both_rules(data)
    assert image_io.decode_bytes(data, "cv2").shape == (9, 5, 3)


@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_decode_matches_cv2_and_pil(top_down):
    rng = np.random.default_rng(int(top_down))
    for h, w in ((1, 1), (13, 11), (3, 17)):
        px = rng.integers(0, 256, (h, w, 3), np.uint8)
        assert_both_rules(F.bmp(px, 24, top_down=top_down))
        assert_both_rules(F.bmp(px, 32, top_down=top_down))
        for bits in (1, 4, 8):
            n = int(rng.integers(2, 2 ** bits + 1))
            assert_both_rules(F.bmp(rng.integers(0, n, (h, w)), bits, rng.integers(0, 256, (n, 3)),
                                    top_down=top_down))
        if not top_down:
            assert_both_rules(F.bmp(px, 24, core=True))
    for mode in ("RGB", "L", "P", "1"):  # PIL's own BMPs
        b = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (9, 13, 3), np.uint8)).convert(mode).save(b, "BMP")
        assert_both_rules(b.getvalue())


@pytest.mark.parametrize("size", SIZES + [(16, 16), (31, 17), (96, 128)])
def test_jpeg_encode_writes_pil_and_cv2_bytes(size):
    for seed in range(2):
        img = F.smooth(*size, seed=seed) if seed else np.random.default_rng(7).integers(
            0, 256, (*size, 3), np.uint8)
        assert image_io.encode_jpeg(img, "pil") == pil_jpeg(img)
        assert image_io.encode_jpeg(img, "cv2") == cv2_jpeg(img)


def test_learn2d_frames_are_cv2_imwrite_bytes(tmp_path):
    """``chip_smoke.py`` ``[learn2d]`` writes the JAX 2D learn-proof's frames
    with the port's encoder in cv2's style: the same files as
    ``tests/_helpers.py`` ``make_overfit2d_tree`` writes with
    ``cv2.imwrite(.jpg)``, labels too, and they decode to cv2's pixels."""
    import importlib.util

    from _helpers import make_overfit2d_tree

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    make_overfit2d_tree(tmp_path / "jax")
    chip_smoke.overfit2d_tree(tmp_path / "port")
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*")
                       if p.name != "data.yaml")
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.*")
                        if p.name != "data.yaml")
    assert jax_files == port_files and len(jax_files) == 32
    for rel in jax_files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
        if rel.suffix == ".jpg":
            np.testing.assert_array_equal(image_io.imread(tmp_path / "port" / rel),
                                          cv2.imread(str(tmp_path / "jax" / rel))[..., ::-1])


def test_library_stages_equal_the_numpy_rules():
    """Decoding: the IDCT of every block, then the upsampling and colour
    conversion; encoding: the colour conversion and downsampling, then the
    FDCT, the quantisation and the dummy blocks."""
    img = F.smooth(33, 65, 9)
    files = [pil_jpeg(img, subsampling=s, progressive=p) for s in (0, 1, 2) for p in (0, 1)]
    files += [cv2_jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, s) for s in (0x121111, 0x411111)]
    files.append(pil_jpeg(img[..., 0]))
    for data in files:
        coded = image_codec.jpeg_decode_stages(data)
        np.testing.assert_array_equal(image_codec.jpeg_decode(data), coded.output)
        for k in coded.components:
            np.testing.assert_array_equal(R.blocks_to_plane(R.idct_islow(k.coefs, k.qtable)),
                                          k.plane)
        np.testing.assert_array_equal(R.decode_pixels(coded), coded.output)
    for size in ((1, 1), (7, 9), (33, 65)):
        rgb = F.smooth(*size, seed=size[1])
        for q in (75, 95):
            coded = image_codec.jpeg_encode_stages(rgb, q)
            assert image_codec.jpeg_encode(rgb, q) == coded.output.tobytes()
            for k, full in zip(coded.components, R.rgb_to_ycc(rgb)):
                plane = R.downsample(full, coded.hmax // k.h, k.plane.shape[1], k.plane.shape[0],
                                     coded.vmax)
                np.testing.assert_array_equal(plane, k.plane)
                np.testing.assert_array_equal(
                    R.encode_coefficients(k.plane, k.qtable, k.coefs.shape[:2], k.blocks_real,
                                          k.h, k.v), k.coefs)
    raw = np.random.default_rng(2).integers(0, 256, (9, 1 + 33), dtype=np.uint8)
    raw[:, 0] = np.arange(9) % 5
    np.testing.assert_array_equal(image_codec.png_unfilter(raw, 9, 33, 3, "x"),
                                  R.png_unfilter(raw, 9, 33, 3))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
def test_committed_fixtures_match_libraries_and_digests():
    """``tests/data/codec``: each file decoded by both rules equals cv2's and
    PIL's pixels and the digests written beside it; each ``enc_*.png``
    image encodes to the digests of PIL's and cv2's JPEG bytes."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert len(digests["decoded"]) >= 40
    for name, want in digests["decoded"].items():
        data = (FIXTURES / name).read_bytes()
        assert_both_rules(data)
        for rule in ("cv2", "pil"):
            got = image_io.decode_bytes(data, rule)
            assert [hashlib.sha256(got.tobytes()).hexdigest(), list(got.shape)] == want[rule]
    for name, want in digests["encoded"].items():
        img = image_io.imread(FIXTURES / name)
        for style in ("pil", "cv2"):
            assert hashlib.sha256(image_io.encode_jpeg(img, style)).hexdigest() == want[style]


def test_unported_and_broken_files_raise(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    for fmt in ("WEBP", "TIFF"):
        b = io.BytesIO()
        Image.fromarray(img).save(b, fmt)
        with pytest.raises(NotImplementedError, match="item 21"):
            image_io.decode_bytes(b.getvalue())
    arith = bytearray(cv2_jpeg(img))
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9  # SOF9: arithmetic coding
    with pytest.raises(NotImplementedError, match="arithmetic.*9f"):
        image_io.decode_bytes(bytes(arith))
    with pytest.raises(ValueError, match="not an image"):
        image_io.decode_bytes(b"hello")
    with pytest.raises(FileNotFoundError):
        image_io.imread(tmp_path / "missing.jpg")
    with pytest.raises(ValueError):
        image_io.decode_bytes(pil_jpeg(img)[:40])


def _huge_jpeg(side: int) -> bytes:
    data = bytearray(pil_jpeg(np.zeros((8, 8, 3), np.uint8)))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = struct.pack(">HH", side, side)
    return bytes(data)


def test_oversized_and_truncated_files_raise():
    """Each rule refuses the sizes its library refuses, before it allocates:
    a JPEG frame of 65535 x 65535 under both rules, one of 16384 x 16384
    (268 M pixels) under PIL's limit of 2 * 89478485 but not cv2's 2**30
    (which then fails on the missing scan); a PNG or BMP header over the
    limit. Truncated PNG and BMP headers are ValueError, not struct.error."""
    huge = _huge_jpeg(65535)
    assert cv2.imdecode(np.frombuffer(huge, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(huge))
    for rule in ("cv2", "pil"):
        with pytest.raises(ValueError, match="65535x65535 pixels, over the limit"):
            image_io.decode_bytes(huge, rule)
    with pytest.raises(ValueError, match="16384x16384 pixels, over the limit of 178956970"):
        image_io.decode_bytes(_huge_jpeg(16384), "pil")
    big_png = F.png(np.zeros((1, 1, 3), np.uint8), 8, 2, ft=0)
    big_png = big_png[:16] + struct.pack(">II", 20000, 20000) + big_png[24:]
    with pytest.raises(ValueError, match="20000x20000 pixels, over pil's limit"):
        image_io.decode_bytes(big_png, "pil")
    wide_bmp = bytearray(F.bmp(np.zeros((1, 1, 3), np.uint8), 24))
    wide_bmp[18:22] = struct.pack("<i", (1 << 20) + 1)
    with pytest.raises(ValueError, match="over cv2's limit"):
        image_io.decode_bytes(bytes(wide_bmp), "cv2")
    short_png = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + b"\x00\x00\x01"
    for data, fmt in ((short_png, "PNG"), (bytes(wide_bmp[:30]), "BMP"),
                      (bytes(wide_bmp[:48]), "BMP")):
        for rule in ("cv2", "pil"):
            with pytest.raises(ValueError, match=f"truncated {fmt} header"):
                image_io.decode_bytes(data, rule)


def test_png_inflates_no_further_than_its_image(monkeypatch):
    """An IDAT stream that inflates far past the image's bytes (10 MB of
    zeros after an 8 x 8 image): cv2 and PIL read the image and ignore the
    rest, and so does the port, which inflates no more than the image's
    filtered rows."""
    img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(8))
    good = F.png(img, 8, 2, ft=0)
    ihdr_end = 8 + 25
    idat = zlib.compress(rows + bytes(10_000_000), 9)
    data = good[:ihdr_end] + F._chunk(b"IDAT", idat) + F._chunk(b"IEND", b"")
    inflated = []
    real = zlib.decompressobj

    class Recorder:
        def __init__(self):
            self.d = real()

        def decompress(self, *args):
            out = self.d.decompress(*args)
            inflated.append(len(out))
            return out

    monkeypatch.setattr(image_io.zlib, "decompressobj", Recorder)
    assert_both_rules(data)
    assert set(inflated) == {len(rows)}
