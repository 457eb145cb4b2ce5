"""Write the codec fixtures of this folder and ``digests.json``.

    python tests/data/codec/make_fixtures.py

Needs cv2 and PIL (the references); the files are committed, so the card
machine, which has neither, holds the port's codec to the digests
(``chip_smoke.py`` ``[sources]``) and the CPU tests hold it to the libraries
themselves (``tests/test_torch_codec.py``). Each decoded digest is the
sha256 of the (H, W, 3) uint8 RGB pixels that ``cv2.imread`` +
``COLOR_BGR2RGB`` and ``Image.open(...).convert("RGB")`` return; each
encoded digest is the sha256 of the JPEG bytes that ``Image.save(f,
"JPEG")`` and ``cv2.imencode(".jpg")`` write for an ``enc_*.png`` image.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))
import _image_files as F  # noqa: E402


def pil_jpeg(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def cv2_jpeg(img, *params) -> bytes:
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(params))
    assert ok
    return enc.tobytes()


def files() -> dict:
    out = {}
    a, b, c, d = F.smooth(123, 211, 1), F.smooth(17, 300, 2), F.smooth(7, 9, 3), F.smooth(1, 1, 4)
    out["j420_123x211.jpg"] = pil_jpeg(a)
    out["j420_prog_123x211.jpg"] = pil_jpeg(a, progressive=True)
    out["j444_17x300.jpg"] = pil_jpeg(b, subsampling=0)
    out["j422_prog_17x300.jpg"] = pil_jpeg(b, subsampling=1, progressive=True)
    out["j440_7x9.jpg"] = cv2_jpeg(c, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111)
    out["j411_123x211.jpg"] = cv2_jpeg(a, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111)
    out["j420_rst_123x211.jpg"] = cv2_jpeg(a, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    out["j420_prog_rst_17x300.jpg"] = cv2_jpeg(b, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                               cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    out["jgrey_7x9.jpg"] = pil_jpeg(c[..., 0])
    out["jgrey_prog_123x211.jpg"] = pil_jpeg(a[..., 1], progressive=True)
    out["j420_1x1.jpg"] = pil_jpeg(d)
    e = F.smooth(23, 41, 5)
    for o in range(1, 9):
        out[f"jexif{o}_23x41.jpg"] = F.with_exif(pil_jpeg(e), o, "II" if o % 2 else "MM")
    r = np.random.default_rng(6)
    out["p16rgb_13x11.png"] = F.png(r.integers(0, 65536, (13, 11, 3)), 16, 2)
    out["p16grey_13x11.png"] = F.png(r.integers(0, 400, (13, 11, 1)), 16, 0)
    out["p16ga_i_13x11.png"] = F.png(r.integers(0, 65536, (13, 11, 2)), 16, 4, interlace=True)
    out["p1grey_13x11.png"] = F.png(r.integers(0, 2, (13, 11, 1)), 1, 0)
    out["p2grey_i_13x11.png"] = F.png(r.integers(0, 4, (13, 11, 1)), 2, 0, interlace=True)
    out["p4pal_trns_13x11.png"] = F.png(r.integers(0, 11, (13, 11, 1)), 4, 3,
                                        palette=r.integers(0, 256, (11, 3)), trns=b"\x00\x80")
    out["p8pal_i_31x29.png"] = F.png(r.integers(0, 256, (31, 29, 1)), 8, 3,
                                     palette=r.integers(0, 256, (256, 3)), interlace=True)
    out["pga8_13x11.png"] = F.png(r.integers(0, 256, (13, 11, 2)), 8, 4)
    out["prgba8_i_31x29.png"] = F.png(r.integers(0, 256, (31, 29, 4)), 8, 6, interlace=True)
    for ft in range(5):
        out[f"prgb8_f{ft}_31x29.png"] = F.png(F.smooth(31, 29, 7 + ft), 8, 2, ft=ft)
    out["prgb8_exif6_13x11.png"] = F.png(r.integers(0, 256, (13, 11, 3)), 8, 2,
                                         exif_orientation=6)
    px, idx = r.integers(0, 256, (13, 11, 3), np.uint8), r.integers(0, 256, (13, 11))
    out["b24_13x11.bmp"] = F.bmp(px, 24)
    out["b32_td_13x11.bmp"] = F.bmp(px, 32, top_down=True)
    out["b8pal_13x11.bmp"] = F.bmp(idx, 8, r.integers(0, 256, (256, 3)))
    out["b4pal_td_13x11.bmp"] = F.bmp(idx % 16, 4, r.integers(0, 256, (16, 3)), top_down=True)
    out["b1pal_13x11.bmp"] = F.bmp(idx % 2, 1, r.integers(0, 256, (2, 3)))
    out["bcore24_13x11.bmp"] = F.bmp(px, 24, core=True)
    for h, w, seed in ((123, 211, 11), (17, 300, 12), (7, 9, 13), (32, 48, 14)):
        out[f"enc_{h}x{w}.png"] = F.png(F.smooth(h, w, seed), 8, 2, ft=0)
    return out


def sha(a) -> str:
    return hashlib.sha256(a if isinstance(a, bytes) else np.ascontiguousarray(a).tobytes()
                          ).hexdigest()


def main() -> None:
    digests = {"decoded": {}, "encoded": {}}
    for name, data in sorted(files().items()):
        (HERE / name).write_bytes(data)
        cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests["decoded"][name] = {"cv2": [sha(cv), list(cv.shape)],
                                    "pil": [sha(pil), list(pil.shape)]}
        if name.startswith("enc_"):
            digests["encoded"][name] = {"pil": sha(pil_jpeg(pil)), "cv2": sha(cv2_jpeg(pil))}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
