"""The image codec's pixel stages in numpy: the rules that
``native/image_codec.cc`` computes, each equal to libjpeg-turbo 3.1 (the
JPEG library of cv2 and Pillow) bit for bit, and the PNG unfilter.

They are the codec's statement, not a second decoder on the main path: the
tests and ``chip_smoke.py``'s ``[sources]`` phase hold the library to them
stage by stage on the coefficient blocks and planes it exports
(``native/image_codec.py`` ``Coded``), where cv2 and PIL are absent.

Decoding: ``idct_islow`` (jidctint.c: 13-bit constants, 2 pass-1 bits,
the post-IDCT range table), ``upsample`` (jdsample.c: the h2v1, h1v2 and
h2v2 triangle filters with their biases, replication at widths <= 2 and for
other integral ratios) and ``ycc_to_rgb`` (jdcolor.c's 16-bit tables).
Encoding: ``rgb_to_ycc`` (jccolor.c), ``downsample`` (jcprepct.c's and
jcsample.c's edge replication, h2v2's alternating 1, 2 bias),
``fdct_islow`` (jfdctint.c) and ``quantize`` (jcdctmgr.c's reciprocals for
16-bit DCT elements), with jccoefct.c's dummy blocks in
``encode_coefficients``. Tables: ``with_standard_tables`` (jstdhuff.c's
Annex K.3 tables for the slots a file's DHTs leave undefined).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

CONST_BITS, PASS1_BITS = 13, 2
FIX = dict(c0_298631336=2446, c0_390180644=3196, c0_541196100=4433, c0_765366865=6270,
           c0_899976223=7373, c1_175875602=9633, c1_501321110=12299, c1_847759065=15137,
           c1_961570560=16069, c2_053119869=16819, c2_562915447=20995, c3_072711026=25172)
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fix16(x: float) -> int:
    return int(x * 65536.0 + 0.5)


# ------------------------------------------------------------------ decoding

def _idct_1d(v):
    """jidctint.c's butterfly on 8 int64 arrays (in natural order) -> the 8
    outputs before their descale."""
    f = FIX
    z1 = (v[2] + v[6]) * f["c0_541196100"]
    tmp2 = z1 + v[6] * -f["c1_847759065"]
    tmp3 = z1 + v[2] * f["c0_765366865"]
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["c1_175875602"]
    o0, o1 = o0 * f["c0_298631336"], o1 * f["c2_053119869"]
    o2, o3 = o2 * f["c3_072711026"], o3 * f["c1_501321110"]
    z1, z2 = z1 * -f["c0_899976223"], z2 * -f["c2_562915447"]
    z3, z4 = z3 * -f["c1_961570560"] + z5, z4 * -f["c0_390180644"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def idct_limit(x: np.ndarray) -> np.ndarray:
    """The post-IDCT range table, indexed by x & 1023 (x + 128 clamped to
    0..255 for |x| < 512, wrapping beyond)."""
    i = x & 1023
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896))
                    ).astype(np.uint8)


def idct_islow(coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(..., 8, 8) quantised coefficients (natural order) and their (8, 8)
    table -> (..., 8, 8) uint8 samples."""
    d = coefs.astype(np.int64) * q.astype(np.int64)
    cols = _idct_1d([d[..., r, :] for r in range(8)])  # pass 1 over columns
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], -2)
    rows = _idct_1d([ws[..., :, c] for c in range(8)])  # pass 2 over rows
    return np.stack([idct_limit(_descale(r, CONST_BITS + PASS1_BITS + 3)) for r in rows], -1)


def blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    """(rows, cols, 8, 8) -> (rows * 8, cols * 8)."""
    r, c = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)


def upsample(plane: np.ndarray, dw: int, dh: int, rh: int, rv: int, H: int, W: int) -> np.ndarray:
    """A component's IDCT plane -> (H, W) at full size by jdsample.c's rule
    for ratio (rh, rv); ``dw``, ``dh`` the component's samples that hold the
    image (edges replicate them)."""
    p = plane.astype(np.int32)
    if (rh, rv) == (1, 1):
        return plane[:H, :W].copy()
    fancy = (rh == 2 and dw > 2) or (rh, rv) == (1, 2)
    if not fancy or (rh, rv) not in ((2, 1), (1, 2), (2, 2)):
        return plane[np.arange(H)[:, None] // rv, np.arange(W)[None, :] // rh]
    ys, xs = np.arange(H), np.arange(W)
    if rv == 2:
        near = ys >> 1
        far = np.where(ys & 1, np.minimum(near + 1, dh - 1), np.maximum(near - 1, 0))
        rows = p[near] * 3 + p[far]  # column sums (H, plane width)
    else:
        rows = p[ys]
    if rh == 1:  # h1v2
        bias = np.where(ys & 1, 2, 1)[:, None]
        return ((rows[:, :W] + bias) >> 2).astype(np.uint8)
    j = xs >> 1
    nb = np.where(xs & 1, np.minimum(j + 1, dw - 1), np.maximum(j - 1, 0))
    if rv == 1:  # h2v1
        return ((rows[:, j] * 3 + rows[:, nb] + np.where(xs & 1, 2, 1)) >> 2).astype(np.uint8)
    return ((rows[:, j] * 3 + rows[:, nb] + np.where(xs & 1, 7, 8)) >> 4).astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's YCbCr -> RGB, (H, W) uint8 planes -> (H, W, 3)."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix16(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix16(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + ONE_HALF
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_pixels(coded) -> np.ndarray:
    """(H, W, 3) from a decode's component planes: upsampling and colour."""
    full = [upsample(k.plane, k.dw, k.dh, coded.hmax // k.h, coded.vmax // k.v, coded.height,
                     coded.width) for k in coded.components]
    if coded.transform == 0:
        return np.repeat(full[0][..., None], 3, 2)
    if coded.transform == 2:
        return np.stack(full, -1)
    return ycc_to_rgb(*full)


# ------------------------------------------------------------------ encoding

def rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """jccolor.c's RGB -> Y, Cb, Cr (uint8 planes)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half_cbcr = _fix16(0.5)
    off = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + half_cbcr * b + off) >> SCALEBITS
    cr = (half_cbcr * r - _fix16(0.41869) * g - _fix16(0.08131) * b + off) >> SCALEBITS
    return [v.astype(np.uint8) for v in (y, cb, cr)]


def downsample(full: np.ndarray, ratio: int, width: int, rows: int, vmax: int) -> np.ndarray:
    """A full-size component -> the plane the FDCT reads: image rows padded
    to a multiple of ``vmax`` and columns to ``width * ratio`` by
    replication, averaged over ratio x ratio (1 or 2) with h2v2's bias,
    then rows padded to ``rows`` by replicating the last one."""
    H, W = full.shape
    in_rows = -(-H // vmax) * vmax
    ys = np.minimum(np.arange(in_rows), H - 1)
    xs = np.minimum(np.arange(width * ratio), W - 1)
    src = full[ys][:, xs].astype(np.int32)
    if ratio == 2:
        s = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
        src = (s + 1 + (np.arange(width) & 1)) >> 2
    out = src[np.minimum(np.arange(rows), src.shape[0] - 1)]
    return out.astype(np.uint8)


def _fdct_1d(v, final: bool):
    f = FIX
    t0, t7, t1, t6 = v[0] + v[7], v[0] - v[7], v[1] + v[6], v[1] - v[6]
    t2, t5, t3, t4 = v[2] + v[5], v[2] - v[5], v[3] + v[4], v[3] - v[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    n = CONST_BITS + PASS1_BITS if final else CONST_BITS - PASS1_BITS
    out = [None] * 8
    if final:
        out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
    else:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
    z1 = (t12 + t13) * f["c0_541196100"]
    out[2] = _descale(z1 + t13 * f["c0_765366865"], n)
    out[6] = _descale(z1 + t12 * -f["c1_847759065"], n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * f["c1_175875602"]
    t4, t5 = t4 * f["c0_298631336"], t5 * f["c2_053119869"]
    t6, t7 = t6 * f["c3_072711026"], t7 * f["c1_501321110"]
    z1, z2 = z1 * -f["c0_899976223"], z2 * -f["c2_562915447"]
    z3, z4 = z3 * -f["c1_961570560"] + z5, z4 * -f["c0_390180644"] + z5
    out[7], out[5] = _descale(t4 + z1 + z3, n), _descale(t5 + z2 + z4, n)
    out[3], out[1] = _descale(t6 + z2 + z3, n), _descale(t7 + z1 + z4, n)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(..., 8, 8) uint8 samples -> jfdctint.c's output (scaled by 8), int64."""
    d = samples.astype(np.int64) - 128
    rows = np.stack(_fdct_1d([d[..., :, c] for c in range(8)], False), -1)  # pass 1: rows
    return np.stack(_fdct_1d([rows[..., r, :] for r in range(8)], True), -2)  # pass 2: columns


def reciprocals(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal of q << 3 with 16-bit DCT elements:
    (recip, corr, shift) arrays."""
    recip, corr, shift = (np.zeros(q.shape, np.int64) for _ in range(3))
    for idx, qv in np.ndenumerate(q):
        d = int(qv) << 3
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[idx], corr[idx], shift[idx] = fq, c, r
    return recip, corr, shift


def quantize(dct: np.ndarray, q: np.ndarray) -> np.ndarray:
    """FDCT output -> quantised coefficients (natural order), int16."""
    recip, corr, shift = reciprocals(q)
    mag = ((np.abs(dct) + corr) * recip) >> shift
    return np.where(dct < 0, -mag, mag).astype(np.int16)


def encode_coefficients(plane: np.ndarray, q: np.ndarray, blocks: Sequence[int],
                        blocks_real: Sequence[int], h: int, v: int) -> np.ndarray:
    """A component's plane -> its (rows, cols, 8, 8) coefficients as
    jccoefct.c leaves them: real blocks quantised, blocks past the real ones
    in an MCU zero with the DC of the block before (the one to the left past
    the right edge; the last block of the row above in that MCU past the
    bottom)."""
    bh, bw = blocks
    rh, rw = blocks_real
    real = plane[:rh * 8, :rw * 8].reshape(rh, 8, rw, 8).transpose(0, 2, 1, 3)
    out = np.zeros((bh, bw, 8, 8), np.int16)
    out[:rh, :rw] = quantize(fdct_islow(real), q)
    for by in range(bh):
        for bx in range(bw):
            if by >= rh:
                prev = out[by, bx - 1] if bx % h else out[by - 1, bx - (bx % h) + h - 1]
                out[by, bx, 0, 0] = prev[0, 0]
            elif bx >= rw:
                out[by, bx, 0, 0] = out[by, bx - 1, 0, 0]
    return out


# ------------------------------------------------------------------ Huffman

# JPEG Annex K.3's tables as (BITS[1..16], HUFFVAL), keyed by (class, slot):
# class 0 DC, 1 AC; slot 0 luminance, 1 chrominance
STD_HUFFMAN = {
    (0, 0): (bytes.fromhex("00 01 05 01 01 01 01 01 01 00 00 00 00 00 00 00"),
             bytes.fromhex("00 01 02 03 04 05 06 07 08 09 0a 0b")),
    (0, 1): (bytes.fromhex("00 03 01 01 01 01 01 01 01 01 01 00 00 00 00 00"),
             bytes.fromhex("00 01 02 03 04 05 06 07 08 09 0a 0b")),
    (1, 0): (bytes.fromhex("00 02 01 03 03 02 04 03 05 05 04 04 00 00 01 7d"),
             bytes.fromhex(
                 "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08 "
                 "23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28 "
                 "29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59 "
                 "5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89 "
                 "8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 "
                 "b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2 "
                 "e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa"
             )),
    (1, 1): (bytes.fromhex("00 02 01 02 04 04 03 04 07 05 04 04 00 01 02 77"),
             bytes.fromhex(
                 "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91 "
                 "a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26 "
                 "27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 "
                 "59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87 "
                 "88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 "
                 "b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da "
                 "e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa"
             )),
}


def with_standard_tables(data: bytes) -> bytes:
    """A JPEG file with the tables libjpeg-turbo decodes it with: a DHT of
    Annex K.3's tables inserted before the first SOS for each DC or AC slot
    0 and 1 that no DHT before it defines (jstdhuff.c; Motion-JPEG frames,
    such as a webcam's AVI1 frames, leave their DHT out). A file that
    defines all four slots comes back unchanged."""
    defined, p = set(), 2
    while p + 4 <= len(data) and data[p] == 0xFF:
        marker, length = data[p + 1], int.from_bytes(data[p + 2:p + 4], "big")
        if marker == 0xDA:
            break
        if marker == 0xC4:
            q = p + 4
            while q < p + 2 + length:
                defined.add((data[q] >> 4, data[q] & 15))
                q += 17 + sum(data[q + 1:q + 17])
        p += 2 + length
    body = b"".join(bytes([tc << 4 | th]) + bits + vals
                    for (tc, th), (bits, vals) in STD_HUFFMAN.items() if (tc, th) not in defined)
    if not body:
        return data
    return data[:p] + b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body + data[p:]


# ------------------------------------------------------------------ PNG

def png_unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanlines (a filter byte, then ``stride`` bytes each) -> (rows,
    stride) with the five filters undone (None, Sub, Up, Average, Paeth)."""
    lines = raw.reshape(rows, stride + 1).astype(np.int64)
    out = np.zeros((rows, stride), np.int64)
    prior = np.zeros(stride, np.int64)
    for y in range(rows):
        ft, x = int(lines[y, 0]), lines[y, 1:]
        if ft == 0:
            cur = x.copy()
        elif ft == 2:
            cur = (x + prior) & 255
        else:
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (x[i] + pred) & 255
        out[y] = prior = cur
    return out.astype(np.uint8)
