"""Camera-motion compensation of BoT-SORT without cv2 (port of ``GMC`` in
``yolov10_3d_tpu/trackers/bot_sort.py``).

``GMC(method).apply(frame)`` gives the 2x3 float32 warp from the previous
frame to this one, as the JAX class does with cv2: the frame turned grey
(``data/cv2_rules.py`` ``rgb_to_gray``) and shrunk ``downscale`` times
(``data/preprocess.py`` ``resize_linear``), both cv2's rules bit for bit,
then one of

- ``sparseOptFlow`` (the default): ``good_features`` (Shi-Tomasi corners,
  ``cv2.goodFeaturesToTrack(maxCorners=200, qualityLevel=0.01,
  minDistance=8)``), ``optical_flow`` (pyramidal Lucas-Kanade,
  ``cv2.calcOpticalFlowPyrLK`` at its defaults: a 21x21 window, 3 levels,
  30 iterations or a step under 0.01 px) and ``partial_affine``
  (``cv2.estimateAffinePartial2D`` with RANSAC: 3 px, at most 2000
  hypotheses, as many as confidence 0.99 needs, then a least-squares fit
  on the best hypothesis' inliers);
- ``ecc``: ``ecc_euclidean`` (``cv2.findTransformECC``, Euclidean, 50
  iterations or a correlation change under 1e-5, 5x5 Gaussian
  pre-smoothing); a run that stops before convergence leaves the identity,
  as JAX's ``except cv2.error`` does;
- ``none``: the identity.

The corners and the flow follow cv2's arithmetic (the flow's 14-bit
bilinear weights and integer window sums, the Scharr derivatives, the
5-tap pyramid); the RANSAC draws its pairs from a fixed seed where cv2
draws from its own generator, and the ECC runs in float64. The warps are
held to cv2's within stated bars (``tests/test_torch_track.py``), not bit
for bit. All of it runs on the host: numpy, and the flow in C++
(``native/optical_flow.cc``, bit for bit this module's ``optical_flow``,
which is its rule).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..data.cv2_rules import rgb_to_gray
from ..data.preprocess import resize_linear
from ..native import optical_flow as native_flow

MAX_CORNERS, QUALITY_LEVEL, MIN_DISTANCE = 200, 0.01, 8
LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG = 21, 3, 30, 0.01, 1e-4
RANSAC_THRESH, RANSAC_HYPOTHESES, RANSAC_CONFIDENCE, RANSAC_SEED = 3.0, 2000, 0.99, 0
ECC_ITERS, ECC_EPS = 50, 1e-5
_F32 = np.float32
_W_BITS = 14


class EccError(RuntimeError):
    """The ECC iteration stopped before it converged (cv2's ``StsNoConv``)."""


def _reflect(img: np.ndarray, pad: int) -> np.ndarray:
    """BORDER_REFLECT_101 padding (numpy's ``reflect``)."""
    return np.pad(img, pad, mode="reflect")


# ---------------------------------------------------------------- corners

def min_eigen(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, blockSize=3, ksize=3)`` in float32:
    Sobel derivatives scaled by 1 / (4 * 3 * 255), their products summed
    over 3x3 blocks, the smaller eigenvalue of each block's matrix."""
    p = _reflect(gray.astype(np.int32), 1)
    scale = 1.0 / (4 * 3 * 255)
    k1, k2 = _F32(scale), _F32(2 * scale)  # the scaled smoothing kernel [1, 2, 1]
    hdiff = p[:, 2:] - p[:, :-2]  # the row pass [-1, 0, 1]
    dx = (k2 * hdiff[1:-1].astype(_F32) + k1 * (hdiff[:-2] + hdiff[2:]).astype(_F32))
    vdiff = p[2:] - p[:-2]
    dy = (k2 * vdiff[:, 1:-1].astype(_F32) + k1 * (vdiff[:, :-2] + vdiff[:, 2:]).astype(_F32))

    def box(v):
        q = _reflect(v.astype(np.float64), 1)
        rows = q[:, :-2] + q[:, 1:-1] + q[:, 2:]
        return (rows[:-2] + rows[1:-1] + rows[2:]).astype(_F32)

    a = box(dx * dx) * _F32(0.5)
    b = box(dx * dy)
    c = box(dy * dy) * _F32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features(gray: np.ndarray, max_corners: int = MAX_CORNERS,
                  quality: float = QUALITY_LEVEL, min_distance: float = MIN_DISTANCE
                  ) -> Optional[np.ndarray]:
    """``cv2.goodFeaturesToTrack``: (N, 2) float32 corner (x, y), strongest
    first, or None when there is none. Eigenvalues at most ``quality`` of
    the largest are dropped; a corner is a 3x3 local maximum off the
    image's outer ring; corners are taken strongest first (ties: the later
    pixel in raster order, as cv2's pointer comparison), each at least
    ``min_distance`` from every corner taken."""
    eig = min_eigen(gray)
    eig = np.where(eig > _F32(float(eig.max()) * quality), eig, _F32(0))
    h, w = eig.shape
    p = np.pad(eig, 1, constant_values=-np.inf)
    dil = np.max(np.stack([p[i:i + h, j:j + w] for i in range(3) for j in range(3)]), 0)
    ok = (eig != 0) & (eig == dil)
    ok[[0, -1], :] = False
    ok[:, [0, -1]] = False
    ys, xs = np.nonzero(ok)
    if len(ys) == 0:
        return None
    vals = eig[ys, xs]
    order = np.lexsort((-(ys * w + xs), -vals))
    cell = int(round(min_distance))
    d2 = min_distance * min_distance
    grid: dict = {}
    out = []
    for k in order:
        x, y = int(xs[k]), int(ys[k])
        cx, cy = x // cell, y // cell
        if any((x - ax) ** 2 + (y - ay) ** 2 < d2
               for gy in (cy - 1, cy, cy + 1) for gx in (cx - 1, cx, cx + 1)
               for ax, ay in grid.get((gx, gy), ())):
            continue
        grid.setdefault((cx, cy), []).append((x, y))
        out.append((x, y))
        if len(out) == max_corners:
            break
    return np.asarray(out, _F32)


# ---------------------------------------------------------------- optical flow

def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown`` of uint8: the 5-tap [1, 4, 6, 4, 1] filter both ways
    at even pixels, (sum + 128) >> 8, reflect-101 border."""
    h, w = img.shape
    dh, dw = (h + 1) // 2, (w + 1) // 2
    p = _reflect(img.astype(np.int64), 2)
    k = (1, 4, 6, 4, 1)
    rows = sum(k[j] * p[:, j:j + 2 * dw:2] for j in range(5))
    out = sum(k[i] * rows[i:i + 2 * dh:2] for i in range(5))
    return ((out + 128) >> 8).astype(np.uint8)


def pyramid(img: np.ndarray, levels: int = LK_LEVELS, win: int = LK_WIN) -> list:
    """cv2's ``buildOpticalFlowPyramid`` levels: pyrDown while the next
    level stays wider and taller than the window."""
    out = [img]
    h, w = img.shape
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= win or h <= win:
            break
        out.append(pyr_down(out[-1]))
    return out


def scharr(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's ``calcSharrDeriv``: unscaled Scharr x and y derivatives (3, 10,
    3 smoothing), reflect-101 border, int32."""
    s = img.astype(np.int32)
    h, w = s.shape
    up = s[np.r_[1 if h > 1 else 0, 0:h - 1]]
    dn = s[np.r_[1:h, h - 2 if h > 1 else 0]]
    t0 = (up + dn) * 3 + s * 10
    t1 = dn - up
    left = np.r_[1 if w > 1 else 0, 0:w - 1]
    right = np.r_[1:w, w - 2 if w > 1 else 0]
    return t0[:, right] - t0[:, left], (t1[:, right] + t1[:, left]) * 3 + t1 * 10


def _weights(pt: np.ndarray):
    """Integer corner and 14-bit bilinear weights of window origins (N, 2)."""
    ip = np.floor(pt).astype(np.int64)
    a, b = (pt[:, 0] - ip[:, 0]).astype(_F32), (pt[:, 1] - ip[:, 1]).astype(_F32)
    one, s = _F32(1), _F32(1 << _W_BITS)
    w00 = np.rint((one - a) * (one - b) * s).astype(np.int64)
    w01 = np.rint(a * (one - b) * s).astype(np.int64)
    w10 = np.rint((one - a) * b * s).astype(np.int64)
    return ip, (w00, w01, w10, (1 << _W_BITS) - w00 - w01 - w10)


def _window(img: np.ndarray, ip: np.ndarray, w, pad: int, win: int, bits: int) -> np.ndarray:
    """The (N, win, win) bilinear windows of the padded int32 ``img`` at
    ``ip``, CV_DESCALE'd by ``bits``: one (win + 1)^2 gather, the four taps
    its shifted views."""
    r = ip[:, 1, None] + pad + np.arange(win + 1)
    c = ip[:, 0, None] + pad + np.arange(win + 1)
    p = img.ravel().take(r[:, :, None] * img.shape[1] + c[:, None, :])
    w00, w01, w10, w11 = (x[:, None, None].astype(np.int32) for x in w)
    s = (p[:, :-1, :-1] * w00 + p[:, :-1, 1:] * w01 + p[:, 1:, :-1] * w10
         + p[:, 1:, 1:] * w11)
    return (s + (1 << (bits - 1))) >> bits


def optical_flow(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray, win: int = LK_WIN,
                 levels: int = LK_LEVELS, iters: int = LK_ITERS, eps: float = LK_EPS,
                 min_eig: float = LK_MIN_EIG) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)``: (N, 2) float32
    points in ``nxt`` and (N,) status (1 tracked, 0 lost: its window left
    the image or its matrix was too weak at level 0)."""
    pts = np.asarray(pts, _F32).reshape(-1, 2)
    n = len(pts)
    pyr_i, pyr_j = pyramid(prev, levels, win), pyramid(nxt, levels, win)
    top = min(len(pyr_i), len(pyr_j)) - 1
    half = _F32((win - 1) * 0.5)
    status = np.ones(n, bool)
    out = np.zeros((n, 2), _F32)
    for level in range(top, -1, -1):
        I, J = pyr_i[level], pyr_j[level]
        h, w = I.shape
        ix, iy = scharr(I)
        Ip, Jp = _reflect(I.astype(np.int32), win), _reflect(J.astype(np.int32), win)
        dxp, dyp = (np.pad(d, win) for d in (ix, iy))
        prev_pt = pts * _F32(1.0 / (1 << level))
        out = prev_pt.copy() if level == top else out * _F32(2)
        p = prev_pt - half
        ip, wts = _weights(p)
        live = ~((ip[:, 0] < -win) | (ip[:, 0] >= w) | (ip[:, 1] < -win) | (ip[:, 1] >= h))
        if level == 0:
            status &= live
        idx = np.nonzero(live)[0]
        if len(idx) == 0:
            continue
        wsel = tuple(x[idx] for x in wts)
        Iw = _window(Ip, ip[idx], wsel, win, win, _W_BITS - 5)
        gx = _window(dxp, ip[idx], wsel, win, win, _W_BITS)
        gy = _window(dyp, ip[idx], wsel, win, win, _W_BITS)
        scale = _F32(1.0 / (1 << 20))
        A11 = (gx * gx).sum((1, 2), dtype=np.int64).astype(_F32) * scale
        A12 = (gx * gy).sum((1, 2), dtype=np.int64).astype(_F32) * scale
        A22 = (gy * gy).sum((1, 2), dtype=np.int64).astype(_F32) * scale
        D = A11 * A22 - A12 * A12
        eig = (A22 + A11 - np.sqrt((A11 - A22) * (A11 - A22) + _F32(4) * A12 * A12)) / _F32(
            2 * win * win)
        strong = ~((eig < _F32(min_eig)) | (D < _F32(np.finfo(_F32).eps)))
        if level == 0:
            status[idx[~strong]] = False
        keep = np.nonzero(strong)[0]
        idx, Iw, gx, gy = idx[keep], Iw[keep], gx[keep], gy[keep]
        A11, A12, A22, Dinv = A11[keep], A12[keep], A22[keep], _F32(1) / D[keep]
        nxt_pt = out[idx] - half
        prev_delta = np.zeros((len(idx), 2), _F32)
        active = np.ones(len(idx), bool)
        for j in range(iters):
            a = np.nonzero(active)[0]
            if len(a) == 0:
                break
            inp, wj = _weights(nxt_pt[a])
            oob = (inp[:, 0] < -win) | (inp[:, 0] >= w) | (inp[:, 1] < -win) | (inp[:, 1] >= h)
            if level == 0:
                status[idx[a[oob]]] = False
            active[a[oob]] = False
            a, inp = a[~oob], inp[~oob]
            if len(a) == 0:
                break
            wj = tuple(x[~oob] for x in wj)
            diff = _window(Jp, inp, wj, win, win, _W_BITS - 5) - Iw[a]
            b1 = (diff * gx[a]).sum((1, 2), dtype=np.int64).astype(_F32) * scale
            b2 = (diff * gy[a]).sum((1, 2), dtype=np.int64).astype(_F32) * scale
            delta = np.stack([(A12[a] * b2 - A22[a] * b1) * Dinv[a],
                              (A12[a] * b1 - A11[a] * b2) * Dinv[a]], -1).astype(_F32)
            nxt_pt[a] += delta
            res = nxt_pt[a] + half
            small = (delta.astype(np.float64) ** 2).sum(1) <= eps * eps
            osc = (j > 0) & np.all(np.abs(delta + prev_delta[a]) < _F32(0.01), 1) & ~small
            res[osc] -= delta[osc] * _F32(0.5)
            out[idx[a]] = res
            active[a[small | osc]] = False
            prev_delta[a] = delta
    return out, status.astype(np.uint8)


# ---------------------------------------------------------------- RANSAC

def _similarity_lsq(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The least-squares (a, b, tx, ty) of x' = a x - b y + tx,
    y' = b x + a y + ty."""
    x, y = src[:, 0], src[:, 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    A = np.concatenate([np.stack([x, -y, one, zero], 1), np.stack([y, x, zero, one], 1)])
    rhs = np.concatenate([dst[:, 0], dst[:, 1]])
    return np.linalg.lstsq(A, rhs, rcond=None)[0]


def partial_affine(src: np.ndarray, dst: np.ndarray, thresh: float = RANSAC_THRESH,
                   hypotheses: int = RANSAC_HYPOTHESES, confidence: float = RANSAC_CONFIDENCE,
                   seed: int = RANSAC_SEED) -> Optional[np.ndarray]:
    """``cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)``: the
    2x3 float64 similarity (rotation, uniform scale, shift) from ``src`` to
    ``dst``. cv2's RANSAC: pairs of points (drawn from ``seed``) each give a
    similarity; one with more points within ``thresh`` px than any before
    it becomes the best and cuts the number of hypotheses to what
    ``confidence`` needs at its inlier share (cv2's RANSACUpdateNumIters),
    at most ``hypotheses``; the result is the least-squares similarity of
    the best one's inliers. None when no pair gives one."""
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    n = len(src)
    if n < 2:
        return None
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, hypotheses)
    j = (i + rng.integers(1, n, hypotheses)) % n  # a second, distinct point
    ps, qs = src[:, 0] + 1j * src[:, 1], dst[:, 0] + 1j * dst[:, 1]
    best, best_count, limit, k = None, 1, hypotheses, 0
    while k < limit:
        c = slice(k, min(k + 64, limit))  # hypotheses scored 64 at a time, taken in order
        dp = ps[j[c]] - ps[i[c]]
        ok = np.abs(dp) > 0
        z = np.where(ok, (qs[j[c]] - qs[i[c]]) / np.where(ok, dp, 1), 0)  # a + ib
        err = np.abs(z[:, None] * ps[None, :] + (qs[i[c]] - z * ps[i[c]])[:, None]
                     - qs[None, :]) ** 2
        inl = err <= thresh * thresh
        counts = np.where(ok, inl.sum(1), -1)
        for m, count in enumerate(counts):
            if k + m >= limit:
                break
            if count > best_count:
                best, best_count = inl[m], int(count)
                limit = min(limit, _ransac_iterations(confidence, 1 - count / n, limit))
        k = c.stop
    if best is None:
        return None
    a, b, tx, ty = _similarity_lsq(src[best], dst[best])
    return np.array([[a, -b, tx], [b, a, ty]])


def _ransac_iterations(confidence: float, outliers: float, limit: int) -> int:
    """cv2's RANSACUpdateNumIters for two-point models."""
    num = math.log(max(1 - confidence, np.finfo(np.float64).tiny))
    denom = 1 - (1 - outliers) ** 2
    if denom < np.finfo(np.float64).tiny:
        return 0
    denom = math.log(denom)
    return limit if denom >= 0 or -num >= limit * -denom else int(round(num / denom))


# ---------------------------------------------------------------- ECC

def _gauss5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 0)``: [1, 4, 6, 4, 1] / 16 both ways,
    reflect-101 border."""
    p = _reflect(img, 2)
    h, w = img.shape
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    rows = sum(k[j] * p[:, j:j + w] for j in range(5))
    return sum(k[i] * rows[i:i + h] for i in range(5))


def _warp_linear(img: np.ndarray, M: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """img sampled bilinearly at M @ (x, y, 1), zero outside."""
    h, w = img.shape
    sx = M[0, 0] * X + M[0, 1] * Y + M[0, 2]
    sy = M[1, 0] * X + M[1, 1] * Y + M[1, 2]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    p = np.pad(img, 1)

    def tap(yy, xx):
        inside = (xx >= -1) & (xx <= w) & (yy >= -1) & (yy <= h)
        return np.where(inside, p[np.clip(yy + 1, 0, h + 1), np.clip(xx + 1, 0, w + 1)], 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def ecc_euclidean(template: np.ndarray, image: np.ndarray, iters: int = ECC_ITERS,
                  eps: float = ECC_EPS) -> np.ndarray:
    """``cv2.findTransformECC(template, image, eye(2, 3), MOTION_EUCLIDEAN,
    (EPS | COUNT, iters, eps))``: the 2x3 float32 rotation and shift with
    image(W(x)) ~ template(x). Raises ``EccError`` where cv2 raises (a
    NaN correlation, or a step that would lower it)."""
    T = _gauss5(template.astype(np.float64))
    I = _gauss5(image.astype(np.float64))
    Ip = _reflect(I, 1)
    gx = (Ip[1:-1, 2:] - Ip[1:-1, :-2]) * 0.5
    gy = (Ip[2:, 1:-1] - Ip[:-2, 1:-1]) * 0.5
    h, w = T.shape
    Y, X = np.mgrid[0:h, 0:w].astype(np.float64)
    M = np.eye(2, 3)
    rho, last = -1.0, -eps
    for _ in range(iters):
        if abs(rho - last) < eps:
            break
        Iw, gxw, gyw = (_warp_linear(v, M, X, Y) for v in (I, gx, gy))
        sx = np.rint(M[0, 0] * X + M[0, 1] * Y + M[0, 2])
        sy = np.rint(M[1, 0] * X + M[1, 1] * Y + M[1, 2])
        mask = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        count = int(mask.sum())
        if count == 0:
            raise EccError("no overlap")
        img_mean, tmp_mean = Iw[mask].mean(), T[mask].mean()
        img_std, tmp_std = Iw[mask].std(), T[mask].std()
        Iw = np.where(mask, Iw - img_mean, Iw)
        TZ = np.where(mask, T - tmp_mean, 0.0)
        tmp_norm = math.sqrt(count * tmp_std * tmp_std)
        img_norm = math.sqrt(count * img_std * img_std)
        c, s = M[0, 0], M[1, 0]
        jac = np.stack([gxw * (-(X * s) - Y * c) + gyw * (X * c - Y * s), gxw, gyw]).reshape(3, -1)
        hess_inv = np.linalg.inv(jac @ jac.T)
        corr = float((TZ * Iw).sum())
        last, rho = rho, corr / (img_norm * tmp_norm)
        if math.isnan(rho):
            raise EccError("NaN correlation")
        i_proj, t_proj = jac @ Iw.ravel(), jac @ TZ.ravel()
        i_proj_h = hess_inv @ i_proj
        lam_n = img_norm * img_norm - i_proj @ i_proj_h
        lam_d = corr - t_proj @ i_proj_h
        if lam_d <= 0:
            raise EccError("the correlation would decrease: images uncorrelated or apart")
        dp = hess_inv @ (jac @ (lam_n / lam_d * TZ - Iw).ravel())
        theta = math.asin(M[1, 0]) + dp[0]
        M[0, 2] += dp[1]
        M[1, 2] += dp[2]
        M[0, 0] = M[1, 1] = math.cos(theta)
        M[1, 0] = math.sin(theta)
        M[0, 1] = -M[1, 0]
    return M.astype(_F32)


# ---------------------------------------------------------------- GMC

class GMC:
    """Global motion compensation: ``apply(frame)`` -> the 2x3 float32 warp
    from the previous frame to ``frame`` (identity on the first frame), its
    shift in full-resolution pixels. ``method``: ``sparseOptFlow``,
    ``ecc`` or ``none``."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prev = None

    def apply(self, frame: np.ndarray) -> np.ndarray:
        H = np.eye(2, 3, dtype=_F32)
        if self.method == "none":
            return H
        gray = rgb_to_gray(frame) if frame.ndim == 3 else frame
        if self.downscale > 1:
            h, w = gray.shape
            gray = resize_linear(gray[..., None],
                                 (w // self.downscale, h // self.downscale))[..., 0]
        if self.prev is None:
            self.prev = gray
            return H
        if self.method == "ecc":
            try:
                H = ecc_euclidean(self.prev, gray)
            except EccError:
                pass
        else:  # sparseOptFlow
            pts = good_features(self.prev)
            if pts is not None and len(pts) >= 4:
                nxt, status = native_flow.optical_flow(self.prev, gray, pts, LK_WIN, LK_LEVELS,
                                                       LK_ITERS, LK_EPS, LK_MIN_EIG)
                good = status == 1
                if good.sum() >= 4:
                    M = partial_affine(pts[good], nxt[good])
                    if M is not None:
                        H = M.astype(_F32)
        self.prev = gray
        if self.downscale > 1:
            H = H.copy()
            H[:, 2] *= self.downscale
        return H
