"""The port's own resize and BGR<->HSV, without OpenCV.

:func:`resize` is ``cv2.resize(img, (w, h), interpolation=flag)`` for the
five flags ``ImageResize`` draws from (NEAREST, LINEAR, CUBIC, AREA,
LANCZOS4), on uint8 and float32 images of 1 to 4 channels; it returns the
input's dtype. It follows OpenCV's ``resize.cpp`` step for step, in numpy
on the host and vectorised over separable taps:

- NEAREST takes ``floor(dst * scale)``, not the pixel centre.
- LINEAR, CUBIC (a = -0.75) and LANCZOS4 map ``(dst + 0.5) * scale - 0.5``
  in float32 (float64 where OpenCV's IPP path takes a float32 image) and
  replicate the border. uint8 runs in fixed point: the weights are
  rounded to 11 bits (``INTER_RESIZE_COEF_BITS``), the horizontal pass
  sums in int32, the vertical pass rounds as OpenCV's kernels round.
  CUBIC on uint8 with both axes resized (both sides 4 pixels or more)
  is the one case that is not bit-equal: OpenCV's build hands it to
  IPP, whose fixed point is not reproduced here, and up to a few
  percent of the pixels come out one level apart.
- AREA averages true pixel areas when both axes shrink (an integer ratio
  takes OpenCV's fast path), and is bilinear-like when either enlarges.
  LINEAR at exactly half size in both axes is AREA's fast path, as in
  OpenCV.

:func:`bgr_to_hsv` and :func:`hsv_to_bgr` are ``cv2.cvtColor`` with
``COLOR_BGR2HSV`` / ``COLOR_HSV2BGR`` on uint8 (hue in 0..180).
"""

from __future__ import annotations

import math

import numpy as np

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = \
    0, 1, 2, 3, 4
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_F = np.float32


def _sat_u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


# -- coefficient tables -----------------------------------------------------

def _cubic_coeffs(fx):
    a = _F(-0.75)
    x = fx.astype(_F)
    one = _F(1)
    x1 = x + one
    c0 = ((a * x1 - _F(5) * a) * x1 + _F(8) * a) * x1 - _F(4) * a
    c1 = ((a + _F(2)) * x - (a + _F(3))) * x * x + one
    omx = one - x
    c2 = ((a + _F(2)) * omx - (a + _F(3))) * omx * omx + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _cubic_coeffs64(fx):
    a, x = -0.75, fx.astype(np.float64)
    x1, omx = x + 1, 1 - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * omx - (a + 3)) * omx * omx + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=-1).astype(_F)


def _lanczos4_coeffs(fx):
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45),
          (0, -1), (-s45, s45)]
    x = fx.astype(_F)
    y0 = -(x + _F(3)).astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    out = np.empty(x.shape + (8,), _F)
    total = np.zeros(x.shape, _F)
    for i in range(8):
        y0_ = x + _F(3) - _F(i)
        y = -y0_.astype(np.float64) * math.pi * 0.25
        small = np.abs(y0_) < _F(1e-6)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)).astype(_F)
        c = np.where(small, _F(1e30), c)
        out[..., i] = c
        total = (total + c).astype(_F)
    inv = (_F(1) / total).astype(_F)
    return (out * inv[..., None]).astype(_F)


def _axis_table(src, dst, interp, clamp, exact=False):
    """(tap indices (dst, k), weights (dst, k) float32) of one axis, as
    the generic path of OpenCV's resize builds them. Only the horizontal
    axis (``clamp``) pins a LINEAR/AREA tap that falls off the image to
    the edge with weight 0; vertically both taps read the edge row. With
    ``exact`` the weights come from the float64 position."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    d = np.arange(dst, dtype=np.float64)
    if interp == INTER_AREA:
        sx = np.floor(d * scale).astype(np.int64)
        fx = ((d + 1) - (sx + 1) * inv_scale).astype(_F)
        fx = np.where(fx <= 0, _F(0), fx - np.floor(fx).astype(_F))
    elif exact:
        f = (d + 0.5) * scale - 0.5
        sx = np.floor(f).astype(np.int64)
        fx = f - sx
        if interp == INTER_CUBIC:
            return _taps(sx, _cubic_coeffs64(fx), 4, src)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(_F)
        sx = np.floor(f).astype(np.int64)
        fx = (f - sx.astype(_F)).astype(_F)
    if interp in (INTER_LINEAR, INTER_AREA) and clamp:
        lo = sx < 0
        fx = np.where(lo, _F(0), fx)
        sx = np.where(lo, 0, sx)
        hi = sx >= src - 1
        fx = np.where(hi, _F(0), fx)
        sx = np.where(hi, src - 1, sx)
    if interp in (INTER_LINEAR, INTER_AREA):
        w = np.stack([1 - fx, fx], axis=-1).astype(_F)
        ksize = 2
    elif interp == INTER_CUBIC:
        w, ksize = _cubic_coeffs(fx), 4
    else:
        w, ksize = _lanczos4_coeffs(fx), 8
    return _taps(sx, w, ksize, src)


def _taps(sx, w, ksize, src):
    start = sx - (ksize // 2) + 1
    idx = np.clip(start[:, None] + np.arange(ksize)[None, :], 0, src - 1)
    return idx, w


def _generic(img, dh, dw, interp):
    """LINEAR / CUBIC / LANCZOS4, and AREA when an axis enlarges."""
    h, w = img.shape[:2]
    # OpenCV's IPP path takes float32 LINEAR from 2 rows and columns and
    # CUBIC from 4, with float64 tap positions
    exact = img.dtype == np.float32 and (
        (interp == INTER_LINEAR and min(h, w) >= 2) or
        (interp == INTER_CUBIC and min(h, w) >= 4))
    xi, xw = _axis_table(w, dw, interp, True, exact)
    yi, yw = _axis_table(h, dh, interp, False, exact)
    k = xw.shape[1]
    if img.dtype == np.uint8:
        ax = np.rint(xw * _F(_COEF_SCALE)).astype(np.int64)
        ay = np.rint(yw * _F(_COEF_SCALE)).astype(np.int64)
        src = img.astype(np.int64)
        hrow = np.zeros((h, dw) + img.shape[2:], np.int64)
        for j in range(k):
            hrow += src[:, xi[:, j]] * _bcast(ax[:, j], img.ndim, 1)
        rows = [hrow[yi[:, j]] for j in range(k)]
        if k == 2:
            b0 = _bcast(ay[:, 0], img.ndim, 0)
            b1 = _bcast(ay[:, 1], img.ndim, 0)
            out = (((b0 * (rows[0] >> 4)) >> 16) +
                   ((b1 * (rows[1] >> 4)) >> 16) + 2) >> 2
        elif k == 4:
            # OpenCV's vector kernel for this pass sums in float32
            sc = _F(1.0 / (_COEF_SCALE * _COEF_SCALE))
            acc = None
            for j in range(k):
                b = (ay[:, j].astype(_F) * sc).astype(_F)
                t = rows[j].astype(_F) * _bcast(b, img.ndim, 0)
                acc = t if acc is None else acc + t
            out = np.rint(acc)
        else:
            acc = np.zeros_like(rows[0])
            for j in range(k):
                acc += rows[j] * _bcast(ay[:, j], img.ndim, 0)
            out = (acc + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
        return _sat_u8(out)
    src = img.astype(_F)
    hrow = src[:, xi[:, 0]] * _bcast(xw[:, 0], img.ndim, 1)
    for j in range(1, k):
        hrow = hrow + src[:, xi[:, j]] * _bcast(xw[:, j], img.ndim, 1)
    out = hrow[yi[:, 0]] * _bcast(yw[:, 0], img.ndim, 0)
    for j in range(1, k):
        out = out + hrow[yi[:, j]] * _bcast(yw[:, j], img.ndim, 0)
    return out.astype(img.dtype)


def _bcast(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = len(v)
    return v.reshape(shape)


def _area_fast(img, dh, dw, sy, sx):
    """Integer-ratio shrink: the mean of each sy x sx cell."""
    h, w = img.shape[:2]
    cells = img[:dh * sy, :dw * sx].reshape(
        (dh, sy, dw, sx) + img.shape[2:])
    if img.dtype == np.uint8:
        total = cells.astype(np.int64).sum(axis=(1, 3))
        if sy == 2 and sx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        return _sat_u8(np.rint(
            total.astype(_F) * _F(1.0 / (sx * sy))))
    total = np.zeros((dh, dw) + img.shape[2:], _F)
    for a in range(sy):
        for b in range(sx):
            total = total + cells[:, a, :, b].astype(_F)
    return (total * _F(1.0 / (sx * sy))).astype(img.dtype)


def _area_tab(src, dst, scale):
    """OpenCV's computeResizeAreaTab: (dst index, src index, weight)."""
    di, si, al = [], [], []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx)
            si.append(sx1 - 1)
            al.append(np.float32((sx1 - fsx1) / cell))
        for s in range(sx1, sx2):
            di.append(dx)
            si.append(s)
            al.append(np.float32(1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            di.append(dx)
            si.append(sx2)
            al.append(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))
    return np.asarray(di), np.asarray(si), np.asarray(al, _F)


def _area_sum(x, di, si, al, dst, axis):
    """Sum x's ``si`` slices times ``al`` into ``dst`` slots along
    ``axis``, each slot accumulating in table order (float32)."""
    x = np.moveaxis(x, axis, 0)
    out = np.zeros((dst,) + x.shape[1:], _F)
    # entries of one slot are consecutive: step through the j-th entry of
    # every slot together
    starts = np.searchsorted(di, np.arange(dst))
    counts = np.diff(np.append(starts, len(di)))
    for j in range(int(counts.max())):
        has = counts > j
        rows = starts[has] + j
        term = x[si[rows]] * al[rows].reshape((-1,) + (1,) * (x.ndim - 1))
        out[has] = out[has] + term.astype(_F)
    return np.moveaxis(out, 0, axis)


def _area(img, dh, dw):
    h, w = img.shape[:2]
    xd, xs, xa = _area_tab(w, dw, w / dw)
    yd, ys, ya = _area_tab(h, dh, h / dh)
    rows = _area_sum(img.astype(_F), xd, xs, xa, dw, axis=1)
    out = _area_sum(rows, yd, ys, ya, dh, axis=0)
    if img.dtype == np.uint8:
        return _sat_u8(np.rint(out))
    return out.astype(img.dtype)


def _nearest(img, dh, dw):
    h, w = img.shape[:2]
    ifx, ify = 1.0 / (dw / w), 1.0 / (dh / h)
    xs = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), h - 1)
    return img[ys][:, xs]


def resize(img, dsize, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=interpolation)``; ``dsize``
    is (width, height), as OpenCV takes it."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize takes uint8 or float32, not {img.dtype}")
    if img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) image, got {img.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad target size {dsize}")
    h, w = img.shape[:2]
    if (h, w) == (dh, dw):
        return img.copy()
    interp = int(interpolation)
    if interp == INTER_NEAREST:
        return np.ascontiguousarray(_nearest(img, dh, dw))
    if interp not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA,
                      INTER_LANCZOS4):
        raise ValueError(f"unsupported interpolation flag {interpolation}")
    scale_x, scale_y = w / dw, h / dh
    isx, isy = int(round(scale_x)), int(round(scale_y))
    fast = abs(scale_x - isx) < 2.2e-16 and abs(scale_y - isy) < 2.2e-16
    if interp == INTER_LINEAR and fast and isx == 2 and isy == 2:
        interp = INTER_AREA
    if interp == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        if fast:
            return _area_fast(img, dh, dw, isy, isx)
        return _area(img, dh, dw)
    return _generic(img, dh, dw, interp)


# -- colour -----------------------------------------------------------------

_HSV_SHIFT = 12


def _div_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _div_tables()


def bgr_to_hsv(img) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` for uint8 BGR."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("bgr_to_hsv takes uint8")
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([_sat_u8(h), s.astype(np.uint8), v.astype(np.uint8)],
                    axis=-1)


_HSV_VECTOR = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_bgr(img) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` for uint8 HSV (hue
    0..180). OpenCV's kernel forms ``1 - s * h`` with one rounding (a
    fused multiply-add) and converts to uint8 by truncation in its vector
    loop, 32 pixels of a row at a time, and by rounding in the per-pixel
    loop over the rest of the row; so does this."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("hsv_to_bgr takes uint8")
    one = _F(1)
    h = img[..., 0].astype(_F) * _F(6.0 / 180.0)
    s = img[..., 1].astype(_F) * _F(1.0 / 255.0)
    v = img[..., 2].astype(_F) * _F(1.0 / 255.0)
    pre = np.trunc(h)
    frac = (h - pre).astype(_F)
    sector = (pre - np.trunc(pre * _F(1.0 / 6.0)) * _F(6)).astype(np.int64)
    sector = np.clip(sector, 0, 5)
    s64 = s.astype(np.float64)
    fused_h = (1.0 - s64 * frac).astype(_F)
    fused_1mh = (1.0 - s64 * (one - frac)).astype(_F)
    tab = np.stack([v, v * (one - s), v * fused_h, v * fused_1mh],
                   axis=-1).astype(_F)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * _F(255.0)
    out = np.rint(bgr)
    if img.ndim == 3:
        vec = (img.shape[1] // _HSV_VECTOR) * _HSV_VECTOR
        out[:, :vec] = np.trunc(bgr[:, :vec])
    return _sat_u8(out)
