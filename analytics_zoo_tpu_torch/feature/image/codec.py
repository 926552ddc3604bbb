"""The port's own image codec: JPEG, PNG and BMP without OpenCV or PIL.

The JAX package decodes with ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``
(``feature/image/preprocessing.py``, ``pipeline.py``); :func:`decode`
gives the same array, BGR uint8 HWC, for the formats ``ImageSet.read``
lists (jpg, jpeg, png, bmp), chosen by the file's signature:

- JPEG: baseline, extended-sequential and progressive Huffman, 8-bit, 1,
  3 or 4 (CMYK/YCCK) components, any integer sampling, restart markers.
  The decoder is C++ (``utils/csrc/zoo_image.cpp``, built with g++ at
  first use) and uses libjpeg's islow IDCT, block smoothing, fancy
  upsampling and fixed-point colour tables, and OpenCV's CMYK->BGR, so
  its pixels are libjpeg's and OpenCV's. Arithmetic-coded, lossless,
  hierarchical and 12-bit files raise ``ValueError`` naming the file and
  the mode.
  An APP1 Exif block's Orientation (1-8) turns the pixels as OpenCV's
  ``applyExifOrientation`` does (:func:`jpeg_exif_orientation`).
- PNG: ``zlib`` inflates, the five row filters are reversed in the same
  C++ library; 1/2/4/8/16-bit grey, grey+alpha, RGB, RGBA and palette.
  Alpha is dropped and 16-bit samples keep their high byte, as
  ``IMREAD_COLOR`` does; Adam7-interlaced files decode pass by pass.
- BMP: uncompressed 24- and 32-bit, and 8-bit with a palette.

:func:`encode_jpeg` (baseline 4:2:0, the Annex K tables scaled by
quality as libjpeg scales them) and :func:`encode_png` write files the
decoder and OpenCV both read.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from ...utils.native_loader import load_zoo_image

_ERR_LEN = 256
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_COMPRESSION = 3   # the zlib level encode_png writes at
# cv2.imdecode refuses images over 2^30 pixels (CV_IO_MAX_IMAGE_PIXELS);
# the C++ JPEG decoder holds the same limit
MAX_PIXELS = 1 << 30


def _as_bytes(data) -> bytes:
    if isinstance(data, np.ndarray):
        return data.tobytes()
    return bytes(data)


def decode(data, uri: Optional[str] = None) -> np.ndarray:
    """Encoded image bytes -> BGR uint8 (H, W, 3), as
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` returns it. Raises
    ``ValueError`` (naming ``uri``) on a format or mode it cannot read."""
    raw = _as_bytes(data)
    what = uri if uri is not None else "<bytes>"
    if raw[:2] == b"\xff\xd8":
        return apply_orientation(decode_jpeg(raw, what),
                                 jpeg_exif_orientation(raw))
    if raw[:8] == PNG_SIGNATURE:
        return decode_png(raw, what)
    if raw[:2] == b"BM":
        return decode_bmp(raw, what)
    raise ValueError(f"cannot decode image {what!r}: not a JPEG, PNG or "
                     "BMP file")


def _check_size(width: int, height: int, kind: str, what: str) -> None:
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:
        raise ValueError(f"cannot decode image {what!r}: {kind} of "
                         f"{width}x{height} pixels is empty or over the "
                         f"limit of {MAX_PIXELS}")


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)


# -- JPEG -----------------------------------------------------------------

def decode_jpeg(raw: bytes, what: str = "<bytes>") -> np.ndarray:
    lib = load_zoo_image()
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    err = ctypes.create_string_buffer(_ERR_LEN)
    ptr = lib.zoo_jpeg_decode(raw, len(raw), ctypes.byref(h),
                              ctypes.byref(w), err, _ERR_LEN)
    if not ptr:
        raise ValueError(f"cannot decode image {what!r}: "
                         f"{err.value.decode(errors='replace')}")
    try:
        n = h.value * w.value * 3
        out = np.frombuffer(ctypes.string_at(ptr, n), np.uint8)
    finally:
        lib.zoo_image_free(ptr)
    return out.reshape(h.value, w.value, 3).copy()


def jpeg_exif_orientation(raw: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in the first APP1 Exif block
    before the scan, 1 (as stored) where there is none or it is out of
    range or cut."""
    pos = 2
    while pos + 4 <= len(raw) and raw[pos] == 0xFF:
        marker = raw[pos + 1]
        if marker == 0xFF:              # fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA):      # EOI, SOS: no Exif before the scan
            break
        seg_len = struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        seg = raw[pos + 4:pos + 2 + seg_len]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            return _tiff_orientation(seg[6:])
        pos += 2 + seg_len
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    count = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(end + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:          # SHORT
            value = struct.unpack(end + "H", entry[8:10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned upright for Exif ``orientation``: OpenCV's
    transpose and flips (2 mirrors the columns, 3 turns by 180, 4
    mirrors the rows, 5-8 transpose first)."""
    if orientation <= 1 or orientation > 8:
        return img
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _to_bgr_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"expected an (H, W[, C]) image, got {img.shape}")
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    elif img.shape[2] == 4:
        img = img[:, :, :3]
    return np.ascontiguousarray(img)


def encode_jpeg(img, quality: int = 95) -> bytes:
    """BGR (or grey) uint8 image -> baseline 4:2:0 JFIF bytes."""
    bgr = _to_bgr_u8(img)
    lib = load_zoo_image()
    n = ctypes.c_uint64(0)
    err = ctypes.create_string_buffer(_ERR_LEN)
    ptr = lib.zoo_jpeg_encode(
        bgr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bgr.shape[0],
        bgr.shape[1], int(quality), ctypes.byref(n), err, _ERR_LEN)
    if not ptr:
        raise ValueError(f"JPEG encode failed: {err.value.decode()}")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.zoo_image_free(ptr)


# -- PNG ------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(raw: bytes, what: str):
    """The chunks up to IEND. As libpng does, a cut file (a chunk or its
    CRC short, or no IEND) and a critical chunk whose CRC is wrong are
    errors; an ancillary chunk with a wrong CRC is skipped."""
    pos = 8
    while pos + 12 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(raw):
            break
        body = raw[pos + 8:end]
        crc = struct.unpack(">I", raw[end:end + 4])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            if kind[:1].isupper():
                raise ValueError(f"cannot decode image {what!r}: bad CRC "
                                 f"in PNG {kind.decode(errors='replace')} "
                                 "chunk")
        else:
            yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"cannot decode image {what!r}: truncated PNG (no "
                     "IEND chunk)")


def decode_png(raw: bytes, what: str = "<bytes>") -> np.ndarray:
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(raw, what):
        if kind == b"IHDR":
            if len(body) < 13:
                raise ValueError(f"cannot decode image {what!r}: short "
                                 "PNG IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError(f"cannot decode image {what!r}: PNG without IHDR "
                         "or IDAT")
    width, height, depth, ctype, _, _, interlace = ihdr
    _check_size(width, height, "PNG", what)
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"cannot decode image {what!r}: PNG colour type "
                         f"{ctype} at {depth} bits")
    if interlace > 1:
        raise ValueError(f"cannot decode image {what!r}: PNG interlace "
                         f"method {interlace}")
    chans = _PNG_CHANNELS[ctype]
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"cannot decode image {what!r}: {e}") from None
    if not interlace:
        px, _ = _png_pass(data, width, height, depth, chans, what)
    else:
        # Adam7: seven reduced images, each filtered on its own, scattered
        # into the full grid
        px = np.empty((height, width, chans), np.uint8)
        used = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            part, n = _png_pass(data[used:], pw, ph, depth, chans, what)
            px[y0::dy, x0::dx] = part
            used += n
    if ctype == 0 and depth < 8:   # grey below 8 bits scales to 0..255
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"cannot decode image {what!r}: palette PNG "
                             "without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        rgb = full[px[:, :, 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[:, :, :1], 3, axis=2)
    else:
        rgb = px[:, :, :3]
    return np.ascontiguousarray(rgb[:, :, ::-1])


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_pass(data: bytes, width: int, height: int, depth: int, chans: int,
              what: str):
    """One (reduced) image's filtered rows at the head of ``data`` ->
    (its samples as uint8 (height, width, chans), the bytes it took)."""
    bits = chans * depth
    stride = (width * bits + 7) // 8
    out = np.empty(height * stride, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_zoo_image().zoo_png_unfilter(
            data, len(data), height, stride, max(1, bits // 8),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err,
            _ERR_LEN):
        raise ValueError(f"cannot decode image {what!r}: "
                         f"{err.value.decode()}")
    rows = out.reshape(height, stride)
    if depth == 16:
        # IMREAD_COLOR keeps the high byte (libpng's strip_16)
        px = rows[:, 0::2][:, :width * chans].reshape(height, width, chans)
    elif depth == 8:
        px = rows[:, :width * chans].reshape(height, width, chans)
    else:
        unpacked = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = unpacked.reshape(height, width, depth) @ weights
        px = vals.astype(np.uint8)[:, :, None]
    return px, height * (stride + 1)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", crc)


def encode_png(img) -> bytes:
    """BGR (or grey) uint8 image -> PNG bytes (RGB or grey, 8-bit,
    filter None, zlib at ``PNG_COMPRESSION``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype, px = 0, img
    else:
        ctype, px = 2, _to_bgr_u8(img)[:, :, ::-1]
    h, w = px.shape[:2]
    rows = np.ascontiguousarray(px).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr) +
            _png_chunk(b"IDAT",
                       zlib.compress(raw.tobytes(), PNG_COMPRESSION)) +
            _png_chunk(b"IEND", b""))


# -- BMP ------------------------------------------------------------------

def decode_bmp(raw: bytes, what: str = "<bytes>") -> np.ndarray:
    if len(raw) < 54:
        raise ValueError(f"cannot decode image {what!r}: truncated BMP")
    offset = struct.unpack("<I", raw[10:14])[0]
    hdr = struct.unpack("<I", raw[14:18])[0]
    width, height, _, bpp, comp = struct.unpack("<iiHHI", raw[18:34])
    if comp not in (0, 3) or bpp not in (8, 24, 32) or \
            (comp == 3 and bpp != 32):
        raise ValueError(f"cannot decode image {what!r}: BMP at {bpp} bits "
                         f"with compression {comp} is not supported")
    top_down = height < 0
    height = abs(height)
    _check_size(width, height, "BMP", what)
    stride = (width * bpp // 8 + 3) & ~3
    if offset + stride * height > len(raw):
        raise ValueError(f"cannot decode image {what!r}: truncated BMP "
                         "pixel data")
    body = np.frombuffer(raw, np.uint8, count=stride * height,
                         offset=offset).reshape(height, stride)
    if bpp == 8:
        n_colors = struct.unpack("<I", raw[46:50])[0] or 256
        pal = np.frombuffer(raw, np.uint8, count=4 * n_colors,
                            offset=14 + hdr).reshape(-1, 4)[:, :3]
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal
        img = full[body[:, :width]]
    else:
        ch = bpp // 8
        img = body[:, :width * ch].reshape(height, width, ch)[:, :, :3]
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)
