"""The port's image features against OpenCV and the JAX package on the
CPU: the codec (``feature/image/codec.py``) against ``cv2.imdecode`` /
``cv2.imencode``, the resize and colour conversions (``resize.py``)
against ``cv2.resize`` / ``cv2.cvtColor``, every image preprocessing
class, ``ImageSet`` and ``ImagePipelineFeatureSet`` against the JAX
package's (which call OpenCV) under one ``random.seed``, the Image3D
transforms, and ``Estimator.train_imagefeature`` on an ``ImageSet``.

Tolerances:
- PNG (Adam7 too), BMP, and baseline, progressive (block-smoothed where
  cut after a scan) and CMYK/YCCK JPEG decode: bit-equal to
  ``cv2.imdecode`` (measured max |diff| 0 over every case here);
- the JPEG encoder: OpenCV's decode of its bytes is no further from the
  image than OpenCV's own round trip at the same quality plus 1 level
  (measured: the bytes are OpenCV's, byte for byte); the PNG encoder
  round-trips exactly;
- resize: uint8 bit-equal for NEAREST, LINEAR, AREA and LANCZOS4; CUBIC
  uint8 within 1 level on at most 6% of the values (with both axes
  resized OpenCV hands it to IPP, whose fixed point is not reproduced;
  measured up to 5.3%, and bit-equal when one axis keeps its size);
  float32 within 1e-3 (on 0-255 values) for all five;
- ``bgr_to_hsv``: bit-equal over all 2**24 colours; ``hsv_to_bgr``:
  bit-equal over every (h, s, v) in rows narrower than OpenCV's 32-pixel
  vector block (its per-pixel loop) and in rows of 256 (its vector loop,
  which truncates where the per-pixel loop rounds);
- preprocessing classes: equal, except the float32 resizes (1e-3);
- ``ImagePipelineFeatureSet`` batches 1e-3; Image3D equal (the same
  scipy calls); ``train_imagefeature``'s weights 1e-5.
"""

import os
import random
import struct
import zlib

import cv2
import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature import image as jimg
from analytics_zoo_tpu.feature import image3d as jimg3d
from analytics_zoo_tpu.feature.common import \
    ChainedPreprocessing as JChained
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature import image as timg
from analytics_zoo_tpu_torch.feature import image3d as timg3d
from analytics_zoo_tpu_torch.feature.common import \
    ChainedPreprocessing as TChained
from analytics_zoo_tpu_torch.feature.image import codec
from analytics_zoo_tpu_torch.feature.image import resize as tresize

F32_TOL = 1e-3
CUBIC_U8_SHARE = 0.06
FIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                                     devices=jax.devices()[:1]))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _scene(h, w, seed=0, c=3):
    """A smooth gradient with filled rectangles and some noise."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255.0 / max(w, 1), yy * 255.0 / max(h, 1),
                    (xx + yy) * 127.0 / max(h + w, 1) + 60], -1)[..., :c]
    img = img + rs.normal(0, 10, img.shape)
    for _ in range(3):
        y0, x0 = rs.integers(0, max(h, 1)), rs.integers(0, max(w, 1))
        img[y0:y0 + max(h // 4, 1), x0:x0 + max(w // 5, 1)] = \
            rs.integers(0, 256, c)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_decode(buf):
    return cv2.imdecode(np.frombuffer(bytes(buf), np.uint8),
                        cv2.IMREAD_COLOR)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_decodes_bit_equal_to_opencv(quality, sampling):
    for i, (h, w) in enumerate([(375, 500), (17, 33), (1, 1), (31, 45),
                                (8, 8), (2, 3), (61, 7)]):
        img = _scene(h, w, i)
        for rst in (0, 3):
            flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
            if rst:
                flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            buf = cv2.imencode(".jpg", img, flags)[1].tobytes()
            if rst:
                assert b"\xff\xdd" in buf      # a DRI segment
            got = codec.decode(buf)
            want = _cv2_decode(buf)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert int(np.abs(got.astype(int) - want).max()) == 0, \
                (h, w, rst)


def test_grey_jpeg_decodes_to_three_equal_channels():
    g = _scene(45, 61)[..., 1]
    buf = cv2.imencode(".jpg", g, [cv2.IMWRITE_JPEG_QUALITY, 80])[1]
    got = codec.decode(buf.tobytes())
    np.testing.assert_array_equal(got, _cv2_decode(buf))
    assert got.shape == (45, 61, 3)


def test_unsupported_jpeg_modes_raise_naming_the_file_and_mode():
    """Progressive files now decode bit-equal to OpenCV; arithmetic-coded,
    lossless and 12-bit frames stay refused, naming the file and mode."""
    img = _scene(40, 40)
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    np.testing.assert_array_equal(codec.decode(prog.tobytes(), "photo.jpg"),
                                  _cv2_decode(prog))
    base = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    sof = base.index(b"\xff\xc0")
    lossless = bytearray(base)
    lossless[sof + 1] = 0xC3
    with pytest.raises(ValueError, match="l.jpg.*lossless"):
        codec.decode(bytes(lossless), "l.jpg")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="t.jpg.*12-bit"):
        codec.decode(bytes(twelve), "t.jpg")
    sof = base.index(b"\xff\xc0")
    base[sof + 1] = 0xC9                       # arithmetic-coded frame
    with pytest.raises(ValueError, match="a.jpg.*arithmetic"):
        codec.decode(bytes(base), "a.jpg")
    with pytest.raises(ValueError, match="not a JPEG, PNG or BMP"):
        codec.decode(b"GIF89a....", "x.gif")


PROGRESSIVE_SIZES = [(45, 61), (17, 33), (1, 1), (9, 17), (2, 3), (61, 7),
                     (100, 130), (33, 9)]


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING) + ["411"])
def test_progressive_jpeg_decodes_bit_equal_to_opencv(sampling, quality,
                                                      rst):
    """OpenCV's progressive files (libjpeg's jpeg_simple_progression: DC
    first and refine, AC spectral selection and successive approximation,
    EOB runs), with restart intervals; and each file cut after each of its
    scans: refused with no EOI, as ``cv2.imdecode`` refuses it, and with
    an EOI appended bit-equal to OpenCV's block-smoothed decode."""
    samp = dict(SAMPLING, **{"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411})
    for i, (h, w) in enumerate(PROGRESSIVE_SIZES):
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                 cv2.IMWRITE_JPEG_QUALITY, quality,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp[sampling]]
        if rst:
            flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        buf = cv2.imencode(".jpg", _scene(h, w, 20 + i), flags)[1].tobytes()
        assert b"\xff\xc2" in buf and (not rst or b"\xff\xdd" in buf)
        np.testing.assert_array_equal(codec.decode(buf), _cv2_decode(buf))
        sos = [k for k in range(len(buf) - 1) if buf[k:k + 2] == b"\xff\xda"]
        assert len(sos) >= 6, len(sos)        # a real scan script
        for at in sos[1:]:
            assert _cv2_decode(buf[:at]) is None
            with pytest.raises(ValueError, match="cut.jpg.*truncated"):
                codec.decode(buf[:at], "cut.jpg")
            cut = buf[:at] + b"\xff\xd9"
            np.testing.assert_array_equal(codec.decode(cut), _cv2_decode(cut),
                                          err_msg=f"{(h, w)} cut at {at}")


def test_progressive_grey_jpeg_decodes_bit_equal():
    g = _scene(45, 61)[..., 1]
    buf = cv2.imencode(".jpg", g, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    np.testing.assert_array_equal(codec.decode(buf.tobytes()),
                                  _cv2_decode(buf))


@pytest.mark.parametrize("transform", ["cmyk", "ycck"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_four_component_jpeg_decodes_bit_equal(transform, progressive,
                                               subsampling):
    """PIL's CMYK JPEGs (Adobe APP14 with transform 0, inverted values as
    Photoshop writes them) and the same data marked YCCK (transform 2):
    libjpeg's CMYK output, then OpenCV's CMYK->BGR, bit for bit."""
    import io
    from PIL import Image
    rs = np.random.default_rng(subsampling + 3 * progressive)
    cmyk = np.concatenate([_scene(37, 50, 5), rs.integers(
        0, 256, (37, 50, 1)).astype(np.uint8)], axis=2)
    out = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(out, "JPEG", quality=85,
                                       progressive=progressive,
                                       subsampling=subsampling)
    buf = bytearray(out.getvalue())
    adobe = buf.index(b"Adobe")
    assert buf[adobe + 11] == 0
    if transform == "ycck":
        buf[adobe + 11] = 2
    got = codec.decode(bytes(buf))
    assert got.shape == (37, 50, 3)
    np.testing.assert_array_equal(got, _cv2_decode(buf))


CORRUPT = {   # name -> (h, w, quality, restart interval, sampling)
    "420-rst2": (45, 61, 75, 2, "420"),
    "444": (33, 50, 90, 0, "444"),
    "422-rst1": (40, 40, 50, 1, "422")}


def _corrupt_base(case):
    h, w, quality, rst, sampling = CORRUPT[case]
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if rst:
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    return cv2.imencode(".jpg", _scene(h, w, 7), flags)[1].tobytes()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_cut_jpeg_is_refused_where_opencv_refuses_it(case):
    """The file cut after every byte: a cut in the headers, or inside the
    entropy-coded data with no marker after it, raises ``ValueError``
    exactly where ``cv2.imdecode`` returns nothing; the others decode
    bit-equal to it."""
    buf = _corrupt_base(case)
    refused = 0
    for cut in range(1, len(buf) + 1):
        part = buf[:cut]
        want = _cv2_decode(part)
        if want is None:
            refused += 1
            with pytest.raises(ValueError, match="cut.jpg"):
                codec.decode(part, "cut.jpg")
        else:
            np.testing.assert_array_equal(codec.decode(part), want)
    assert 0 < refused < len(buf)


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_bit_flipped_jpeg_decodes_where_opencv_does(case):
    """One to three flipped bits in the entropy-coded data, 200 seeded
    files: libjpeg decodes each one with warnings (bad Huffman codes,
    markers the flips made, lost restart markers), and so does the port,
    to the frame's shape. Most decode bit-equal to OpenCV; the rest differ
    where a corrupt coefficient drives the IDCT out of range, which
    libjpeg's C islow (followed here) wraps and libjpeg-turbo's SIMD
    build, which OpenCV runs, saturates."""
    buf = _corrupt_base(case)
    h, w = CORRUPT[case][:2]
    start = buf.index(b"\xff\xda")
    start += 2 + int.from_bytes(buf[start + 2:start + 4], "big")
    rs = np.random.default_rng(sorted(CORRUPT).index(case))
    equal = 0
    for _ in range(200):
        arr = np.frombuffer(buf, np.uint8).copy()
        at = rs.integers(start, len(buf) - 2, rs.integers(1, 4))
        arr[at] ^= (1 << rs.integers(0, 8, len(at))).astype(np.uint8)
        want = _cv2_decode(arr)
        got = codec.decode(arr.tobytes())
        assert want is not None
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        equal += int(np.array_equal(got, want))
    assert equal >= 160, equal     # 176-182 of 200 when written


def test_bad_huffman_table_and_oversized_images_raise():
    """A DC Huffman symbol above 15 (a bit count the decoder would shift
    by) is libjpeg's JERR_BAD_HUFF_TABLE; a frame over 2^30 pixels is
    over OpenCV's CV_IO_MAX_IMAGE_PIXELS, whichever the format. OpenCV
    refuses each of these files too."""
    buf = bytearray(cv2.imencode(".jpg", _scene(40, 40))[1].tobytes())
    dht = buf.index(b"\xff\xc4")
    assert buf[dht + 4] == 0x00                # a DC table comes first
    n_sym = sum(buf[dht + 5:dht + 21])
    bad = bytearray(buf)
    bad[dht + 21 + n_sym - 1] = 200
    assert _cv2_decode(bad) is None
    with pytest.raises(ValueError, match="h.jpg.*DC symbol 200"):
        codec.decode(bytes(bad), "h.jpg")
    sof = buf.index(b"\xff\xc0")
    big = bytearray(buf)
    big[sof + 5:sof + 9] = b"\xff\xff\xff\xff"   # 65535 x 65535
    assert _cv2_decode(big) is None
    with pytest.raises(ValueError, match="65535x65535.*over the limit"):
        codec.decode(bytes(big))
    png = bytearray(codec.encode_png(_scene(8, 8)))
    png[16:24] = struct.pack(">II", 40000, 40000)
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    with pytest.raises(ValueError, match="p.png.*40000x40000"):
        codec.decode(bytes(png), "p.png")
    bmp = bytearray(cv2.imencode(".bmp", _scene(8, 8))[1].tobytes())
    bmp[18:26] = struct.pack("<ii", 40000, 40000)
    with pytest.raises(ValueError, match="40000x40000"):
        codec.decode(bytes(bmp))


@pytest.mark.parametrize("ext", [".png", ".bmp"])
def test_cut_png_and_bmp_are_refused_where_opencv_refuses_them(ext):
    """Every cut of an OpenCV-written PNG (a chunk, its CRC or IEND
    short) or BMP raises ``ValueError``, as ``cv2.imdecode`` refuses it;
    a PNG critical chunk with a wrong CRC is refused too."""
    buf = cv2.imencode(ext, _scene(23, 31, 4))[1].tobytes()
    for cut in range(1, len(buf)):
        with pytest.raises(ValueError):
            codec.decode(buf[:cut])
    np.testing.assert_array_equal(codec.decode(buf), _cv2_decode(buf))
    if ext == ".png":
        flipped = bytearray(buf)
        flipped[buf.index(b"IDAT") + 10] ^= 1
        assert _cv2_decode(flipped) is None
        with pytest.raises(ValueError, match="bad CRC in PNG IDAT"):
            codec.decode(bytes(flipped))


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_encoder_is_read_by_opencv_within_its_own_round_trip(quality):
    for i, (h, w) in enumerate([(375, 500), (17, 33), (8, 8), (2, 3)]):
        img = _scene(h, w, 10 + i)
        ours = codec.encode_jpeg(img, quality)
        theirs = cv2.imencode(".jpg", img,
                              [cv2.IMWRITE_JPEG_QUALITY, quality])[1]
        err_ours = np.abs(_cv2_decode(ours).astype(int) - img).max()
        err_cv2 = np.abs(_cv2_decode(theirs).astype(int) - img).max()
        assert err_ours <= err_cv2 + 1, (h, w)
        np.testing.assert_array_equal(codec.decode(ours), _cv2_decode(ours))


# ---------------------------------------------------------------------------
# PNG and BMP
# ---------------------------------------------------------------------------

def _png(rows, width, height, depth, ctype, plte=None, trns=None,
         filters=(0, 1, 2, 3, 4), interlace=0):
    """A PNG written here, cycling the row filters over ``filters``. With
    ``interlace`` set, ``rows`` holds the Adam7 passes' rows, one list per
    pass (an empty pass an empty list), each pass filtered on its own."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    if interlace:
        raw = b"".join(_filtered(p, bpp, filters) for p in rows if p)
    else:
        raw = _filtered(rows, bpp, filters)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", bytes(plte))
    if trns is not None:
        data += chunk(b"tRNS", bytes(trns))
    return data + chunk(b"IDAT", zlib.compress(bytes(raw))) + \
        chunk(b"IEND", b"")


def _filtered(rows, bpp, filters):
    raw = bytearray()
    prev = bytes(len(rows[0]))
    for r, row in enumerate(rows):
        ft = filters[r % len(filters)]
        out = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (x - pred) & 0xFF
        raw += bytes([ft]) + out
        prev = bytes(row)
    return bytes(raw)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _adam7_rows(vals, chans, depth):
    """(H, W*C) sample values -> the seven passes' packed rows."""
    h = vals.shape[0]
    px = vals.reshape(h, -1, chans)
    return [_pack_rows(px[y0::dy, x0::dx].reshape(
                len(range(y0, h, dy)), -1), depth)
            if px[y0::dy, x0::dx].size else []
            for x0, y0, dx, dy in ADAM7]


def _pack_rows(vals, depth):
    """(H, W*C) sample values -> PNG rows of ``depth`` bits."""
    h = vals.shape[0]
    if depth == 16:
        return [vals[r].astype(">u2").tobytes() for r in range(h)]
    if depth == 8:
        return [vals[r].astype(np.uint8).tobytes() for r in range(h)]
    bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(h, -1).astype(np.uint8)
    return [np.packbits(bits[r]).tobytes() for r in range(h)]


PNG_CASES = {   # name -> (depth, colour type, channels)
    "grey1": (1, 0, 1), "grey2": (2, 0, 1), "grey4": (4, 0, 1),
    "grey8": (8, 0, 1), "grey16": (16, 0, 1), "grey_alpha8": (8, 4, 2),
    "grey_alpha16": (16, 4, 2), "rgb8": (8, 2, 3), "rgb16": (16, 2, 3),
    "rgba8": (8, 6, 4), "rgba16": (16, 6, 4), "palette1": (1, 3, 1),
    "palette2": (2, 3, 1), "palette4": (4, 3, 1), "palette8": (8, 3, 1),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_decodes_bit_equal_to_opencv(case):
    depth, ctype, chans = PNG_CASES[case]
    h, w = 13, 19
    rs = np.random.default_rng(len(case))
    top = (1 << depth) - 1
    vals = rs.integers(0, top + 1, (h, w * chans))
    plte = trns = None
    if ctype == 3:
        plte = rs.integers(0, 256, 3 << depth).astype(np.uint8)
        trns = rs.integers(0, 256, 2).astype(np.uint8)
    data = _png(_pack_rows(vals, depth), w, h, depth, ctype, plte, trns)
    want = _cv2_decode(data)
    assert want is not None and want.shape == (h, w, 3)
    np.testing.assert_array_equal(codec.decode(data), want)


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_adam7_png_decodes_bit_equal_to_opencv(case):
    """Adam7-interlaced files (written here with zlib: neither OpenCV nor
    PIL writes them) at sizes where some passes are empty."""
    depth, ctype, chans = PNG_CASES[case]
    rs = np.random.default_rng(100 + len(case))
    for h, w in [(13, 19), (1, 1), (3, 5), (8, 9), (2, 1)]:
        vals = rs.integers(0, 1 << depth, (h, w * chans))
        plte = trns = None
        if ctype == 3:
            plte = rs.integers(0, 256, 3 << depth).astype(np.uint8)
            trns = rs.integers(0, 256, 2).astype(np.uint8)
        data = _png(_adam7_rows(vals, chans, depth), w, h, depth, ctype,
                    plte, trns, interlace=1)
        want = _cv2_decode(data)
        assert want is not None and want.shape == (h, w, 3)
        np.testing.assert_array_equal(codec.decode(data), want,
                                      err_msg=str((h, w)))


@pytest.mark.parametrize("kind", ["bgr", "grey", "bgra", "bgr16"])
def test_opencv_written_png_decodes_bit_equal(kind):
    img = _scene(37, 50, 3)
    arr = {"bgr": img, "grey": img[..., 1],
           "bgra": np.dstack([img, img[..., :1]]),
           "bgr16": img.astype(np.uint16) * 257 + 3}[kind]
    buf = cv2.imencode(".png", arr)[1].tobytes()
    np.testing.assert_array_equal(codec.decode(buf), _cv2_decode(buf))


def test_png_encoder_and_adam7_and_bmp():
    img = _scene(23, 31, 4)
    for arr in (img, img[..., 0]):
        np.testing.assert_array_equal(
            _cv2_decode(codec.encode_png(arr)),
            cv2.cvtColor(arr, cv2.COLOR_GRAY2BGR) if arr.ndim == 2 else arr)
        np.testing.assert_array_equal(codec.decode(codec.encode_png(arr)),
                                      _cv2_decode(codec.encode_png(arr)))
    rgb = img[:, :, ::-1].reshape(23, -1)
    inter = _png(_adam7_rows(rgb, 3, 8), 31, 23, 8, 2, interlace=1)
    got = codec.decode(inter, "i.png")
    np.testing.assert_array_equal(got, _cv2_decode(inter))
    np.testing.assert_array_equal(got, img)
    for arr in (img, img[..., 2]):
        buf = cv2.imencode(".bmp", arr)[1].tobytes()
        np.testing.assert_array_equal(codec.decode(buf), _cv2_decode(buf))


# ---------------------------------------------------------------------------
# resize and colour
# ---------------------------------------------------------------------------

RESIZES = {   # name -> ((h, w), (dst h, dst w))
    "shrink": ((375, 500), (300, 300)),
    "shrink_half": ((64, 90), (32, 45)),
    "shrink_third": ((90, 90), (30, 30)),
    "enlarge": ((60, 80), (300, 300)),
    "enlarge_double": ((64, 64), (128, 128)),
    "non_integer": ((37, 53), (50, 29)),
    "crop_edge": ((256, 256), (224, 224)),
    "width_only": ((50, 50), (50, 20)),
    "height_only": ((50, 50), (20, 50)),
}


@pytest.mark.parametrize("flag", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_matches_opencv(flag, case):
    (h, w), (dh, dw) = RESIZES[case]
    rs = np.random.default_rng(flag)
    for c in (3, 1):
        img = _scene(h, w, flag, c)
        img = img[..., 0] if c == 1 else img
        got = tresize.resize(img, (dw, dh), flag)
        want = cv2.resize(img, (dw, dh), interpolation=flag)
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want)
        if flag == cv2.INTER_CUBIC and h != dh and w != dw:
            assert diff.max() <= 1 and (diff > 0).mean() <= CUBIC_U8_SHARE
        else:
            assert diff.max() == 0
        f = img.astype(np.float32) + rs.random(img.shape, dtype=np.float32)
        got = tresize.resize(f, (dw, dh), flag)
        want = cv2.resize(f, (dw, dh), interpolation=flag)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= F32_TOL


def test_bgr_to_hsv_is_bit_equal_over_every_colour():
    for red in np.array_split(np.arange(256), 8):   # bounded memory
        b, g, r = np.meshgrid(np.arange(256), np.arange(256), red,
                              indexing="ij")
        bgr = np.stack([b, g, r], -1).astype(np.uint8).reshape(-1, 256, 3)
        np.testing.assert_array_equal(tresize.bgr_to_hsv(bgr),
                                      cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_matches_opencvs_per_pixel_and_vector_paths():
    for hues in np.array_split(np.arange(180), 8):   # bounded memory
        h, s, v = np.meshgrid(hues, np.arange(256), np.arange(256),
                              indexing="ij")
        hsv = np.stack([h, s, v], -1).astype(np.uint8)
        for width in (16, 256, 40):
            rows = hsv.reshape(-1, 256, 3)[:, :width] if width != 16 \
                else hsv.reshape(-1, 16, 3)
            np.testing.assert_array_equal(
                tresize.hsv_to_bgr(rows),
                cv2.cvtColor(np.ascontiguousarray(rows),
                             cv2.COLOR_HSV2BGR))


# ---------------------------------------------------------------------------
# preprocessing classes
# ---------------------------------------------------------------------------

def _ops(m):
    """Every image preprocessing class of module ``m``, built with the
    same arguments, and the largest difference allowed."""
    means = np.random.default_rng(1).uniform(0, 50, (48, 64, 3))
    return {
        "ImageResize_linear": (m.ImageResize(30, 40), F32_TOL),
        "ImageResize_nearest": (m.ImageResize(50, 70, 0), F32_TOL),
        "ImageResize_cubic": (m.ImageResize(31, 45, 2), F32_TOL),
        "ImageResize_area": (m.ImageResize(20, 30, 3), F32_TOL),
        "ImageResize_lanczos": (m.ImageResize(70, 90, 4), F32_TOL),
        "ImageResize_random": (m.ImageResize(33, 41, -1), F32_TOL),
        "ImageAspectScale": (m.ImageAspectScale(40, 4, 80), F32_TOL),
        "ImageRandomAspectScale": (m.ImageRandomAspectScale([20, 30, 50]),
                                   F32_TOL),
        "ImageBrightness": (m.ImageBrightness(-20, 30), 0),
        "ImageContrast": (m.ImageContrast(0.5, 1.5), 0),
        "ImageHue": (m.ImageHue(-30, 30), 0),
        "ImageSaturation": (m.ImageSaturation(0.3, 1.7), 0),
        "ImageChannelOrder": (m.ImageChannelOrder(), 0),
        "ImageColorJitter": (m.ImageColorJitter(
            brightness_prob=0.7, contrast_prob=0.7, hue_prob=0.7,
            saturation_prob=0.7), 0),
        "ImageChannelNormalize": (m.ImageChannelNormalize(
            123, 117, 104, 58, 57, 59), 0),
        "PerImageNormalize": (m.PerImageNormalize(-1, 1), 0),
        "ImagePixelNormalize": (m.ImagePixelNormalize(means), 0),
        "ImageCenterCrop": (m.ImageCenterCrop(30, 20), 0),
        "ImageRandomCrop": (m.ImageRandomCrop(30, 20), 0),
        "ImageFixedCrop": (m.ImageFixedCrop(0.1, 0.2, 0.7, 0.9), 0),
        "ImageFixedCrop_abs": (m.ImageFixedCrop(3, 5, 40, 30,
                                                normalized=False), 0),
        "ImageExpand": (m.ImageExpand(min_expand_ratio=1.2,
                                      max_expand_ratio=2.0), 0),
        "ImageFiller": (m.ImageFiller(0.1, 0.2, 0.5, 0.6, 7), 0),
        "ImageHFlip": (m.ImageHFlip(), 0),
        "ImageMirror": (m.ImageMirror(), 0),
        "ImageRandomPreprocessing": (m.ImageRandomPreprocessing(
            m.ImageHFlip(), 0.5), 0),
        "ImageMatToTensor": (m.ImageMatToTensor(to_rgb=True), 0),
        "ImageMatToFloats": (m.ImageMatToFloats(format="NHWC"), 0),
    }


@pytest.mark.parametrize("name", sorted(_ops(timg)))
def test_preprocessing_matches_jax_under_one_seed(name):
    top, tol = _ops(timg)[name]
    jop, _ = _ops(jimg)[name]
    for k in range(4):
        img = _scene(48, 64, 20 + k).astype(np.float32)
        out = {}
        for pkg, op, mod in (("jax", jop, jimg), ("torch", top, timg)):
            random.seed(100 + k)
            feat = mod.ImageFeature(img.copy(), label=3, uri=f"u{k}")
            out[pkg] = op.apply(feat)
            out[pkg + "_next"] = random.random()   # the same draws taken
        assert out["jax_next"] == out["torch_next"]
        for key in ("mat", "floats", "boundingBox", "imInfo"):
            if key in out["jax"]:
                want, got = out["jax"][key], out["torch"][key]
                assert got.shape == want.shape and got.dtype == want.dtype
                assert float(np.abs(got.astype(np.float64) -
                                    want).max()) <= tol, key


def test_bytes_samples_and_feature_adapters_match_jax():
    img = _scene(20, 30, 5)
    png = cv2.imencode(".png", img)[1].tobytes()
    for pkg, mod in (("jax", jimg), ("torch", timg)):
        f = mod.ImageFeature(uri="a.png")
        f["bytes"] = png
        f = mod.ImageBytesToMat().apply(f)
        np.testing.assert_array_equal(f["mat"], img.astype(np.float32))
        assert tuple(f["originalSize"]) == (20, 30, 3)
        g = mod.ImageFeature(uri="raw")
        g["bytes"] = img.tobytes()
        g = mod.ImagePixelBytesToMat(20, 30).apply(g)
        np.testing.assert_array_equal(g["mat"], img.astype(np.float32))
        f = mod.ImageMatToTensor().apply(mod.ImageFeature(img, label=2))
        f = mod.ImageSetToSample().apply(f)
        np.testing.assert_array_equal(mod.ImageFeatureToTensor().apply(f),
                                      np.transpose(img, (2, 0, 1)))
        s = mod.ImageFeatureToSample().apply(f)
        np.testing.assert_array_equal(s.features[0],
                                      np.transpose(img, (2, 0, 1)))
        assert np.asarray(s.labels).reshape(-1).tolist() == [2.0]


# ---------------------------------------------------------------------------
# ImageSet and the streaming pipeline
# ---------------------------------------------------------------------------

def _write_tree(root, n=8):
    """Seeded images in two class folders, JPEG, PNG and BMP."""
    paths = []
    for i in range(n):
        img = _scene(30 + 3 * i, 41 + 2 * i, 30 + i)
        folder = os.path.join(root, "cls_a" if i % 2 else "cls_b")
        os.makedirs(folder, exist_ok=True)
        ext = (".jpg", ".png", ".bmp", ".jpeg")[i % 4]
        path = os.path.join(folder, f"im{i}{ext}")
        with open(path, "wb") as f:
            f.write(cv2.imencode(ext if ext != ".jpeg" else ".jpg",
                                 img)[1].tobytes())
        paths.append(path)
    with open(os.path.join(root, "cls_a", "notes.txt"), "w") as f:
        f.write("not an image")
    return sorted(paths)


def _assert_sets_equal(got, want, tol=0.0):
    assert len(got) == len(want) and type(got).__name__ == \
        type(want).__name__
    for g, w in zip(got.features, want.features):
        assert g.get("uri") == w.get("uri")
        assert g.get("label") == w.get("label")
        assert g["mat"].shape == w["mat"].shape
        assert float(np.abs(g["mat"] - w["mat"]).max()) <= tol


def test_image_set_read_matches_jax(tmp_path):
    root = str(tmp_path)
    _write_tree(root)
    cases = [dict(path=root), dict(path=root, with_label=True),
             dict(path=root, with_label=True, one_based_label=False),
             dict(path=os.path.join(root, "cls_a", "*.png")),
             dict(path=os.path.join(root, "cls_b", "im0.jpg")),
             dict(path=root, shard_index=1, num_shards=3),
             dict(path=root, with_label=True, shard_index=0, num_shards=2),
             dict(path=root, resize_h=20, resize_w=25)]
    for kw in cases:
        want = jimg.ImageSet.read(**kw)
        got = timg.ImageSet.read(**kw)
        _assert_sets_equal(got, want, F32_TOL if "resize_h" in kw else 0.0)
        assert getattr(got, "label_map", None) == \
            getattr(want, "label_map", None)
        if kw.get("num_shards", 1) > 1:
            assert (got.shard_index, got.num_shards) == \
                (want.shard_index, want.num_shards)


def test_image_set_transform_split_and_feature_set_match_jax(tmp_path):
    root = str(tmp_path)
    _write_tree(root)
    chain = {m: ch([m.ImageResize(24, 24), m.ImageRandomCrop(20, 20),
                    m.ImageChannelNormalize(120, 110, 100),
                    m.ImageMatToTensor(), m.ImageSetToSample()])
             for m, ch in ((jimg, JChained), (timg, TChained))}
    sets = {}
    for m in (jimg, timg):
        random.seed(7)
        sets[m] = m.ImageSet.read(root, with_label=True).transform(chain[m])
    got, want = sets[timg], sets[jimg]
    for g, w in zip(got.features, want.features):
        assert float(np.abs(g["floats"] - w["floats"]).max()) <= F32_TOL
    for g, w in zip(got.random_split([0.6, 0.4], seed=3),
                    want.random_split([0.6, 0.4], seed=3)):
        assert [f["uri"] for f in g.features] == \
            [f["uri"] for f in w.features]
        assert g.label_map == w.label_map
    tfs, jfs = got.to_feature_set(), want.to_feature_set()
    assert tfs.size() == jfs.size() == 8
    tb = next(iter(tfs.batches(4)))
    jb = next(iter(jfs.batches(4)))
    assert float(np.abs(np.asarray(tb.inputs[0]) -
                        np.asarray(jb.inputs[0])).max()) <= F32_TOL
    np.testing.assert_array_equal(np.asarray(tb.targets),
                                  np.asarray(jb.targets))
    arr = [np.ones((5, 6, 3), np.float32) * i for i in range(3)]
    a, b = timg.ImageSet.array(arr, [1, 2, 3]), jimg.ImageSet.array(
        arr, [1, 2, 3])
    _assert_sets_equal(a, b)
    assert a.is_local() and not a.to_distributed(1, 2).is_local()


@pytest.mark.parametrize("backend", ["thread"])
def test_image_pipeline_batches_match_jax(tmp_path, backend):
    root = str(tmp_path)
    _write_tree(root)
    kw = dict(height=28, width=36, num_workers=2, data_format="th",
              mean=(104, 117, 123), std=(58, 57, 59))
    jfs = jimg.ImagePipelineFeatureSet.read_folder(root, **kw)
    tfs = timg.ImagePipelineFeatureSet.read_folder(root, backend=backend,
                                                   **kw)
    assert tfs.size() == jfs.size() == 8 and tfs.label_map == jfs.label_map
    tb = list(tfs.batches(3, shuffle=True, drop_remainder=False,
                          pad_remainder=True, seed=5))
    jb = list(jfs.batches(3, shuffle=True, drop_remainder=False,
                          pad_remainder=True, seed=5))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert t.inputs[0].shape == j.inputs[0].shape == (3, 3, 28, 36)
        assert float(np.abs(t.inputs[0] - j.inputs[0]).max()) <= F32_TOL
        np.testing.assert_array_equal(t.targets, j.targets)
        np.testing.assert_array_equal(t.weights, j.weights)
    stats = tfs.stats.as_dict()
    assert stats["batches"] == 3 and stats["images"] == 8


# ---------------------------------------------------------------------------
# Image3D
# ---------------------------------------------------------------------------

def test_image3d_transforms_match_jax():
    vol = np.random.default_rng(8).standard_normal((9, 12, 14)).astype(
        np.float32)
    mat = np.array([[1.0, 0.1, 0.0], [0.0, 0.95, 0.05], [0.02, 0.0, 1.1]])
    cases = [
        lambda m: m.Crop3D((1, 2, 3), (5, 6, 7)),
        lambda m: m.RandomCrop3D(4, 5, 6),
        lambda m: m.CenterCrop3D(5, 7, 9),
        lambda m: m.Rotate3D((0.3, 0.0, -0.2)),
        lambda m: m.AffineTransform3D(mat, np.array([0.5, -1.0, 0.2])),
        lambda m: m.AffineTransform3D(mat, clamp_mode="padding",
                                      pad_val=-1.0),
    ]
    for make in cases:
        outs = []
        for m, fm in ((jimg3d, jimg), (timg3d, timg)):
            random.seed(9)
            feat = fm.ImageFeature(vol.copy())
            outs.append(make(m).apply(feat)["mat"])
        assert outs[0].shape == outs[1].shape
        np.testing.assert_array_equal(outs[1], outs[0])


# ---------------------------------------------------------------------------
# Estimator.train_imagefeature
# ---------------------------------------------------------------------------

def test_estimator_train_imagefeature_matches_jax(tmp_path):
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    from analytics_zoo_tpu.pipeline.api.keras.models import \
        Sequential as JSequential
    from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

    root = str(tmp_path)
    _write_tree(root)

    def chain(m, ch):
        return ch([m.ImageResize(12, 12), m.ImageChannelNormalize(
            120, 110, 100, 60, 60, 60), m.ImageMatToTensor(),
            m.ImageSetToSample()])

    def net(layers, seq):
        model = seq()
        model.add(layers.Convolution2D(2, 3, 3, activation="relu",
                                       input_shape=(3, 12, 12),
                                       name="tif_conv"))
        model.add(layers.Flatten(name="tif_flat"))
        model.add(layers.Dense(3, activation="softmax", name="tif_dense"))
        return model

    model = net(tl, Sequential)
    model.graph_function()
    init = {k: p.detach().numpy().copy()
            for k, p in model.named_parameters()}
    jmodel = net(jl, JSequential)
    jest = JEstimator(jmodel, "sgd")
    loss = "sparse_categorical_crossentropy"
    jest._ensure_trainer(jobj.get_loss(loss), None)
    jest.trainer.set_params(
        {layer: {leaf: init[f"{layer}.{leaf}"] for leaf in ("kernel",
                                                            "bias")}
         for layer in ("tif_conv", "tif_dense")}, {})
    est = Estimator(model, "sgd")
    jset = jimg.ImageSet.read(root, with_label=True, one_based_label=False)
    tset = timg.ImageSet.read(root, with_label=True, one_based_label=False)
    jest.train_imagefeature(jset.transform(chain(jimg, JChained)), loss,
                            batch_size=4)
    est.train_imagefeature(tset.transform(chain(timg, TChained)), loss,
                           batch_size=4)
    want = jax.tree.map(np.asarray, jest.trainer.params)
    moved = 0.0
    for k, p in model.named_parameters():
        layer, leaf = k.split(".")
        np.testing.assert_allclose(p.detach().numpy(), want[layer][leaf],
                                   rtol=0, atol=FIT_TOL, err_msg=k)
        moved = max(moved, float(np.abs(p.detach().numpy() -
                                        init[k]).max()))
    assert moved > 1e-4


def test_committed_codec_fixtures_are_opencvs():
    """The JPEG files ``chip_smoke.py`` decodes on the card, where no
    OpenCV is installed (``tools/codec_fixtures``): OpenCV here decodes
    each to the SHA-256 its manifest holds, and so does the port."""
    import hashlib
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "tools" / "codec_fixtures"
    manifest = json.loads((root / "manifest.json").read_text())
    assert len(manifest) == 6
    for name, want in manifest.items():
        data = (root / name).read_bytes()
        for px in (_cv2_decode(data), codec.decode(data, name)):
            assert list(px.shape) == want["shape"]
            assert hashlib.sha256(np.ascontiguousarray(px).tobytes()) \
                .hexdigest() == want["opencv_sha256"], name
