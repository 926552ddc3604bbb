"""EXIF orientation in the port's JPEG decode against OpenCV.

``cv2.imdecode(buf, IMREAD_COLOR)``, the JAX package's decode, turns a
JPEG by its APP1 Exif Orientation tag. Each of the eight values, in
both TIFF byte orders, on a small seeded JPEG from the port's encoder
with an Exif block spliced in after SOI, decodes through
``codec.decode`` to OpenCV's shape and bit-equal pixels; so does a file
whose Exif block is cut or holds no Orientation.
"""

import struct

import cv2
import numpy as np
import pytest

from analytics_zoo_tpu_torch.feature.image import codec


def _exif(orientation=None, order="<", cut=False):
    bo = b"II" if order == "<" else b"MM"
    entries = []
    if orientation is not None:
        entries.append(struct.pack(order + "HHI", 0x0112, 3, 1) +
                       struct.pack(order + "H", orientation) + b"\0\0")
    # an unrelated tag first (ImageWidth, LONG)
    entries.insert(0, struct.pack(order + "HHII", 0x0100, 4, 1, 40))
    tiff = bo + struct.pack(order + "HI", 42, 8) + \
        struct.pack(order + "H", len(entries)) + b"".join(entries) + \
        struct.pack(order + "I", 0)
    if cut:
        tiff = tiff[:12]
    seg = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg


def _jpeg(seed=0, shape=(24, 40, 3)):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return codec.encode_jpeg(img, 95)


def _both(raw):
    want = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    return codec.decode(raw), want


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_pixels_as_opencv_does(orientation, order):
    jpg = _jpeg(orientation)
    raw = jpg[:2] + _exif(orientation, order) + jpg[2:]
    got, want = _both(raw)
    assert got.shape == want.shape
    assert (got.shape[:2] == (40, 24)) == (orientation >= 5)
    np.testing.assert_array_equal(got, want)
    assert codec.jpeg_exif_orientation(raw) == orientation


@pytest.mark.parametrize("kind", ["no_tag", "cut", "out_of_range"])
def test_exif_without_a_usable_orientation_leaves_pixels(kind):
    jpg = _jpeg(9)
    block = {"no_tag": _exif(None), "cut": _exif(6, cut=True),
             "out_of_range": _exif(9)}[kind]
    raw = jpg[:2] + block + jpg[2:]
    got, want = _both(raw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codec.decode(jpg))
