"""Write the JPEG files ``chip_smoke.py``'s detect phase decodes where no
OpenCV is installed, with OpenCV's pixels of each as a SHA-256.

    python tools/make_codec_fixtures.py [--out tools/codec_fixtures]

Needs ``cv2`` and ``PIL`` (the machine that writes the files, not the one
that reads them). Seeded scenes, 96 x 128: progressive JPEG from OpenCV
(4:2:0 with a restart interval, 4:4:4), one cut after its third scan with
an EOI appended (libjpeg block-smooths what the missing scans leave), and
4-component files from PIL (CMYK as Photoshop writes it, the same marked
YCCK, and a progressive CMYK). ``manifest.json`` maps each file to the
shape and the SHA-256 of ``cv2.imdecode(data, cv2.IMREAD_COLOR)``.
"""

import argparse
import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

H, W = 96, 128


def scene(seed, c=3):
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([xx * 255.0 / W, yy * 255.0 / H,
                    (np.sin(xx / 11.0) + np.cos(yy / 7.0)) * 60 + 128,
                    (xx + yy) * 255.0 / (H + W)], -1)[..., :c]
    img = img + rs.normal(0, 8, img.shape)
    for _ in range(3):
        y0, x0 = rs.integers(0, H - 20), rs.integers(0, W - 20)
        img[y0:y0 + 20, x0:x0 + 30] = rs.integers(0, 256, c)
    return np.clip(img, 0, 255).astype(np.uint8)


def progressive(img, sampling, rst=0):
    flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if rst:
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    return cv2.imencode(".jpg", img, flags)[1].tobytes()


def pil_cmyk(seed, prog):
    out = io.BytesIO()
    Image.fromarray(scene(seed, 4), "CMYK").save(out, "JPEG", quality=85,
                                                 progressive=prog)
    return out.getvalue()


def files():
    p420 = progressive(scene(1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 2)
    p444 = progressive(scene(2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    sos = [i for i in range(len(p444) - 1) if p444[i:i + 2] == b"\xff\xda"]
    cmyk = pil_cmyk(3, False)
    ycck = bytearray(cmyk)
    ycck[ycck.index(b"Adobe") + 11] = 2
    return {"progressive_420_rst2.jpg": p420,
            "progressive_444.jpg": p444,
            "progressive_cut_after_3_scans.jpg": p444[:sos[3]] + b"\xff\xd9",
            "cmyk.jpg": cmyk, "ycck.jpg": bytes(ycck),
            "cmyk_progressive.jpg": pil_cmyk(4, True)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "codec_fixtures"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        px = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        manifest[name] = {"shape": list(px.shape),
                          "opencv_sha256": hashlib.sha256(
                              np.ascontiguousarray(px).tobytes()).hexdigest(),
                          "opencv": cv2.__version__}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
