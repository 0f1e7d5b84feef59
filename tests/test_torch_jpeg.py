"""The port's JPEG (send_slam_tpu_torch/io/jpeg.py) against OpenCV, which
the JAX package's panel calls: ``cv2.imencode(".jpg", bgr)`` for the
frames it sends and ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` for the
frames it gets back.

Bars: the port's decode of an OpenCV JPEG within 2 grey levels of
OpenCV's grayscale decode; OpenCV's decode of the port's JPEG within
1 dB of the PSNR that OpenCV's own quality-95 encode reaches; the port's
own round trip at that PSNR too. Sizes are drawn by hypothesis, odd and
not multiples of the 16-pixel 4:2:0 block.
"""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from send_slam_tpu_torch.io.jpeg import QUALITY, decode_jpeg_gray, encode_jpeg


def scene(h, w, seed):
    """A colour frame with edges, texture and smooth gradients."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / (7 + seed % 5)),
                    128 + 100 * np.cos(yy / 9.0),
                    (xx + yy) * 255.0 / max(h + w, 1)], -1)
    for _ in range(max(3, h * w // 400)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 12), x:x + rng.integers(1, 12)] = \
            rng.uniform(0, 255, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def cv_encode(rgb, extra=()):
    flags = [cv2.IMWRITE_JPEG_QUALITY, QUALITY, *extra]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], flags)
    assert ok
    return buf.tobytes()


def cv_gray(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def cv_rgb(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


SIZES = st.tuples(st.integers(1, 97), st.integers(1, 131), st.integers(0, 99))


@settings(max_examples=40, deadline=None)
@given(SIZES)
def test_decode_of_opencv_jpeg(size):
    h, w, seed = size
    rgb = scene(h, w, seed)
    data = cv_encode(rgb)
    got = decode_jpeg_gray(data)
    assert got.shape == (h, w) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - cv_gray(data)).max() <= 2


@settings(max_examples=40, deadline=None)
@given(SIZES)
def test_opencv_decode_of_port_jpeg(size):
    h, w, seed = size
    rgb = scene(h, w, seed)
    ours = encode_jpeg(rgb)
    theirs = cv_encode(rgb)
    assert ours[:2] == b"\xff\xd8" and ours[-2:] == b"\xff\xd9"
    assert psnr(cv_rgb(ours), rgb) >= psnr(cv_rgb(theirs), rgb) - 1.0
    # The port's own round trip: its gray is OpenCV's gray of its file.
    assert np.abs(decode_jpeg_gray(ours).astype(int)
                  - cv_gray(ours)).max() <= 2


def test_frame_size_round_trip_and_formats():
    rgb = scene(480, 640, 1)
    ours = encode_jpeg(rgb)
    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    assert psnr(decode_jpeg_gray(ours), gray) >= psnr(cv_gray(cv_encode(rgb)),
                                                      gray) - 1.0
    # Grayscale and progressive files decode as OpenCV decodes them.
    ok, g = cv2.imencode(".jpg", gray)
    assert np.abs(decode_jpeg_gray(g.tobytes()).astype(int)
                  - cv_gray(g.tobytes())).max() <= 2
    prog = cv_encode(rgb, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    assert np.abs(decode_jpeg_gray(prog).astype(int)
                  - cv_gray(prog)).max() <= 2


@pytest.mark.parametrize("data", [b"", b"!!!", b"\xff\xd8\xff\xe0 truncated",
                                  cv2.imencode(".png", np.zeros((4, 4),
                                                                np.uint8))[1]
                                  .tobytes()])
def test_undecodable_input_raises_value_error(data):
    with pytest.raises(ValueError):
        decode_jpeg_gray(data)
