"""Calibrate a camera from checkerboard images with the PyTorch port —
the counterpart of examples/calibrate_from_images.py without JAX or
OpenCV.

Usage:
    python examples/calibrate_from_images_torch.py 'shots/*.jpg' \
        --pattern 9x6 --square-mm 25 [--out priv/calibration/latest.json] \
        [--device cpu]

Reads binary .pgm/.ppm (the port's io/ppm.py; colour files as BT.601
luma) and .jpg/.jpeg (the port's io/jpeg.py, the decoder's luma plane);
PNG is not read yet (the port has no PNG decoder). Detection and the
Levenberg-Marquardt refinement run on the card unless ``--device cpu``.
Prints the recovered intrinsics and saves them in the reference's JSON
format, which both packages and the reference app load.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PPM = (".pgm", ".ppm")
JPEG = (".jpg", ".jpeg")


def read_gray(path: str) -> np.ndarray:
    """(H, W) float32 gray of a .pgm/.ppm/.jpg/.jpeg file."""
    from send_slam_tpu_torch.io.jpeg import decode_jpeg_gray
    from send_slam_tpu_torch.io.ppm import decode_ppm, rgb_to_gray_u8
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext in PPM:
        img = decode_ppm(data)
        if img.ndim == 3:
            img = rgb_to_gray_u8(img)
    elif ext in JPEG:
        img = decode_jpeg_gray(data)
    else:
        raise ValueError(f"{path}: only {PPM + JPEG} files are read")
    return img.astype(np.float32)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("pattern_glob", help="glob of checkerboard images")
    p.add_argument("--pattern", default="9x6",
                   help="inner corners, COLSxROWS (default 9x6)")
    p.add_argument("--square-mm", type=float, default=25.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args()

    from send_slam_tpu_torch.calib.io import save_to_file
    from send_slam_tpu_torch.calib.pipeline import calibrate

    cols, rows = (int(v) for v in args.pattern.split("x"))
    paths = sorted(glob.glob(args.pattern_glob))
    if not paths:
        sys.exit(f"no images match {args.pattern_glob}")
    frames = []
    for path in paths:
        try:
            frames.append(read_gray(path))
        except ValueError as e:
            print(f"skipped: {e}", file=sys.stderr)
    print(f"loaded {len(frames)} frames")

    result = calibrate(frames, (cols, rows), args.square_mm,
                       device=args.device)
    K = result["camera_matrix"]
    d = result["distortion_coeffs"].reshape(-1)
    print(f"fx={K[0,0]:.2f} fy={K[1,1]:.2f} cx={K[0,2]:.2f} cy={K[1,2]:.2f}")
    print(f"dist: k1={d[0]:.4f} k2={d[1]:.4f} p1={d[2]:.5f} "
          f"p2={d[3]:.5f} k3={d[4]:.4f}")
    print(f"rms reprojection: {result['reprojection_error']:.3f} px "
          f"over {result['successful_frames']} frames")
    path = save_to_file(result, args.out)
    print(f"saved -> {path}")


if __name__ == "__main__":
    main()
