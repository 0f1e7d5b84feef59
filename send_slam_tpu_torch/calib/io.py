"""Calibration persistence: the reference's JSON schema, byte-for-byte.

Schema (camera_calibrator.ex:321-399): matrices serialize as
``{"shape": [...], "data": [flat f64...]}``; the file carries
``camera_matrix``, ``distortion_coeffs``, ``reprojection_error``,
``successful_frames``. Default path priv/calibration/latest.json,
overridable via SEND_SLAM_CALIBRATION_FILE (camera_calibrator.ex:33-49).

The port's own copy of ``send_slam_tpu/calib/io.py`` (JSON and numpy).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

ENV_VAR = "SEND_SLAM_CALIBRATION_FILE"
DEFAULT_RELATIVE = os.path.join("priv", "calibration", "latest.json")


def default_output_path(root: str | None = None) -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return os.path.expanduser(env)
    return os.path.join(root or os.getcwd(), DEFAULT_RELATIVE)


def _mat_payload(arr: np.ndarray) -> Dict[str, Any]:
    a = np.asarray(arr, np.float64)
    return {"shape": list(a.shape), "data": a.reshape(-1).tolist()}


def _mat_from_payload(payload: Dict[str, Any]) -> np.ndarray:
    shape = [int(round(s)) for s in payload["shape"]]
    return np.asarray(payload["data"], np.float64).reshape(shape)


def calibration_to_json(calib: Dict[str, Any]) -> str:
    return json.dumps({
        "camera_matrix": _mat_payload(calib["camera_matrix"]),
        "distortion_coeffs": _mat_payload(calib["distortion_coeffs"]),
        "reprojection_error": float(calib["reprojection_error"]),
        "successful_frames": int(calib["successful_frames"]),
    })


def calibration_from_json(text: str) -> Dict[str, Any]:
    raw = json.loads(text)
    return {
        "camera_matrix": _mat_from_payload(raw["camera_matrix"]),
        "distortion_coeffs": _mat_from_payload(raw["distortion_coeffs"]),
        "reprojection_error": float(raw["reprojection_error"]),
        "successful_frames": int(round(raw["successful_frames"])),
    }


def save_to_file(calib: Dict[str, Any], path: str | None = None) -> str:
    path = path or default_output_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(calibration_to_json(calib))
    return path


def load_from_file(path: str | None = None) -> Dict[str, Any]:
    path = path or default_output_path()
    with open(path) as f:
        return calibration_from_json(f.read())
