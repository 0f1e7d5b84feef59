"""Map checkpoint and resume, in the JAX package's file format.

The port's own copy of ``send_slam_tpu/io/map_io.py``: a checkpoint is
one compressed npz holding one array per MapState field, under the
field's name and in the JAX package's dtype (descriptor words as
uint32), and a ``__header__`` JSON of the format version and the
capacities. A map saved by either package loads in the other.
``ORBSLAM3_MAP_PATH`` (the reference's environment variable) names the
directory; the default is ``priv/maps/map.npz`` under the working
directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from send_slam_tpu_torch.config import MapConfig
from send_slam_tpu_torch.models.map_state import (
    MapState, empty_map, map_from_numpy, map_to_numpy,
)

FORMAT_VERSION = 2
ENV_VAR = "ORBSLAM3_MAP_PATH"


def default_map_path(root: Optional[str] = None) -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        base = os.path.expanduser(env)
    else:
        base = os.path.join(root or os.getcwd(), "priv", "maps")
    return os.path.join(base, "map.npz")


def save_map(m: MapState, path: Optional[str] = None) -> str:
    path = path or default_map_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = json.dumps({
        "version": FORMAT_VERSION,
        "max_keyframes": int(m.max_keyframes),
        "max_landmarks": int(m.max_landmarks),
        "n_keypoints": int(m.n_keypoints),
    })
    np.savez_compressed(path, __header__=np.frombuffer(
        header.encode(), dtype=np.uint8), **map_to_numpy(m))
    return path


def load_map(path: Optional[str] = None, device=None) -> MapState:
    """Read a checkpoint onto ``device`` (default the card). Fields the
    file lacks (an older version) take their empty-map defaults at the
    header's capacities."""
    path = path or default_map_path()
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header["version"] > FORMAT_VERSION:
            raise ValueError(f"unsupported map version {header['version']}")
        cfg = dataclasses.replace(
            MapConfig(), max_keyframes=int(header["max_keyframes"]),
            max_landmarks=int(header["max_landmarks"]))
        arrays = map_to_numpy(empty_map(cfg, int(header["n_keypoints"]),
                                        device="cpu"))
        arrays.update({f: data[f] for f in arrays if f in data.files})
    return map_from_numpy(arrays, device=device)
