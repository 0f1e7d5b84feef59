"""The lane mesh: which device runs which camera lanes.

Counterpart of ``send_slam_tpu/parallel/mesh.py``. A ``Mesh`` is an
array of ``torch.device`` with axis names and ``.shape`` as a dict, as
``jax.sharding.Mesh`` has them, with the same factorisation of the
device count over several axis names. Lanes are split over the mesh's
entries in contiguous blocks, in the entries' flat order, as
``PartitionSpec("cam")`` splits them: ``lane_blocks``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from send_slam_tpu_torch.device import resolve_device


class Mesh:
    """An N-D array of devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} axes needs as many "
                             f"names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.flat)

    def lane_blocks(self, n_lanes: int) -> List[Tuple[torch.device, range]]:
        """(device, lanes) for each mesh entry: contiguous blocks of
        n_lanes / size lanes (the lane count must divide evenly, as a
        sharded axis must)."""
        if n_lanes % self.size:
            raise ValueError(f"{n_lanes} lanes do not split evenly over a "
                             f"mesh of {self.size} devices")
        per = n_lanes // self.size
        return [(dev, range(k * per, (k + 1) * per))
                for k, dev in enumerate(self.flat_devices())]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.flat_devices()})"


def make_mesh(n_devices: int | None = None,
              axis_names: Tuple[str, ...] = ("cam",),
              devices: Sequence | None = None) -> Mesh:
    """1-D (or reshaped N-D) mesh over the first n_devices devices.
    ``devices`` defaults to every CUDA card (raising without one); a
    test passes e.g. ``["cpu"] * 8``."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if not 1 <= n_devices <= len(devs):
        raise ValueError(f"a mesh of {n_devices} devices from {len(devs)}")
    devs = devs[:n_devices]
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    if len(axis_names) > 1:
        # Split devices as evenly as possible: the first axes get the
        # largest power-of-two factors.
        sizes = []
        rem = n_devices
        for i, _ in enumerate(axis_names[:-1]):
            f = 1
            while rem % 2 == 0 and f * 2 * (2 ** (len(axis_names) - i - 1)) <= rem:
                f *= 2
                rem //= 2
            sizes.append(f)
        sizes.append(rem)
        arr = arr.reshape(sizes)
    return Mesh(arr, tuple(axis_names))
