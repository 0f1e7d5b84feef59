"""Camera lanes over a device mesh: the multi-camera SLAM step and the
shared-map ring merge.

Counterpart of ``send_slam_tpu/parallel/``: N camera lanes each run the
full per-lane SLAM state machine (``multicam.py``), their maps merge in
a ring under a Sim(3) per pair (``map_merge.py``), and the mesh
(``mesh.py``) says which device runs which block of lanes.
"""

from send_slam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from send_slam_tpu_torch.parallel.multicam import (  # noqa: F401
    MultiCamState, init_multicam, multicam_slam_step,
    multicam_track_step,
)
