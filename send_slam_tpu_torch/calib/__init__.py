"""Camera calibration: checkerboard detection and Zhang intrinsics on the
device, and the reference's priv/calibration/latest.json persistence.
The port's counterpart of ``send_slam_tpu/calib/``, exporting the same
names."""

from send_slam_tpu_torch.calib.io import (  # noqa: F401
    calibration_to_json, calibration_from_json, default_output_path,
    load_from_file, save_to_file,
)
from send_slam_tpu_torch.calib.checkerboard import (  # noqa: F401
    detect_checkerboard, corner_response_map,
)
from send_slam_tpu_torch.calib.zhang import calibrate_camera  # noqa: F401
