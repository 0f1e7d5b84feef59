"""Geometry core on torch tensors: SO(3)/SE(3)/Sim(3), cameras,
triangulation and two-view estimators; the JAX package's
``send_slam_tpu.geometry`` exports under the same names."""

from send_slam_tpu_torch.geometry.se3 import (  # noqa: F401
    hat, vee, so3_exp, so3_log,
    se3_exp, se3_log, se3_inverse, se3_compose, se3_apply,
    se3_identity, quat_from_rotmat, rotmat_from_quat, quat_normalize,
)
from send_slam_tpu_torch.geometry.sim3 import (  # noqa: F401
    sim3_exp, sim3_log, sim3_inverse, sim3_compose, sim3_apply,
)
from send_slam_tpu_torch.geometry.camera import (  # noqa: F401
    project, unproject, distort_radtan, undistort_points, intrinsics_matrix,
)
from send_slam_tpu_torch.geometry.triangulate import (  # noqa: F401
    triangulate_dlt, triangulate_batch,
)
from send_slam_tpu_torch.geometry.epipolar import (  # noqa: F401
    eight_point_fundamental, homography_dlt, sampson_error, homography_error,
)
