"""Device compute ops: pyramid, FAST, ORB, Hamming matching; the JAX
package's ``send_slam_tpu.ops`` exports under the same names. The CUDA
kernels are ``ops/fast_cuda.py`` (FAST), ``ops/pose_gn_cuda.py`` (the
pose Gauss-Newton) and ``ops/segsum_cuda.py`` (the segment sum), each
built when first called and launched through ``ops/cuda_build.py``."""

from send_slam_tpu_torch.ops.pyramid import build_pyramid, gaussian_blur  # noqa: F401
from send_slam_tpu_torch.ops.fast import fast_score_map  # noqa: F401
from send_slam_tpu_torch.ops.orb import extract_orb, FrameFeatures  # noqa: F401
from send_slam_tpu_torch.ops.hamming import (  # noqa: F401
    hamming_matrix, pack_bits_to_u32, unpack_u32_to_bits, match_descriptors,
)
