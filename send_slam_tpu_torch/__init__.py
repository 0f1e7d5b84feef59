"""send_slam_tpu_torch: the monocular SLAM engine in PyTorch for CUDA.

A port of ``send_slam_tpu`` (JAX/Pallas for TPU) to PyTorch with
hand-written CUDA kernels for Hopper (sm_90a). The JAX package stays the
reference: every module here names its counterpart, keeps its layouts at
the public functions, and is held against it by ``tests/test_torch_*.py``.
This package imports neither JAX nor the JAX package.

Layout: ``geometry/`` (SE3, cameras, triangulation, epipolar),
``ops/`` (pyramid, FAST with its CUDA kernel in ``csrc/``, ORB, Hamming
matching, segment sums), ``models/`` (frame, map, tracking, init,
local BA, local mapping, covisibility, the System facade), ``utils/``
and ``io/`` (synthetic scenes, trajectory evaluation). Entry points
default to ``device="cuda"``; see ``device.py``.
"""

__version__ = "0.1.0"
