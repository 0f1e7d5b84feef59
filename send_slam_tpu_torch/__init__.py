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
(synthetic scenes, stage timing), ``io/`` (trajectory evaluation, map
checkpoints, the wire protocol with its own MessagePack codec, PPM and
the native host-I/O library), ``calib/io.py`` and ``server/`` (the
drop-in backend, the engine worker, the TCP listener, the web panel on
its own HTTP/WebSocket server, the application). Entry points default
to ``device="cuda"``; see ``device.py``.
"""

__version__ = "0.1.0"
