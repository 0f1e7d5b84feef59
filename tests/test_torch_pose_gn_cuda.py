"""The CUDA pose Gauss-Newton (ops/pose_gn_cuda.py, csrc/pose_gn_kernel.cu)
against ``pose_only_gn``'s plain version (models/tracking.py).

Cases marked ``cuda`` skip without a card; on the GPU machine:
``python -m pytest -q --noconftest -m cuda tests/test_torch_pose_gn_cuda.py``.
The others run on the CPU: the seeded inputs stay clear of the chi2
threshold at every reclassification, CPU tensors take the plain path bit
for bit and never the kernel, the module imports and refuses CPU tensors
without nvcc, and a transcription of the kernel's formulation (float32 per
point and per thread, float64 block sums, solve and pose) holds against
the plain version."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from send_slam_tpu_torch.geometry.se3 import se3_compose, se3_exp
from send_slam_tpu_torch.models.tracking import (
    CHI2_2DOF, PoseOptResult, _project_and_jacobian, pose_only_gn,
    pose_only_gn_plain,
)
from send_slam_tpu_torch.ops import pose_gn_cuda
from send_slam_tpu_torch.utils import profiling
from send_slam_tpu_torch.utils.synth import pose_problem

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

# name: (N, rounds, iters, pose_problem options). The main path's two
# calls a frame at 1,000 (TUM1.yaml) and 1,250 (the flagship) keypoints;
# relocalization's over the whole landmark table, sigma2 None.
CASES = {
    "main_1000_2x5": (1000, 2, 5, {}),
    "main_1000_4x5": (1000, 4, 5, {}),
    "main_1250_2x5": (1250, 2, 5, {}),
    "main_1250_4x5": (1250, 4, 5, {}),
    "reloc_16384_4x10": (16384, 4, 10, dict(valid_frac=0.08,
                                            with_sigma2=False)),
    "empty": (0, 4, 5, {}),
    "no_valid_weight": (800, 4, 5, dict(valid_frac=0.0)),
    "behind_camera": (1000, 4, 5, dict(behind_frac=0.2)),
    "start_180deg": (600, 4, 5, dict(flip=True)),
}
# Cases whose result has inliers to measure a reprojection gap over.
FITTED = ["main_1000_2x5", "main_1000_4x5", "main_1250_2x5",
          "main_1250_4x5", "reloc_16384_4x10", "behind_camera"]
TOL_POSE = 1e-5       # R and t, kernel against the plain version
GAP_MAX_PX = 1e-4     # pixel gap to the float64 evaluation


def inputs(name, dev="cpu"):
    """(args, kwargs) of pose_only_gn for a case, on ``dev``."""
    n, rounds, iters, opts = CASES[name]
    pr = pose_problem(n, seed=1600 + n, **opts)
    args = [torch.from_numpy(pr[k]).to(dev)
            for k in ("R0", "t0", "X", "uv_obs", "w_valid")]
    s2 = pr["sigma2"]
    kw = dict(sigma2=None if s2 is None else torch.from_numpy(s2).to(dev),
              rounds=rounds, iters=iters, huber_delta=2.447)
    return args + [pr["fx"], pr["fy"], pr["cx"], pr["cy"]], kw


def to(args, kw, dev=None, dtype=None):
    def mv(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(dev) if dev is not None else x
        return x.to(dtype) if dtype is not None and x.is_floating_point() \
            else x
    return [mv(a) for a in args], {k: mv(v) for k, v in kw.items()}


def chi2_of(R, t, X, uv_obs, fx, fy, cx, cy, sigma2):
    uv, p, _ = _project_and_jacobian(R, t, X, fx, fy, cx, cy)
    chi2 = ((uv - uv_obs) ** 2).sum(-1)
    return (chi2 if sigma2 is None else chi2 / sigma2), p[:, 2]


def gap_px(R, t, R_ref, t_ref, X, mask, fx, fy, cx, cy):
    """RMS pixel distance in float64 between the projections of X[mask]
    under two poses (None for an empty mask)."""
    if not bool(mask.any()):
        return None
    X = X[mask].double()
    ua, _, _ = _project_and_jacobian(R.double(), t.double(), X, fx, fy, cx, cy)
    ub, _, _ = _project_and_jacobian(R_ref.double(), t_ref.double(), X, fx,
                                     fy, cx, cy)
    return float(((ua - ub) ** 2).sum(-1).mean().sqrt())


def assert_matches_plain(got, ref, what):
    """R and t within TOL_POSE, the same inliers and count, chi2 close."""
    got = PoseOptResult(*(x.cpu() for x in got))
    assert (got.R - ref.R).abs().max() <= TOL_POSE, what
    assert (got.t - ref.t).abs().max() <= TOL_POSE, what
    assert torch.equal(got.inlier, ref.inlier), what
    assert int(got.n_inliers) == int(ref.n_inliers), what
    assert got.n_inliers.dtype == torch.int32 and got.chi2.dtype == \
        torch.float32, what
    assert abs(float(got.chi2) - float(ref.chi2)) <= \
        1e-4 * max(1.0, abs(float(ref.chi2))), what


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("name", list(CASES))
def test_inputs_clear_of_chi2_threshold(name):
    """At the pose each round's reclassification sees (the plain
    version's), no valid point's chi2 lies within 1e-3 of 5.991, so a
    sound kernel must give the same inlier sets."""
    args, kw = inputs(name)
    R0, t0, X, uv, valid, fx, fy, cx, cy = args
    for k in range(1, kw["rounds"] + 1):
        o = pose_only_gn_plain(*args, **{**kw, "rounds": k})
        chi2, _ = chi2_of(o.R, o.t, X, uv, fx, fy, cx, cy, kw["sigma2"])
        if bool(valid.any()):
            margin = float((chi2[valid] - CHI2_2DOF).abs().min())
            assert margin > 1e-3, (name, k, margin)


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_takes_the_plain_path_bit_for_bit(name):
    """CPU tensors: pose_only_gn is the plain version bit for bit, with
    no launch and no kernel.pose_gn count, tracing on."""
    args, kw = inputs(name)
    n0 = pose_gn_cuda.LIBRARY.launches
    profiling.drain()
    profiling.set_tracing(True)
    try:
        got = pose_only_gn(*args, **kw)
    finally:
        profiling.set_tracing(False)
    counts = profiling.drain().counts
    ref = pose_only_gn_plain(*args, **kw)
    assert isinstance(got, PoseOptResult)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert pose_gn_cuda.LIBRARY.launches == n0
    assert "kernel.pose_gn" not in counts


def kernel_transcription(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy,
                         sigma2=None, rounds=4, iters=10, huber_delta=2.447):
    """csrc/pose_gn_kernel.cu's formulation in PyTorch on the CPU: each
    point in float32 as the kernel writes it (its Jacobian entries
    included), each of 256 threads' partial sums in float32 over the
    points it owns (k, k + 256, ...), the block's sums, the solve, the
    pose and se3_exp in float64, the pose rounded to float32 for each
    pass."""
    n = X.shape[0]
    is2 = torch.ones(n) if sigma2 is None else 1.0 / sigma2
    R, t = R0.double(), t0.double()
    inl = w_valid.clone()
    iu = torch.triu_indices(6, 6)

    def per_point():
        Rf, tf = R.float(), t.float()
        px, py, pz = (X @ Rf.T + tf).unbind(-1)
        iz = 1.0 / torch.clamp(pz, min=1e-6)
        r0 = fx * px * iz + cx - uv_obs[:, 0]
        r1 = fy * py * iz + cy - uv_obs[:, 1]
        return px, py, pz, iz, r0, r1, (r0 * r0 + r1 * r1) * is2

    def block_sums(vals):
        v = torch.cat([vals, vals.new_zeros((-n) % 256, vals.shape[1])])
        return v.reshape(-1, 256, vals.shape[1]).sum(0).double().sum(0)

    for _ in range(rounds):
        for _ in range(iters):
            px, py, pz, iz, r0, r1, chi2 = per_point()
            nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w = torch.clamp(huber_delta * (1.0 / nrm), max=1.0) * is2
            w = torch.where(inl & (pz > 1e-3), w, torch.zeros_like(w))
            a0, c0 = fx * iz, -fx * px * iz * iz
            b1, d1 = fy * iz, -fy * py * iz * iz
            z = torch.zeros_like(a0)
            J0 = torch.stack([a0, z, c0, c0 * py, a0 * pz - c0 * px,
                              -a0 * py], -1)
            J1 = torch.stack([z, b1, d1, d1 * py - b1 * pz, -d1 * px,
                              b1 * px], -1)
            w0, w1 = w[:, None] * J0, w[:, None] * J1
            s = block_sums(torch.cat([
                w0[:, iu[0]] * J0[:, iu[1]] + w1[:, iu[0]] * J1[:, iu[1]],
                w0 * r0[:, None] + w1 * r1[:, None]], 1))
            H = torch.zeros(6, 6, dtype=torch.float64)
            H[iu[0], iu[1]] = s[:21]
            H[iu[1], iu[0]] = s[:21]
            H += float(np.float32(1e-6)) * torch.eye(6, dtype=torch.float64)
            dR, dt = se3_exp(-torch.linalg.solve(H, s[21:]))
            R, t = se3_compose(dR, dt, R, t)
        _, _, pz, _, _, _, chi2 = per_point()
        inl = w_valid & (chi2 < CHI2_2DOF) & (pz > 1e-3)
    _, _, _, _, _, _, chi2 = per_point()
    chi2_sum = torch.where(inl, torch.clamp(chi2, max=CHI2_2DOF),
                           torch.zeros_like(chi2)).double().sum()
    return PoseOptResult(R=R.float(), t=t.float(), inlier=inl,
                         chi2=chi2_sum.float(),
                         n_inliers=inl.sum(dtype=torch.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_formulation_matches_plain(name):
    """The kernel's arithmetic, transcribed, against the plain version:
    R, t within 1e-5, the same inliers, count and clamped chi2 sum."""
    args, kw = inputs(name)
    assert_matches_plain(kernel_transcription(*args, **kw),
                         pose_only_gn_plain(*args, **kw), name)


def test_module_imports_without_nvcc():
    """Importing the wrapper and tracking builds and loads nothing, with
    no nvcc on the PATH."""
    code = ("from send_slam_tpu_torch.models import tracking\n"
            "from send_slam_tpu_torch.ops import pose_gn_cuda as m\n"
            "assert m.LIBRARY._lib is None and m.LIBRARY.launches == 0\n"
            "print(m.LIBRARY.path().name)\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(os.sep, "nonexistent"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("pose_gn_kernel_")


def test_wrapper_refuses_cpu_tensors():
    args, kw = inputs("main_1000_2x5")
    n0 = pose_gn_cuda.LIBRARY.launches
    with pytest.raises(ValueError):
        pose_gn_cuda.pose_gn_cuda(*args, **kw)
    assert pose_gn_cuda.LIBRARY.launches == n0


class _OnCard:
    """Stands in for a CUDA tensor of ``shape``."""
    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape

    def dim(self):
        return len(self.shape)


# kernel: (args and kwargs of a dispatcher call on the card, the key
# chip_smoke.py counts it under, args of a call on the CPU)
SMOKE_CALLS = {
    "fast": (([_OnCard(2, 48, 64)] * 8, 7.0), dict(with_nms=True), "2x8",
             ([torch.zeros(8, 8)], 7.0)),
    "pose_gn": ((None, None, _OnCard(16384, 3)), dict(rounds=2, iters=5),
                "16384x2x5", inputs("main_1000_2x5")[0]),
    "segsum": ((_OnCard(40, 18), None), {}, None, (torch.zeros(4, 2), None)),
}


@pytest.mark.parametrize("kernel", list(SMOKE_CALLS))
def test_smoke_counts_card_calls_through_both_names(kernel, monkeypatch):
    """chip_smoke.py's engagement count (kernels_engaged): a kernel's
    dispatcher calls on the card through every name its callers bind, by
    key, against the kernel's launches; CPU calls are not counted, the
    names come back, and a count with no launch behind it fails the
    smoke."""
    import chip_smoke
    names = []
    for where in chip_smoke.KERNELS[kernel].dispatchers:
        mod, attr = where.split(":")
        m = importlib.import_module("send_slam_tpu_torch." + mod)
        monkeypatch.setattr(m, attr, lambda *a, **k: None)
        names.append((m, attr, getattr(m, attr)))
    card_args, card_kw, key, cpu_args = SMOKE_CALLS[kernel]
    with chip_smoke.kernels_engaged() as eng:
        for m, attr, _ in names:
            getattr(m, attr)(*card_args, **card_kw)
            getattr(m, attr)(*cpu_args)
    assert all(getattr(m, attr) is stub for m, attr, stub in names)
    n = len(names)
    assert n == 2
    assert eng[kernel] == dict(calls=n, launches=0,
                               shapes={key: n} if key else {})
    assert all(rec["calls"] == 0 for k, rec in eng.items() if k != kernel)
    with pytest.raises(SystemExit):
        chip_smoke.check_engaged("test", eng, reached=())
    chip_smoke.check_engaged("test", {kernel: dict(eng[kernel], launches=n)},
                             reached=(kernel,))


# --------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_against_plain(dev, name):
    """One launch against the plain version on the CPU: R, t within
    1e-5, equal inlier sets and n_inliers, chi2 close."""
    args, kw = inputs(name)
    ref = pose_only_gn_plain(*args, **kw)
    cargs, ckw = to(args, kw, dev)
    n0 = pose_gn_cuda.LIBRARY.launches
    got = pose_only_gn(*cargs, **ckw)
    torch.cuda.synchronize()
    assert pose_gn_cuda.LIBRARY.launches == n0 + 1
    assert all(x.device.type == "cuda" for x in got)
    assert_matches_plain(got, ref, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_replay_is_bit_equal(dev, name):
    cargs, ckw = to(*inputs(name), dev)
    a = [x.clone() for x in pose_only_gn(*cargs, **ckw)]
    b = pose_only_gn(*cargs, **ckw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FITTED)
def test_nearer_float64_than_plain(dev, name):
    """The pixel gap to a float64 evaluation of the plain version is at
    most 1e-4 px, and at most twice the plain float32 version's plus
    1e-6 px (both are rounding; the kernel's float64 sums and pose make
    it the nearer as a rule)."""
    args, kw = inputs(name)
    X, fx, fy, cx, cy = args[2], *args[5:]
    a64, k64 = to(args, kw, dtype=torch.float64)
    ref64 = pose_only_gn_plain(*a64, **k64)
    plain = pose_only_gn_plain(*args, **kw)
    cargs, ckw = to(args, kw, dev)
    got = PoseOptResult(*(x.cpu() for x in pose_only_gn(*cargs, **ckw)))
    mask = ref64.inlier | got.inlier
    g_kernel = gap_px(got.R, got.t, ref64.R, ref64.t, X, mask, fx, fy, cx, cy)
    g_plain = gap_px(plain.R, plain.t, ref64.R, ref64.t, X,
                     ref64.inlier | plain.inlier, fx, fy, cx, cy)
    assert g_kernel <= GAP_MAX_PX, (name, g_kernel)
    assert g_kernel <= 2.0 * g_plain + 1e-6, (name, g_kernel, g_plain)


@pytest.mark.cuda
def test_wrapper_raises_on_what_it_does_not_take(dev):
    args, kw = inputs("main_1000_2x5")
    cargs, ckw = to(args, kw, dev)
    X, uv = cargs[2], cargs[3]
    strided = torch.empty(uv.shape[0], 4, device=dev)[:, :2]
    strided.copy_(uv)
    bad = [
        (2, X.double(), TypeError),
        (3, strided, ValueError),
        (3, uv.cpu(), ValueError),
        (0, cargs[0].cpu(), ValueError),
        (4, cargs[4].to(torch.uint8), TypeError),
    ]
    n0 = pose_gn_cuda.LIBRARY.launches
    for pos, val, exc in bad:
        a = list(cargs)
        a[pos] = val
        with pytest.raises(exc):
            pose_gn_cuda.pose_gn_cuda(*a, **ckw)
    with pytest.raises(TypeError):
        pose_gn_cuda.pose_gn_cuda(*cargs, **{**ckw,
                                             "sigma2": ckw["sigma2"].double()})
    with pytest.raises(ValueError):
        pose_gn_cuda.pose_gn_cuda(*cargs[:5], torch.tensor(500.0), *cargs[6:],
                                  **ckw)
    assert pose_gn_cuda.LIBRARY.launches == n0


@pytest.mark.cuda
def test_intrinsics_on_the_device(dev):
    """0-dim device intrinsics (relocalization's K entries) give the
    same bits as the same values by number."""
    cargs, ckw = to(*inputs("main_1000_4x5"), dev)
    K = torch.tensor(cargs[5:9], dtype=torch.float32, device=dev)
    a = pose_only_gn(*cargs, **ckw)
    b = pose_only_gn(*cargs[:5], K[0], K[1], K[2], K[3], **ckw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_launches_and_counter_one_per_call(dev):
    cargs, ckw = to(*inputs("main_1250_4x5"), dev)
    n0 = pose_gn_cuda.LIBRARY.launches
    profiling.drain()
    profiling.set_tracing(True)
    try:
        for _ in range(3):
            pose_only_gn(*cargs, **ckw)
    finally:
        profiling.set_tracing(False)
    assert pose_gn_cuda.LIBRARY.launches == n0 + 3
    assert profiling.drain().counts.get("kernel.pose_gn") == 3
