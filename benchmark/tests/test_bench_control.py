"""``correct`` refuses the control and every fault the cells can have,
each planted in the program underneath a whole run (the look for a card
skipped, the rest of the run as the benchmark drives it)."""

import pytest
import torch

from bench_helpers import run_small, small_cell

import control

P = "send_slam_tpu_torch."


def _failing(res):
    return {k for k, c in res["checks"].items()
            if c["value"] is not None and c["value"] > c["limit"]}


def test_control_is_not_correct():
    cell = small_cell("tum_fr1.steady")
    with control.on(cell):
        res, _ = run_small(cell, seconds=30.0)
    assert not res["correct"]
    assert {"frontend_mismatch_pct", "ba_gap_px"} <= _failing(res)


def _homes():
    """Each check's fault, by the program's attributes it replaces."""
    from send_slam_tpu_torch.models import local_ba, local_mapping, tracking
    from send_slam_tpu_torch.ops import orb
    return {"frontend_mismatch_pct": {(orb, "build_pyramid"),
                                      (orb, "gaussian_blur")},
            "match_mismatch_pct": set(),
            "pose_gap_px": {(tracking, "pose_only_gn")},
            "ba_gap_px": {(local_ba, "_obs_terms")},
            "tri_gap_rel": {(local_mapping, "triangulate_batch")}}


@pytest.mark.parametrize("only", [None, "frontend_mismatch_pct",
                                  "match_mismatch_pct", "pose_gap_px",
                                  "ba_gap_px", "tri_gap_rel"])
def test_control_installs_the_cells_checks_controls_and_removes_them(only):
    """``control.on(cell)`` replaces exactly what the ``CONTROL`` of each
    of the cell's checks replaces, TF32 on, and puts all back on exit."""
    homes = _homes()
    cell = small_cell("tum_fr1.steady")
    if only is not None:
        cell.config["limits"] = {only: cell.config["limits"][only]}
    want = set().union(*(homes[k] for k in cell.config["limits"]))
    every = set().union(*homes.values())
    before = {k: getattr(*k) for k in every}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with control.on(cell):
        assert {k for k in every if getattr(*k) is not before[k]} == want
        assert torch.backends.cuda.matmul.allow_tf32
    assert all(getattr(*k) is before[k] for k in every)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_control_is_removed_when_the_body_raises():
    from send_slam_tpu_torch.models import tracking
    gn = tracking.pose_only_gn
    with pytest.raises(RuntimeError):
        with control.on(small_cell("tum_fr1.steady")):
            assert tracking.pose_only_gn is tracking.pose_only_gn_plain
            raise RuntimeError
    assert tracking.pose_only_gn is gn


def _stuck_pose(monkeypatch):
    """Tracking returns the pose it started from (its state unchanged)."""
    from send_slam_tpu_torch.models import tracking
    orig = tracking.pose_only_gn

    def stuck(R0, t0, *a, **kw):
        return orig(R0, t0, *a, **kw)._replace(R=R0, t=t0)
    monkeypatch.setattr(tracking, "pose_only_gn", stuck)


def _descriptor_bit(monkeypatch):
    """A descriptor bit flipped where the front end produces it."""
    from send_slam_tpu_torch.models import frame
    orig = frame.make_frames

    def flipped(*a, **kw):
        out = orig(*a, **kw)
        for i, f in enumerate(out):
            d = f.feat.desc.clone()
            d[:, 0] ^= 1
            out[i] = f._replace(feat=f.feat._replace(desc=d))
        return out
    monkeypatch.setattr(frame, "make_frames", flipped)


def _match_altered(monkeypatch):
    """The matcher's answer altered: every row's match one column off."""
    from send_slam_tpu_torch.models import tracking
    orig = tracking.match_descriptors

    def off(*a, **kw):
        row, col = orig(*a, **kw)
        idx = torch.where(row.valid, (row.idx + 1) % a[1].shape[0], row.idx)
        return row._replace(idx=idx), col
    monkeypatch.setattr(tracking, "match_descriptors", off)


def _ba_unchanged(monkeypatch):
    """Bundle adjustment returns the map it was given (its state
    unchanged), wherever the System or the map's bootstrap calls it."""
    from send_slam_tpu_torch.models import local_mapping, system

    def unchanged(m, *a, **kw):
        return m
    monkeypatch.setattr(system, "local_bundle_adjustment", unchanged)
    monkeypatch.setattr(local_mapping, "local_bundle_adjustment", unchanged)


def _landmark_altered(monkeypatch):
    """Each new landmark moved 1% along its ray from the first camera
    where the triangulation produces it."""
    from send_slam_tpu_torch.models import local_mapping
    orig = local_mapping.triangulate_batch

    def moved(P1, P2, x1, x2):
        X = orig(P1, P2, x1, x2)
        R, t = P1[:3, :3].inverse(), P1[:, 3]     # K [R | t] -> centre
        centre = -(R @ t).to(X.dtype)
        return centre + 1.01 * (X - centre)
    monkeypatch.setattr(local_mapping, "triangulate_batch", moved)


FAULTS = [(_stuck_pose, "pose_gap_px"),
          (_descriptor_bit, "frontend_mismatch_pct"),
          (_match_altered, "match_mismatch_pct"),
          (_ba_unchanged, "ba_gap_px"),
          (_landmark_altered, "tri_gap_rel")]


@pytest.mark.parametrize("plant,number", FAULTS,
                         ids=[f[0].__name__.strip("_") for f in FAULTS])
def test_fault_is_not_correct(monkeypatch, plant, number):
    plant(monkeypatch)
    res, _ = run_small(small_cell("tum_fr1.steady"), seconds=30.0)
    assert not res["correct"]
    if number != "pose_gap_px" or res["checks"][number]["value"] is not None:
        assert number in _failing(res)
