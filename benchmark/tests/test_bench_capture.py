"""The comparison's sample, built from the check files: the same stages,
sites, sizes and seeded draws as when the five stages were written into
``harness/capture.py``."""

import pytest

from bench_helpers import small_cell
from harness import capture

P = "send_slam_tpu_torch.models."
# The stages as ``capture.stash`` listed them before the checks were
# files of their own: (sample size, sites).
STAGES = {
    "frontend": (3, [(P + "frame", "make_frames")]),
    "match": (4, [(P + "tracking", "match_descriptors")]),
    "gn": (32, [(P + "tracking", "pose_only_gn")]),
    "ba": (8, [(P + "system", "local_bundle_adjustment"),
               (P + "local_mapping", "local_bundle_adjustment")]),
    "tri": (8, [(P + "local_mapping", "create_new_landmarks")]),
}
# What that sampler kept, seed 3000000000, of calls 0-199 at each stage.
DRAWN = {
    "frontend": [12, 65, 102],
    "match": [27, 84, 87, 100],
    "gn": [7, 9, 21, 25, 33, 37, 43, 57, 64, 67, 72, 73, 75, 77, 81, 94,
           100, 101, 108, 110, 114, 120, 124, 125, 140, 143, 157, 166, 178,
           190, 193, 198],
    "ba": [16, 28, 50, 85, 129, 149, 162, 168],
    "tri": [2, 13, 17, 22, 55, 99, 119, 130],
}


def _stash(seed=3000000000):
    cell = small_cell("tum_fr1.steady")
    return capture.stash(seed, cell.checks(), cell.driver().SITES)


def test_the_stages_are_those_of_before():
    st = _stash()
    assert {k: (size, sites) for k, (size, sites, _) in st.targets.items()} \
        == STAGES


def test_a_seed_draws_the_calls_it_drew_before():
    st = _stash()
    for key, res in st.samples.items():
        for i in range(200):
            res.offer(i)
        assert sorted(res.items) == DRAWN[key], key


class _Check:
    def __init__(self, stage, sample, sites):
        self.STAGE, self.SAMPLE, self.SITES = stage, sample, sites
        self.keep = capture.keep_call


def test_driver_sites_join_a_stage_and_checks_share_it():
    a = _Check("s", 2, [("m", "f")])
    b = _Check("s", 2, [("m", "f")])
    st = capture.stash(1, dict(a=a, b=b), {"s": [("lane", "f")],
                                           "unused": [("x", "y")]})
    assert list(st.targets) == ["s"]
    assert st.targets["s"][:2] == (2, [("m", "f"), ("lane", "f")])
    with pytest.raises(ValueError):
        capture.stash(1, dict(a=a, c=_Check("s", 3, [("m", "f")])))
