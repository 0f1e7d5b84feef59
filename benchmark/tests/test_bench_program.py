"""The program's ``slam.*`` ranges in a profiler window: idle gaps put
down to the innermost range over their midpoint, on synthetic event
lists in the form ``harness/trace.py`` reads them."""

import pytest

import bench_helpers  # noqa: F401  (the import paths)
from harness import program

MS = 1_000_000


def _kernels(*spans_ms):
    return [(f"k{i}", True, s * MS, e * MS)
            for i, (s, e) in enumerate(spans_ms)]


# Kernels at 0-1, 3-4, 6-7, 10-11, 20-21, 23-24, 30-31 ms: gaps with
# midpoints at 2, 5, 8.5, 15.5, 22 and 27.5 ms.
KERNELS = _kernels((0, 1), (3, 4), (6, 7), (10, 11), (20, 21), (23, 24),
                   (30, 31))
RANGES = [
    # frame 0: 0-12 ms; tracking 1.5-5.5 inside it; mapping 8-9.
    ("slam.frame", False, 0, 12 * MS),
    ("slam.tracking", False, int(1.5 * MS), int(5.5 * MS)),
    ("slam.mapping", False, 8 * MS, 9 * MS),
    # frame 1: 18-29 ms; front end 21.5-22.5, lagged 25-29 with a loop
    # check 27-28.
    ("slam.frame", False, 18 * MS, 29 * MS),
    ("slam.frontend", False, int(21.5 * MS), int(22.5 * MS)),
    ("slam.lagged", False, 25 * MS, 29 * MS),
    ("slam.loop", False, 27 * MS, 28 * MS),
]


def test_innermost_range_over_the_midpoint():
    spans = program.ranges(RANGES + KERNELS)
    mids = [2 * MS, 5 * MS, int(8.5 * MS), int(15.5 * MS), 22 * MS,
            int(27.5 * MS)]
    assert program.innermost(mids, spans) == [
        "slam.tracking", "slam.tracking", "slam.mapping", None,
        "slam.frontend", "slam.loop"]
    # A range that starts with its parent nests inside it.
    same = program.ranges([("slam.tracking", False, 0, 2),
                           ("slam.frame", False, 0, 10)])
    assert program.innermost([1, 5], same) == ["slam.tracking", "slam.frame"]


def test_each_gap_goes_to_its_innermost_range():
    idle = program.attribute(RANGES + KERNELS)
    assert idle["slam.tracking"] == pytest.approx(4e-3)    # 1-3, 4-6
    assert idle["slam.mapping"] == pytest.approx(3e-3)     # 7-10
    assert idle["slam.frontend"] == pytest.approx(2e-3)    # 21-23
    assert idle["slam.loop"] == pytest.approx(6e-3)        # 24-30
    assert sum(idle.values()) == pytest.approx(24e-3)


def test_a_gap_under_no_range_is_untraced():
    idle = program.attribute(RANGES + KERNELS)
    assert idle[program.UNTRACED] == pytest.approx(9e-3)   # 11-20


def test_a_frame_with_no_child_keeps_its_gaps():
    events = [("slam.frame", False, 0, 10 * MS)] + _kernels((0, 1), (4, 5))
    assert program.attribute(events) == pytest.approx(
        {"slam.frame": 3e-3, program.UNTRACED: 0.0})


def test_device_copies_of_ranges_are_no_device_work():
    """The profiler may mirror a range on the device's timeline (its
    annotation of the kernels under it): it closes no gap."""
    events = RANGES + KERNELS + [("slam.frame", True, 0, 12 * MS)]
    assert program.attribute(events) == program.attribute(RANGES + KERNELS)


@pytest.mark.parametrize("events", [[], KERNELS,
                                    KERNELS + [("aten::mm", False, 0, MS)]],
                         ids=["empty", "kernels", "untraced-host"])
def test_no_range_attributes_nothing(events):
    """A window in which the program recorded no range (no tracer, or its
    tracing off): no attribution."""
    assert program.attribute(events) is None
