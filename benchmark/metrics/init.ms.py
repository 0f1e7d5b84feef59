"""ms in the init (two-view init, the map's bootstrap, the backfill;
synchronised spans) until the first pose reached the host."""

SPANS = ("init",)


def read(run):
    end = run.first_pose_s
    ms = [(e - s) * 1e3 for n, _, s, e in run.spans
          if n == "init" and (end is None or s < end)]
    return sum(ms) if ms else None
