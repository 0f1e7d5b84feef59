"""ms in track_frame (synchronised spans, the init backfill's calls
included) per camera frame of the span phase."""

SPANS = ("tracking",)


def read(run):
    ms = run.span_ms("tracking")
    return sum(ms) / run.span_frames if ms and run.span_frames else None
