"""ms in the front end (make_frame / make_frames, synchronised spans) per
camera frame of the span phase."""

SPANS = ("frontend",)


def read(run):
    ms = run.span_ms("frontend")
    return sum(ms) / run.span_frames if ms and run.span_frames else None
