"""ms in keyframe insertion with triangulation and local bundle
adjustment (synchronised spans, summed) per keyframe inserted in the span
phase."""

SPANS = ("mapping",)


def read(run):
    n = len(run.span_ms("mapping", "insert_keyframe_with_triangulation"))
    return sum(run.span_ms("mapping")) / n if n else None
