"""Camera frames handed to the engine in the traced run's window, over
the window's seconds on the host's clock (closed loop: the next frame
goes in when the call returns). The traced run's spans and profiler
window slow it; runs compare with runs of the same kind."""


def read(run):
    return run.frames() / run.window_s if run.window_s > 0 else None
