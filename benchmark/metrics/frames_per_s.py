"""Frames handed to the engine in the window, over the window's seconds
(closed loop: the next frame goes in when the call returns)."""


def read(run):
    return run.frames() / run.window_s if run.window_s > 0 else None
