"""Seconds of set-up: the process's start, torch, the CUDA context, the
engine built and warmed up (the FAST library built on a checkout's first
run), the traffic's rendering left out."""


def read(run):
    return run.setup_s
