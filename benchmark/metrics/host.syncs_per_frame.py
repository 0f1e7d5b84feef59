"""Host waits on the device in the profiler window, per camera frame:
cudaStreamSynchronize, cudaDeviceSynchronize and cudaEventSynchronize
calls, plus device-to-host copies (host-to-device copies left out)."""


def read(run):
    t = run.trace
    if not t or not t["frames"]:
        return None
    return (t["sync_calls"] + t["d2h_copies"]) / t["frames"]
