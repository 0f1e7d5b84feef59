"""The card's busy time per camera frame over the whole window: the union
of the intervals in which a kernel, copy or fill ran on the device, in
ms, over the camera frames handed over (``harness/devclock.py``). None
where CUPTI dropped a record or a buffer could not be had."""


def read(run):
    d = run.device
    if not d or d["dropped"] or d["failed"] or not d["events"] \
            or not run.frames():
        return None
    return 1e3 * d["busy_s"] / run.frames()
