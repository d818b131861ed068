"""idle_share.offline: 1 - busy / window over the traced chunks, busy the
union of the device's kernel, memcpy and memset intervals and the window
every timed event of the trace (``trace.device_timeline``)."""

NAME = "idle_share.offline"
UNIT = "%"
LAYER = "device"


def read(run):
    if run.events is None or run.timeline["window_s"] <= 0:
        return None
    return 100.0 * run.timeline["idle_share"]
