"""outside_step_share.offline: the share of the window that no chunk's
``infer_s`` span covers. The creator's span runs from a chunk's dispatch
(upload, the step and MoGe-2 enqueued) to its outputs' host copy; outside it
lie the wait for the loader's next chunk, the storage dict, the npz write and
the Python between them."""

NAME = "outside_step_share.offline"
UNIT = "%"
LAYER = "creator and loader (host)"


def read(run):
    w = run.window
    covered = 0.0
    for c in w.chunks:
        start = max(c["t0"], w.t_open)
        stop = min(c["t0"] + c["infer_s"], w.t_close)
        covered += max(0.0, stop - start)
    return 100.0 * (1.0 - covered / w.window_s)
