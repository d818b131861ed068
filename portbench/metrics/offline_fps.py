"""offline_fps: new sequence frames of every chunk the creator completed in
the window, over the window (its start, a chunk completion after warm-up, to
its last completion). All the work over all the time of the window."""

NAME = "offline_fps"
UNIT = "frames/s"


def read(run):
    w = run.window
    return sum(c["frames"] for c in w.chunks) / w.window_s
