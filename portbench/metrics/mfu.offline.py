"""mfu.offline: the whole chunk step's share of the card's bf16 peak (989
TFLOP/s, the data sheet's dense rate): the configuration's FLOPs for each
chunk completed in the window (the Pi3 forward and MoGe-2 on the chunk's
first frame, counted from their shapes in ``roofline.py``, never from the
kernels that ran), over the window."""

from portbench.roofline import PEAK_BF16

NAME = "mfu.offline"
UNIT = "%"
LAYER = "chunk step and models"


def read(run):
    w = run.window
    return 100.0 * len(w.chunks) * run.flops_per_chunk / (w.window_s * PEAK_BF16)
