"""dpt_roofline.vggt: VGGT's two DPT heads' least time over their device
time, in the traced chunks. The work is the configuration's, counted from
its shapes (``families/vggt.dpt_work``): the depth and point heads' FLOPs in
fp32 and their bytes (inputs and weights read once, outputs written once),
bounded by max(FLOPs / 165 TFLOP/s, bytes / 3.35 TB/s), 165 TFLOP/s being
the port's rate for fp32-accurate products (3xTF32). The device time is that
of every kernel launched inside the program's ``vggt.depth_head`` and
``vggt.point_head`` spans (``launched.py``). None outside the VGGT family,
without a trace, or where the program recorded no such span."""

from portbench import manifest
from portbench.launched import kernel_seconds_in_spans
from portbench.roofline import PEAK_BYTES

NAME = "dpt_roofline.vggt"
UNIT = "%"
LAYER = "kernels"


def read(run):
    if run.events is None or run.config.get("family") != "vggt":
        return None
    got = kernel_seconds_in_spans(run.events, ("vggt.depth_head", "vggt.point_head"))
    if got is None or got[1] == 0:
        return None
    family = manifest.family("vggt")
    flops, nbytes = family.dpt_work(run.config, run.traffic, *run.hw)
    least = max(flops / family.PEAK_FP32_ACCURATE, nbytes / PEAK_BYTES)
    return 100.0 * run.traced_chunks * least / got[0]
