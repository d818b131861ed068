"""aggregator_attn_roofline.vggt: the exact global attention of VGGT's
aggregator, its least time over its device time, in the traced chunks. The
work is the configuration's: each of the aggregator's global blocks attends
the chunk's frames x (patches + camera + register tokens) queries to as many
keys at its heads and head dim (bf16), bounded by ``roofline.bound_ms``. The
device time is that of the kernels listed under ``kernels/global_attn/``
launched inside the program's ``vggt.aggregator`` span (``launched.py``),
which keeps the camera head's attention out. None outside the VGGT family,
without a trace, or where no such kernel ran inside the span."""

from portbench import manifest
from portbench.launched import kernel_seconds_in_spans
from portbench.roofline import attention_work, bound_ms

NAME = "aggregator_attn_roofline.vggt"
UNIT = "%"
LAYER = "kernels"


def read(run):
    if run.events is None or run.config.get("family") != "vggt":
        return None
    got = kernel_seconds_in_spans(run.events, ("vggt.aggregator",),
                                  manifest.kernel_specs("global_attn"))
    if got is None or got[1] == 0:
        return None
    model = run.config["model"]
    p = model["patch_size"]
    t = run.traffic["chunk_length"] * ((run.hw[0] // p) * (run.hw[1] // p) + 1
                                       + model["num_register_tokens"])
    h = model["num_heads"]
    flops, nbytes = attention_work(1, t, t, h, model["embed_dim"] // h, 2)
    least = run.traced_chunks * model["depth"] * bound_ms(flops, nbytes) / 1e3
    return 100.0 * least / got[0]
