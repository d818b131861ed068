"""global_attn_roofline: the exact global attention's least time over its
device time, in the traced chunks. The work is the configuration's: each of
the decoder's global blocks attends the chunk's frames x tokens queries to
as many keys at its heads and head dim (bf16), bounded by
``roofline.bound_ms``. The device time is that of every kernel listed under
``kernels/global_attn/``. None where the configuration merges the global
keys or no listed kernel ran."""

from portbench.roofline import attention_work, bound_ms

NAME = "global_attn_roofline"
UNIT = "%"
LAYER = "kernels"


def read(run):
    model = run.config["model"]
    n = run.traffic["chunk_length"]
    merge = model.get("global_kv_merge", 1)
    if run.events is None or (merge > 1 and n % merge == 0):
        return None
    seconds, launches = run.kernel_seconds("global_attn")
    if launches == 0:
        return None
    p = model["patch_size"]
    t = n * ((run.hw[0] // p) * (run.hw[1] // p) + model["num_register_tokens"])
    h = model["dec_num_heads"]
    flops, nbytes = attention_work(1, t, t, h, model["dec_embed_dim"] // h, 2)
    least = run.traced_chunks * model["dec_depth"] // 2 * bound_ms(flops, nbytes) / 1e3
    return 100.0 * least / seconds
