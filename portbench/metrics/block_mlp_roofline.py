"""block_mlp_roofline: the block MLP's least time over its device time, in
the traced chunks. The work is the configuration's: every transformer block
of Pi3 (encoder, decoder, head decoders) runs LayerNorm, fc1, GELU, fc2,
LayerScale and the residual on all of the chunk's tokens in its compute
dtype, bounded by ``roofline.bound_ms``. The device time is that of every
kernel listed under ``kernels/block_mlp/``. None where no listed kernel ran."""

from portbench.roofline import bound_ms, mlp_work

NAME = "block_mlp_roofline"
UNIT = "%"
LAYER = "kernels"


def read(run):
    if run.events is None:
        return None
    seconds, launches = run.kernel_seconds("block_mlp")
    if launches == 0:
        return None
    model = run.config["model"]
    enc = model["encoder"]
    p = model["patch_size"]
    n = run.traffic["chunk_length"]
    hw = (run.hw[0] // p) * (run.hw[1] // p)
    least = 0.0
    for blocks, tokens, c, ratio in (
            (enc["depth"], hw + 1 + enc["num_register_tokens"], enc["embed_dim"],
             enc["mlp_ratio"]),
            (model["dec_depth"], hw + model["num_register_tokens"], model["dec_embed_dim"],
             model["mlp_ratio"]),
            (3 * model["head_depth"], hw + model["num_register_tokens"], model["head_dim"],
             model["mlp_ratio"])):
        flops, nbytes = mlp_work(n * tokens, c, c * ratio, 2)
        least += blocks * bound_ms(flops, nbytes) / 1e3
    return 100.0 * run.traced_chunks * least / seconds
