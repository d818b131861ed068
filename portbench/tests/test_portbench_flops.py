"""The frozen work counts against hand counts at Pi3's published widths."""

import pytest

from portbench import manifest, roofline

PI3 = manifest.config("pi3-moge2")


def _hand_count_pi3(n=100, gh=22, gw=29, merge=1):
    """Pi3 at 308 x 406: 638 patches, 643 tokens a frame in the encoder (cls
    and 4 registers) and in the decoder and heads (5 registers)."""
    c, hid = 1024, 4096
    m = n * 643
    block_products = 2 * m * c * (3 * c + c + 2 * hid)  # qkv, proj, fc1, fc2
    frame_attn = 4 * n * 643 * 643 * c
    global_attn = 4 * m * (m // merge) * c
    enc = 24 * (block_products + frame_attn) + 2 * n * 638 * 588 * c
    dec = 18 * (block_products + frame_attn) + 18 * (block_products + global_attn)
    heads = 3 * (2 * m * 2 * c * c + 5 * (block_products + frame_attn))
    heads += 2 * m * c * (c + c + 512)  # the head decoders' out projections
    mp = n * 638
    heads += 2 * mp * c * (588 + 196) + 6 * 2 * mp * 512 * 512 + 2 * n * 512 * (2 * 512 + 12)
    return enc + dec + heads


def test_pi3_chunk_flops_match_a_hand_count():
    got = roofline.pi3_chunk_flops(PI3["model"], 100, 308, 406)
    assert got == pytest.approx(_hand_count_pi3(), rel=1e-12)
    assert 430e12 < got < 440e12  # ~435 TFLOP a 100-frame chunk


def test_kv_merge_halves_the_global_keys():
    model = manifest.config("pi3-kvmerge2")["model"]
    got = roofline.pi3_chunk_flops(model, 100, 308, 406)
    assert got == pytest.approx(_hand_count_pi3(merge=2), rel=1e-12)
    # a chunk that the merge does not divide runs exact
    odd = roofline.pi3_chunk_flops(model, 99, 308, 406)
    assert odd == pytest.approx(roofline.pi3_chunk_flops(PI3["model"], 99, 308, 406))


def test_moge_grid_and_flops():
    moge = PI3["metric_depth"]
    assert roofline.moge_tokens(308, 406, 3600) == (52, 68)  # 3,536 patches + cls
    got = roofline.moge_frame_flops(moge, 308, 406)
    trunk = 12 * (2 * 3537 * 384 * (3 * 384 + 384 + 2 * 1536) + 4 * 3537 * 3537 * 384)
    # the neck and the two heads: 3x3 convs of 32-64 channels up to 16x the
    # token grid (832 x 1088 at the last level), ~0.28 TFLOP beside the trunk
    level4 = 3536 * 16 * 16
    convs = 3 * (2 * 2 * level4 * 9 * 32 * 32 + 2 * level4 * 9 * 32 * 32 + 2 * level4 // 4 * 9 * 32 * 128)
    assert got - trunk > convs
    assert 0.6e12 < got < 0.7e12


def test_bounds_and_work_counts():
    flops, nbytes = roofline.attention_work(1, 64300, 64300, 16, 64, 2)
    assert flops == 4 * 64300 * 64300 * 1024
    assert roofline.bound_ms(flops, nbytes) == pytest.approx(17.123, abs=1e-3)
    flops, nbytes = roofline.attention_work(1, 64300, 32150, 16, 64, 2)
    assert roofline.bound_ms(flops, nbytes) == pytest.approx(8.562, abs=1e-3)
    flops, nbytes = roofline.mlp_work(64300, 1024, 4096, 2)
    assert roofline.bound_ms(flops, nbytes) == pytest.approx(1.091, abs=1e-3)
    # a bytes-bound call
    assert roofline.bound_ms(1.0, 3.35e12) == pytest.approx(1e3)


def test_the_frozen_peaks_are_the_ports():
    from pi3_slam_tpu_torch.ops import roofline as port

    assert (roofline.PEAK_BF16, roofline.PEAK_FP32, roofline.PEAK_BYTES) == (
        port.PEAK_BF16, port.PEAK_FP32, port.PEAK_BYTES)
    assert roofline.attention_flops(2, 3, 5, 7, 11) == port.attention_flops(2, 3, 5, 7, 11)
