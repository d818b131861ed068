"""The plain reference holds the port's chunk step and MoGe-2 at a tiny size
on the CPU (both in float32, the port on its plain versions); the weights
drawn from a seed repeat."""

import numpy as np
import pytest
import torch

from portbench.families import pi3 as family
from portbench.reference.chunk import chunk_outputs
from portbench.reference.moge import MoGe as RefMoGe
from portbench.reference.pi3 import Pi3 as RefPi3
from portbench.tests import tiny
from portbench.weights import derive_seed, draw, leaf_rule

CPU = torch.device("cpu")


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + 3 * n, 3)).astype(np.uint8)
    return np.stack([base[:, 3 * i:3 * i + w].transpose(2, 0, 1) for i in range(n)])


@pytest.mark.parametrize("name", ["pi3-moge2", "pi3-kvmerge2"])
def test_the_ports_chunk_step_matches_the_reference(name):
    from pi3_slam_tpu_torch.slam.chunk_creator import make_chunk_step

    cfg = tiny.config(name)
    model, _, moge = family.build_program(cfg, 123456789012, CPU)
    images = torch.from_numpy(_frames(4, 84, 112))
    kps = torch.from_numpy(np.stack([np.array([[5.0, 7.0], [50.5, 40.25], [111.0, 83.0]],
                                              np.float32)] * 4))
    step = make_chunk_step(model, cfg["step"]["conf_threshold"], cfg["step"]["depth_edge_rtol"],
                           estimate_intrinsics=True)
    got = step(images, kps)
    ref_model = RefPi3(cfg["model"])
    ref_model.load_state_dict(family._pi3_state(cfg, 123456789012, CPU, torch.float32),
                              assign=True)
    want = chunk_outputs(ref_model, images, kps, cfg["step"]["conf_threshold"],
                         cfg["step"]["depth_edge_rtol"])
    # fp32 on both sides in other orders of summation
    for key in ("points_kp", "local_points_kp", "conf_kp", "camera_poses", "depth0"):
        a, b = got[key].double(), want[key].double()
        assert float((a - b).norm() / b.norm()) < 1e-4, key
    for key in ("masks_kp", "mask0"):
        assert torch.equal(got[key], want[key]), key
    if moge is None:
        return
    from pi3_slam_tpu_torch.models.moge_model import moge_infer_depth

    ref_moge = RefMoGe(cfg["metric_depth"])
    ref_moge.load_state_dict(family._moge_state(cfg, 123456789012, CPU), assign=True)
    with torch.no_grad():
        a = moge_infer_depth(moge.model, images[0].float() / 255.0)
    b = ref_moge.depth(images[0])
    # the shift solve is degenerate on random weights (focal ~0, the loss flat
    # in the shift): rounding moves the shift, which offsets the depth and
    # flips the sign test of pixels near z = -shift; the offset removed, the
    # depth agrees
    fin = torch.isfinite(a) & torch.isfinite(b)
    assert float(fin.double().mean()) > 0.2
    assert float((torch.isfinite(a) != torch.isfinite(b)).double().mean()) < 0.01
    d = (a - b)[fin].double()
    assert float((d - d.mean()).norm() / b[fin].double().norm()) < 1e-4


def test_weights_repeat_from_the_seed_and_follow_the_ports_init():
    cfg = tiny.config()
    a = draw(RefPi3(cfg["model"]), derive_seed(5, 0), CPU, torch.bfloat16)
    b = draw(RefPi3(cfg["model"]), derive_seed(5, 0), CPU, torch.bfloat16, torch.float32)
    c = draw(RefPi3(cfg["model"]), derive_seed(6, 0), CPU, torch.bfloat16)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k].float(), b[k]) for k in a)
    assert not torch.equal(a["decoder.0.qkv.weight"], c["decoder.0.qkv.weight"])
    w = a["decoder.0.fc1.weight"].float()
    assert float(w.std()) == pytest.approx(0.02, rel=0.05) and float(w.abs().max()) <= 0.0347
    assert torch.allclose(a["decoder.0.ls1"].float(), torch.tensor(0.01), rtol=1e-2)
    assert torch.all(a["encoder.blocks.0.ls1"] == 1) and torch.all(a["decoder.0.qkv.bias"] == 0)
    assert torch.all(a["decoder.0.q_norm.weight"] == 1)
    assert float(a["camera_head.mlp1.weight"].float().abs().max()) <= 0.04 + 1e-3
    assert leaf_rule("neck.res_blocks.0.0.conv1.weight", (64, 64, 3, 3)) == (
        "uniform", (64 * 9) ** -0.5)
    assert leaf_rule("scale_head.0.weight", (64, 384)) == ("uniform", 384 ** -0.5)
    assert derive_seed(2**31 + 5, 0) != derive_seed(-(2**31 + 5), 0)
