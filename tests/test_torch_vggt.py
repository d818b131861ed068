"""VGGT-1B on the port (``models/vggt.py``) against the benchmark's plain
reference (``portbench/reference/vggt.py``, float32, imports nothing of the
program) on seeded random weights, at a tiny size on the CPU.

Both sides compute in float32 here, the port on its kernels' plain CPU
versions, in other orders of summation: module outputs agree to 1e-5
relative L2 (float32 rounding through a few dozen layers reads ~1e-6). The
chunk files store points and confidences in float16, one unit of which is
2^-11 relative: they are held to 2e-3. The full-width heads against the
reference on the card are ``tests/test_torch_cuda.py``'s (``-k vggt``).
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import harness, manifest
from portbench.families import vggt as family
from portbench.reference import vggt as ref
from portbench.reference.chunk import stored
from portbench.reference.pi3 import Precision
from portbench.tests import tiny
from pi3_slam_tpu_torch.models.convert import build_vggt, init_vggt_params
from pi3_slam_tpu_torch.models.vggt import (
    VGGT,
    VGGTConfig,
    chunk_quantile,
    depth_to_local_points,
    pose_encoding_to_camera,
)

CPU = torch.device("cpu")
FP32 = 1e-5  # relative L2, float32 on both sides in other summation orders
STORED = 2e-3  # float16 storage: one unit is 2^-11 relative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(compute_dtype: str = "float32", **model) -> dict:
    """The cell's configuration at a tiny width: DINOv2 2 x 128, the
    aggregator 4 pairs at 128 (head dim 64, the packed route), the camera
    trunk one block at 256 (head dim 128, the unpacked route), DPT features
    32, MoGe-2 at a hundred tokens."""
    with open(os.path.join(manifest.HERE, "configs", "vggt1b-moge2.json")) as f:
        cfg = json.load(f)
    m = cfg["model"]
    m["encoder"].update(embed_dim=128, depth=2, num_heads=2)
    m.update(embed_dim=128, depth=4, num_heads=2, camera_depth=1, camera_num_heads=2,
             dpt_features=32, dpt_out_channels=[16, 32, 64, 64], dpt_layers=[0, 1, 2, 3])
    m.update(model)
    cfg["metric_depth"]["num_tokens_range"] = [60, 96]
    cfg["compute_dtype"] = compute_dtype
    return cfg


def program_config(cfg: dict) -> VGGTConfig:
    return VGGTConfig.from_dict({k: v for k, v in cfg["model"].items()
                                 if k not in family.ENTRY_KEYS})


def pair(cfg: dict, seed: int = 0, loud: bool = True):
    """(port model, reference model) on the same float32 weights
    (``init_vggt_params``). ``loud``: the special tokens drawn at std 1 and
    the camera head's pose embedding and modulation at 20 times their init,
    so that the reference frame's tokens and the adaLN iterations move the
    outputs well above rounding."""
    state = init_vggt_params(seed, program_config(cfg))
    if loud:
        rng = np.random.default_rng(seed + 1)
        for k in ("camera_token", "register_token"):
            state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
        for k in ("camera_head.embed_pose.weight", "camera_head.modulation.weight"):
            state[k] = state[k] * 20
    port = build_vggt(program_config(cfg), state, CPU, torch.float32)
    plain = ref.VGGT(cfg["model"])
    plain.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True,
                          assign=True)
    return port, plain


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _images(n=4, h=84, w=112, seed=0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, h, w, generator=g)


def _port_layers(port, images):
    n, _, h, w = images.shape
    mean = torch.tensor(ref.IMAGE_MEAN).reshape(1, 3, 1, 1)
    std = torch.tensor(ref.IMAGE_STD).reshape(1, 3, 1, 1)
    patches = port.encoder((images - mean) / std)["patch_tokens"]
    kept = port.aggregate(patches, 1, n, (h // 14, w // 14))
    return [kept[i] for i in port.cfg.dpt_layers]


@torch.no_grad()
def test_the_aggregator_matches_the_reference_and_frame_0_is_the_reference_frame():
    cfg = tiny_config()
    port, plain = pair(cfg)
    images = _images()
    got, want = _port_layers(port, images), plain.aggregate(images)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.shape == (4, 6 * 8 + 5, 256)
        assert _rel(a, b) < FP32
    # frames 1 and 2 swapped: the outputs swap (the global blocks are
    # equivariant over frames sharing a token set) ...
    perm = [0, 2, 1, 3]
    swapped = _port_layers(port, images[perm])
    for a, b in zip(swapped, got):
        assert _rel(a, b[perm]) < FP32
    # ... frames 0 and 1 swapped: frame 0 takes the other camera and register
    # tokens, so the outputs change beyond the swap
    perm = [1, 0, 2, 3]
    moved = _port_layers(port, images[perm])
    assert all(_rel(a, b[perm]) > 1e-2 for a, b in zip(moved, got))


@pytest.mark.parametrize("iterations", [1, 4])
@torch.no_grad()
def test_the_camera_head_iterations_match_the_reference(iterations):
    cfg = tiny_config(camera_iterations=iterations)
    port, plain = pair(cfg)
    tokens = torch.randn(1, 5, 256, generator=torch.Generator().manual_seed(3))
    got, want = port.camera_head(tokens)[0], plain.camera(tokens)
    assert got.shape == (5, 9)
    assert _rel(got, want) < FP32
    assert torch.all(got[:, 7:] >= 0)  # fields of view through ReLU
    if iterations == 4:  # each adaLN round refines the last: not the first round's answer
        one, _ = pair(tiny_config(camera_iterations=1))
        assert _rel(one.camera_head(tokens)[0], got) > 1e-2


@pytest.mark.parametrize("head", ["depth_head", "point_head"])
@torch.no_grad()
def test_each_dpt_head_matches_the_reference(head):
    cfg = tiny_config()
    port, plain = pair(cfg)
    layers = [torch.randn(3, 6 * 8 + 5, 256, generator=torch.Generator().manual_seed(i))
              for i in range(4)]
    got = getattr(port, head)(layers, (6, 8), (84, 112), 5)
    want = ref.dpt(getattr(plain, head), layers, (6, 8), (84, 112), 5)
    assert got.shape == (3, 2 if head == "depth_head" else 4, 84, 112)
    assert _rel(got, want) < FP32


def test_pose_encodings_become_intrinsics_poses_and_local_points():
    H, W = 84, 112
    fov_h, fov_w = 0.9, 1.1
    enc = torch.tensor([[1.0, 2.0, 3.0, 0.0, 0.0, 0.0, 1.0, fov_h, fov_w],
                        [0.5, -1.0, 2.0, 0.3, -0.2, 0.1, 0.4, 0.7, 0.0]])
    poses, K = pose_encoding_to_camera(enc, (H, W))
    assert torch.allclose(poses[0, :3, :3], torch.eye(3))
    assert torch.allclose(poses[0, :3, 3], -enc[0, :3])  # the camera centre -R^T t
    assert float(K[0, 0, 0]) == pytest.approx((W / 2) / np.tan(fov_w / 2), rel=1e-6)
    assert float(K[0, 1, 1]) == pytest.approx((H / 2) / np.tan(fov_h / 2), rel=1e-6)
    assert (float(K[0, 0, 2]), float(K[0, 1, 2])) == (W / 2, H / 2)
    # a quaternion of any length gives a rotation; the pose inverts [R|t]
    R = poses[1, :3, :3]
    assert torch.allclose(R @ R.T, torch.eye(3), atol=1e-6)
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-6)
    world_from_cam = poses[1]
    cam_from_world = torch.eye(4)
    cam_from_world[:3, :3] = R.T
    cam_from_world[:3, 3] = enc[1, :3]
    assert torch.allclose(world_from_cam @ cam_from_world, torch.eye(4), atol=1e-6)
    # a field of view at ReLU's 0: an infinite focal length, rays on the axis
    assert torch.isinf(K[1, 0, 0])
    depth = 1 + torch.rand(2, H, W, generator=torch.Generator().manual_seed(0))
    local = depth_to_local_points(depth, K)
    want_pose, fx, fy = ref.cameras(enc, H, W)
    assert torch.allclose(poses, want_pose, atol=1e-6)
    u, v = torch.arange(W).float(), torch.arange(H).float()
    want = torch.stack([(u - W / 2) / fx[:, None, None] * depth,
                        (v[:, None] - H / 2) / fy[:, None, None] * depth, depth], dim=-1)
    assert torch.equal(local, want)
    assert torch.all(local[1, ..., 0] == 0) and torch.all(torch.isfinite(local))


@pytest.mark.parametrize("share", [0.0, 0.25, 0.5, 1.0])
def test_the_confidence_mask_drops_the_chunks_lowest_share(share):
    conf = 1 + torch.rand(3, 17, 19, generator=torch.Generator().manual_seed(1)).exp()
    want = np.percentile(conf.double().numpy(), 100 * share)
    assert float(chunk_quantile(conf, share)) == pytest.approx(want, rel=1e-6)
    mask = VGGT.confidence_mask(conf, share)
    assert torch.equal(mask, ref.confidence_mask(conf, share))
    assert float(mask.double().mean()) == pytest.approx(1 - share, abs=2 / conf.numel())


def _png_frames(d, n, h=96, w=128, seed=0):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + 3 * n, 3), dtype=np.uint8)
    for i in range(n):
        Image.fromarray(base[:, 3 * i:3 * i + w]).save(os.path.join(d, f"{i:03d}.png"))
    return d


def test_the_creator_runs_vggt_from_the_cli_and_the_reference_reproduces_its_chunks(
        tmp_path, monkeypatch):
    from pi3_slam_tpu_torch import create_offline_chunks as cli
    from pi3_slam_tpu_torch.slam import chunk_creator

    cfg = tiny_config()
    vcfg = program_config(cfg)
    monkeypatch.setattr(chunk_creator, "VGGTConfig", lambda: vcfg)
    frames = _png_frames(str(tmp_path / "frames"), 7)
    out = str(tmp_path / "out")
    records = cli.create_chunks(["--images", frames, "--model", "vggt", "--output", out,
                                 "--chunk-length", "4", "--overlap", "1", "--pixel-limit",
                                 str(84 * 112), "--max-kp", "16", "--no-metric-depth",
                                 "--compute-dtype", "float32", "--device", "cpu"])
    assert [r["model"] for r in records] == ["vggt", "vggt"]
    assert [r["num_frames"] for r in records] == [4, 4]
    plain = ref.VGGT(cfg["model"])
    plain.load_state_dict({k: torch.from_numpy(v) for k, v in init_vggt_params(0, vcfg).items()},
                          strict=True, assign=True)
    with open(os.path.join(out, "chunks_manifest.json")) as f:
        manifest_entries = json.load(f)
    for entry in manifest_entries:
        with np.load(os.path.join(out, "chunks", entry["file"])) as z:
            got = {k: z[k] for k in z.files}
        paths = entry["image_paths"]
        from portbench.reference.chunk import grid_keypoints, load_frames

        images = torch.from_numpy(load_frames(paths, (84, 112)))
        kps = torch.from_numpy(grid_keypoints(84, 112, 16))[None].expand(len(paths), -1, -1)
        want = stored(ref.chunk_outputs(plain, images, kps, 0.25, 0.03), None)
        assert got["points"].dtype == np.float16
        for key in ("points", "local_points", "conf"):
            assert _rel(got[key].astype(np.float64), want[key]) < STORED, key
        assert _rel(got["camera_poses"].astype(np.float64), want["camera_poses"]) < FP32
        assert got["intrinsics"].shape == (4, 3, 3)
        # the chunk masks as the reference's at all but rounding-tied pixels
        assert np.mean(got["masks"] != want["masks"]) <= 0.05


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """A TMPDIR of the test's own, as each benchmark run has one."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


def _run(config, hook=None, traced=False):
    tr = tiny.traffic()
    return harness.run_cell("vggt-offline-submap16", 2**31 + 27, 1.0, traced, device="cpu",
                            config=config, traffic=tr, hook=hook)


def test_a_sound_tiny_run_of_the_cell_is_correct_and_its_traced_run_reads_mfu(tmpdir_env):
    r = _run(tiny_config())
    assert r["correct"] and r["failed"] == 0
    assert set(r["checks"]) == set(manifest.limits("vggt-offline-submap16"))
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    assert set(r["metrics"]) == {"offline_fps", "setup_s"}
    t = _run(tiny_config(), traced=True)
    assert t["correct"] and set(t["metrics"]) == {"mfu.offline"}  # no kernel traced on a CPU


def _zeroed_points(creator):
    step = creator._step

    def broken(images, kps, cand=None):
        out = step(images, kps, cand)
        out["points_kp"] = torch.zeros_like(out["points_kp"])
        return out

    creator._step = broken


def _first_frame_twice(creator):
    """The reference frame's tokens given to every frame: frame 1 run as a
    second frame 0."""
    step = creator._step

    def broken(images, kps, cand=None):
        return step(torch.cat([images[:1], images[:1], images[2:]]), kps, cand)

    creator._step = broken


@pytest.mark.parametrize("fault", [_zeroed_points, _first_frame_twice])
def test_a_fault_in_the_tiny_cell_is_not_correct(tmpdir_env, fault):
    r = _run(tiny_config(), fault)
    assert not r["correct"] and r["failed"] == 1
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def _depth_head_on_bf16_inputs(creator):
    """The depth head off fp32: its kept layers rounded to bf16 first (on the
    CPU there is no TF32 to switch on)."""
    head = creator.model.depth_head
    forward = head.forward
    head.forward = lambda layers, *args: forward([x.bfloat16().float() for x in layers], *args)


def test_a_depth_head_off_fp32_fails_the_heads_number_alone(tmpdir_env):
    """The stored arrays hide a head's precision under the trunk's: only the
    heads' numbers, the program's heads on the reference's own kept layers,
    see it. A sound run reads them at 0 here (the same float32 ops on the
    same inputs)."""
    sound = _run(tiny_config())["checks"]
    assert all(sound[f"{h}_head_rel"]["value"] == 0 for h in family.HEADS)
    r = _run(tiny_config(), _depth_head_on_bf16_inputs)
    assert not r["correct"]
    over = {k for k, v in r["checks"].items() if v["value"] > v["limit"]}
    assert over == {"depth_head_rel"}, r["checks"]


def test_the_control_is_not_correct_at_the_cells_limits(tmp_path):
    cfg, tr = tiny_config(), tiny.traffic()
    limits = manifest.limits("vggt-offline-submap16")
    paths = _png_frames(str(tmp_path / "f"), tr["chunk_length"], tr["frame_height"],
                        tr["frame_width"])
    paths = sorted(os.path.join(paths, p) for p in os.listdir(paths))
    seed = 2**31 + 99
    want = family.reference_chunk(cfg, tr, seed, paths, CPU)
    control = family.reference_chunk(cfg, tr, seed, paths, CPU, Precision(fp8=True))
    numbers = family.compare(control, want)
    assert set(limits) <= set(numbers)
    assert any(not numbers[k] <= limits[k] for k in limits), numbers
    # the same reference twice: every number 0 but the local points' gap, whose
    # depth is taken along the rays (z (x / z) in float64, rounding at 1e-16)
    same = family.compare(want, family.reference_chunk(cfg, tr, seed, paths, CPU))
    assert same.pop("local_points_rel") < 1e-12
    assert all(v == 0 for v in same.values()), same
    # no program of this seed was built: a side without heads of its own reads inf
    assert want["program_heads"] is None
    without = family.compare({k: v for k, v in want.items() if k != "heads"}, want)
    assert all(without[f"{h}_head_rel"] == float("inf") for h in family.HEADS)


def test_the_cells_configuration_is_vggt_1b_as_published():
    """The configuration as run: every width and depth VGGTConfig's defaults
    (VGGT-1B as published), nothing reduced, exact global attention, DINOv2
    and MoGe-2 as the Pi3 cell runs them, a bf16 trunk and fp32 heads, and
    the step's threshold VGGT's own."""
    entry = next(c for c in manifest.load_benchmark()["configs"] if c["name"] == "vggt1b-moge2")
    assert entry["file"] == "portbench/configs/vggt1b-moge2.json" and entry["reduced"] == []
    cfg, pi3 = manifest.config("vggt1b-moge2"), manifest.config("pi3-moge2")
    assert cfg["reduced"] == [] and cfg["family"] == "vggt"
    assert program_config(cfg) == VGGTConfig()
    assert cfg["model"]["global_kv_merge"] == 1
    assert cfg["model"]["encoder"] == pi3["model"]["encoder"]
    assert cfg["metric_depth"] == pi3["metric_depth"]
    assert (cfg["compute_dtype"], cfg["head_dtype"]) == ("bfloat16", "float32")
    assert cfg["step"] == {"conf_threshold": VGGT.default_conf_threshold, "depth_edge_rtol": 0.03}


def test_the_family_counts_the_dpt_heads_work_from_their_shapes():
    cfg = json.load(open(os.path.join(manifest.HERE, "configs", "vggt1b-moge2.json")))
    tr = manifest.traffic("submap16-7scenes-518")
    flops, nbytes = family.dpt_work(cfg, tr, 392, 518)
    assert flops == pytest.approx(7.23e12, rel=0.01)  # both heads on a 16-frame chunk
    assert flops / family.PEAK_FP32_ACCURATE > nbytes / 3.35e12  # bound by the products
    total = family.chunk_flops(cfg, tr, 392, 518)
    assert 6.5e13 < total < 7.5e13


def test_the_online_driver_and_the_mesh_refuse_vggt_by_name(tmp_path, capsys):
    from pi3_slam_tpu_torch import pi3_slam_online
    from pi3_slam_tpu_torch.slam import chunk_creator
    from pi3_slam_tpu_torch.slam.config import OfflineCreatorConfig

    # the online driver has no --model: it runs Pi3, and argparse refuses the flag by name
    # (an ambiguous prefix of --model-path / --model_path)
    with pytest.raises(SystemExit):
        pi3_slam_online.main(["--images", str(tmp_path), "--model", "vggt", "--device", "cpu"])
    assert "error: ambiguous option: --model " in capsys.readouterr().err
    small = program_config(tiny_config())
    with pytest.raises(ValueError, match="one device"):
        chunk_creator.OfflineChunkCreator(
            OfflineCreatorConfig(model="vggt", device="cpu", output_dir=str(tmp_path / "o"),
                                 use_metric_depth=False, compute_dtype="float32",
                                 data_parallel_chunks=2), small, devices=[CPU] * 2)
    for kw in ({"checkpoint_path": "pi3.npz"}, {"global_kv_merge": 2}):
        with pytest.raises(ValueError, match="model vggt"):
            chunk_creator.load_models(OfflineCreatorConfig(model="vggt", device="cpu", **kw),
                                      small, CPU)


def test_a_creator_config_without_a_threshold_takes_the_models_own(tmp_path, monkeypatch):
    """conf_threshold left unset: VGGT's step drops the chunk's lowest 25%
    (VGGT-SLAM's), Pi3's keeps sigmoid(conf) > 0.1 (the online driver's and
    the JAX creator's default); a threshold that is set is taken as given."""
    from pi3_slam_tpu_torch.models.pi3 import Pi3
    from pi3_slam_tpu_torch.slam import chunk_creator
    from pi3_slam_tpu_torch.slam.config import OfflineCreatorConfig, OnlineConfig

    assert Pi3.default_conf_threshold == OnlineConfig().conf_threshold == 0.1
    seen = []
    make = chunk_creator.make_chunk_step

    def recording(model, conf_threshold, *args, **kw):
        seen.append(conf_threshold)
        return make(model, conf_threshold, *args, **kw)

    monkeypatch.setattr(chunk_creator, "make_chunk_step", recording)
    small = program_config(tiny_config())
    for kw in ({}, {"conf_threshold": 0.4}):
        chunk_creator.OfflineChunkCreator(
            OfflineCreatorConfig(model="vggt", device="cpu", output_dir=str(tmp_path / "o"),
                                 use_metric_depth=False, compute_dtype="float32", **kw), small)
    assert seen == [0.25, 0.4]


def test_the_vggt_spans_reach_a_profile_dir_trace_and_its_by_span_table(tmp_path, monkeypatch):
    """--profile-dir on a VGGT chunk: the model's spans (vggt.encoder,
    .aggregator, .camera_head, .depth_head, .point_head) sit inside
    creator.dispatch in the trace, and trace_summary's by-span table lists
    them."""
    from pi3_slam_tpu_torch import create_offline_chunks as cli
    from pi3_slam_tpu_torch.slam import chunk_creator
    from pi3_slam_tpu_torch.tools import trace_summary

    vcfg = program_config(tiny_config())
    monkeypatch.setattr(chunk_creator, "VGGTConfig", lambda: vcfg)
    frames = _png_frames(str(tmp_path / "frames"), 7)
    prof = tmp_path / "prof"
    cli.create_chunks(["--images", frames, "--model", "vggt", "--output", str(tmp_path / "out"),
                       "--chunk-length", "4", "--overlap", "1", "--pixel-limit", str(84 * 112),
                       "--max-kp", "16", "--no-metric-depth", "--compute-dtype", "float32",
                       "--device", "cpu", "--profile-dir", str(prof)])
    with open(prof / "chunk_trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    names = ("vggt.encoder", "vggt.aggregator", "vggt.camera_head", "vggt.depth_head",
             "vggt.point_head")
    dispatch = spans["creator.dispatch"]
    for name in names + ("step.post",):
        e = spans[name]
        assert dispatch["ts"] <= e["ts"] and e["ts"] + e["dur"] <= dispatch["ts"] + dispatch["dur"]
    table = trace_summary.summarize(str(prof / "chunk_trace.json"))["by_span"]
    assert all(table[name]["count"] == 1 for name in names)


def _trace_with_spans(monkeypatch, spans):
    """A synthetic trace on its own clock (anchor (0, 0), base 0): each span
    (name, start us, end us) recorded by the program, and kernels launched at
    given times; the program's recorder stands in for by ``program_spans``."""
    from portbench import spans as pb_spans

    recorded = [{"name": n, "start_ns": int(a * 1e3), "end_ns": int(b * 1e3), "id": i,
                 "parent": None, "chunk": 0, "thread": 1, "anchor": (0, 0)}
                for i, (n, a, b) in enumerate(spans)]
    monkeypatch.setattr(pb_spans, "program_spans", lambda: (recorded, (0, 0)))


def _kernel(name, launch_us, start_us, dur_us, corr, grid=(1, 1, 1)):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_us, "dur": 1,
             "args": {"correlation": corr}},
            {"cat": "kernel", "name": name, "ts": start_us, "dur": dur_us,
             "args": {"correlation": corr, "grid": list(grid)}}]


def test_the_new_metrics_read_kernels_by_where_they_were_launched(monkeypatch):
    """``portbench/launched.py``: a kernel counts for a span when its launch
    lies inside it, wherever the card ran it; the readers turn the counted
    device time into shares of the configuration's bound, and read None
    without the spans or outside the family."""
    from types import SimpleNamespace

    from portbench import launched
    from portbench.roofline import attention_work, bound_ms

    _trace_with_spans(monkeypatch, [("vggt.aggregator", 100, 200), ("vggt.depth_head", 300, 400),
                                    ("vggt.point_head", 400, 500)])
    packed = "(anonymous namespace)::packed_attention_kernel(CUtensorMap_st)"
    events = (_kernel(packed, 150, 600, 20, 1)            # a global block: counted
              + _kernel(packed, 160, 620, 30, 2, (4, 16, 16))  # a frame block (B 16): not
              + _kernel(packed, 250, 650, 40, 3)           # launched outside the span: not
              + _kernel("cudnn_conv", 350, 700, 50, 4)      # the depth head
              + _kernel("cudnn_conv", 450, 800, 60, 5))     # the point head
    assert launched.kernel_seconds_in_spans(events, ("vggt.aggregator",),
                                            manifest.kernel_specs("global_attn")) == (20e-6, 1)
    got = launched.kernel_seconds_in_spans(events, ("vggt.depth_head", "vggt.point_head"))
    assert got[1] == 2 and got[0] == pytest.approx(110e-6)
    assert launched.kernel_seconds_in_spans(events, ("vggt.camera_head",)) is None

    cfg = json.load(open(os.path.join(manifest.HERE, "configs", "vggt1b-moge2.json")))
    tr = manifest.traffic("submap16-7scenes-518")
    run = SimpleNamespace(events=events, config=cfg, traffic=tr, hw=(392, 518), traced_chunks=1)
    dpt = manifest.metric_module("dpt_roofline.vggt").read(run)
    flops, _ = family.dpt_work(cfg, tr, 392, 518)
    assert dpt == pytest.approx(100 * flops / family.PEAK_FP32_ACCURATE / 110e-6)
    attn = manifest.metric_module("aggregator_attn_roofline.vggt").read(run)
    t = 16 * (28 * 37 + 5)
    least = 24 * bound_ms(*attention_work(1, t, t, 16, 64, 2)) / 1e3
    assert attn == pytest.approx(100 * least / 20e-6)
    pi3 = SimpleNamespace(**{**vars(run), "config": manifest.config("pi3-moge2")})
    for name in ("dpt_roofline.vggt", "aggregator_attn_roofline.vggt"):
        assert manifest.metric_module(name).read(pi3) is None
        assert manifest.metric_module(name).read(SimpleNamespace(**{**vars(run),
                                                                      "events": None})) is None
