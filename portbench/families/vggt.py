"""The VGGT family: VGGT-1B built from the seed, its FLOPs and the work of
its DPT heads, its plain reference and the numbers that decide ``correct``.

``build_program`` imports the port's ``models.vggt`` before anything else, so
a program without VGGT fails at once with an ImportError. The weights are
drawn on the card by ``vggt_weights.draw`` (the trunk in the configuration's
compute dtype, the heads in fp32) and handed to ``models.convert.build_vggt``;
MoGe-2 is the Pi3 family's, drawn from the same stream with the same runner
(kept here: the Pi3 family builds it inside its ``build_program``).

The check holds the program's heads apart from its trunk: ``build_program``
keeps the model's camera, depth and point heads (the harness frees the rest
before the check) and the TF32 flags each forward of the model ran under, and
``reference_chunk`` runs them, under those flags, on the reference's own
float32 kept layers of the checked chunk, beside the reference's heads.
The trunk's bf16 noise moves the stored arrays by ~1e-2, TF32 in the heads
by ~1e-3: only these numbers see the heads leave fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from ..reference.chunk import grid_keypoints, load_frames, stored, target_size
from ..reference.moge import MoGe as RefMoGe
from ..reference.pi3 import Precision, allow_tf32
from ..reference.vggt import VGGT as RefVGGT
from ..reference.vggt import chunk_outputs, dpt
from ..vggt_weights import draw
from ..weights import derive_seed
from .pi3 import DTYPES, _moge_state, _probe_ratio, _rel, moge_program_config

VGGT_STREAM = 0
# fp32-accurate products (3xTF32 on the tensor cores), the port's
# ops/roofline.py rate for its fp32 entries
PEAK_FP32_ACCURATE = 165e12
# keys of the configuration's ``model`` that are not VGGTConfig fields: the
# offline entry reads global_kv_merge (VGGT has no such option; 1, exact)
ENTRY_KEYS = ("global_kv_merge",)
# the float16 chunk file's resolution of a ray's angle (x / z to 2^-10
# relative, at most 2^-11 rad): the least gap the ray probe is taken as
RAY_FLOOR = 2.0**-11
HEADS = ("camera", "depth", "point")

# the heads of the program last built, for the check (see the module's doc)
_held: dict = {}


def _tf32() -> tuple[bool, bool]:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _hold_heads(model, seed: int) -> None:
    """Keep ``model``'s heads for the check of ``seed``'s run, and record the
    TF32 flags at each call of its forward."""
    global _held
    held = {"seed": seed, "heads": (model.camera_head, model.depth_head, model.point_head),
            "num_special": model.num_special, "tf32": _tf32()}
    forward = model.forward

    def recording_forward(*args, **kw):
        held["tf32"] = _tf32()
        return forward(*args, **kw)

    model.forward = recording_forward
    _held = held


def _program_heads(layers: list, grid: tuple, hw: tuple, seed: int) -> dict | None:
    """The raw outputs of the held program heads on the kept (N, T, 2C)
    float32 layers, run under the flags the program's forward last ran
    under; None where the program of ``seed`` is not held."""
    held = _held
    if held.get("seed") != seed:
        return None
    camera, depth, point = held["heads"]
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held["tf32"]
    try:
        out = (camera(layers[-1][None, :, 0])[0], depth(layers, grid, hw, held["num_special"]),
               point(layers, grid, hw, held["num_special"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return {k: v.float().cpu().numpy() for k, v in zip(HEADS, out)}


def _reference_heads(model: RefVGGT, layers: list, grid: tuple, hw: tuple, tf32: bool) -> dict:
    """The raw outputs of the reference's heads on the kept layers: the
    activated pose encodings (N, 9) and the DPT heads' maps (N, 2 | 4, H,
    W) before their activations; in TF32 where ``tf32``."""
    special = 1 + model.cfg["num_register_tokens"]
    with allow_tf32(tf32):
        out = (model.camera(layers[-1][None, :, 0]),
               dpt(model.depth_head, layers, grid, hw, special),
               dpt(model.point_head, layers, grid, hw, special))
    return {k: v.float().cpu().numpy() for k, v in zip(HEADS, out)}


def _vggt_state(config: dict, seed: int, device, out_dtype=None) -> dict:
    return draw(RefVGGT(config["model"]), derive_seed(seed, VGGT_STREAM), device,
                DTYPES[config["compute_dtype"]], out_dtype)


def build_program(config: dict, seed: int, device: torch.device):
    """(VGGT model, VGGTConfig, MoGe runner or None) of the program, with the
    seed's weights: what ``slam.chunk_creator.load_models`` returns."""
    from pi3_slam_tpu_torch.models.vggt import VGGTConfig  # first: fails fast without VGGT

    from pi3_slam_tpu_torch.models.convert import build_moge, build_vggt
    from pi3_slam_tpu_torch.models.moge import MoGeRunner
    from pi3_slam_tpu_torch.models.moge_model import MoGeConfig

    vggt_config = VGGTConfig.from_dict({k: v for k, v in config["model"].items()
                                        if k not in ENTRY_KEYS})
    model = build_vggt(vggt_config, _vggt_state(config, seed, device), device,
                       DTYPES[config["compute_dtype"]])
    _hold_heads(model, seed)
    moge = None
    if config.get("metric_depth") is not None:
        moge_cfg = MoGeConfig.from_json(moge_program_config(config["metric_depth"]))

        class SeededMoGe(MoGeRunner):
            """The runner over a model built from the drawn weights; the
            model's last outputs stay readable as ``last_out`` (the Pi3
            family's runner)."""

            def __init__(self):
                self.cfg = moge_cfg
                self.model = build_moge(moge_cfg, _moge_state(config, seed, device), device,
                                        torch.float32)
                self.device = device
                self._replicas = [(device, self.model)]
                self.last_out = None
                forward = self.model.forward

                def keep_forward(*args, **kw):
                    self.last_out = forward(*args, **kw)
                    return self.last_out

                self.model.forward = keep_forward

        moge = SeededMoGe()
    return model, vggt_config, moge


def _sizes(model: dict, height: int, width: int) -> dict:
    """The feature-map sizes (h, w) of the DPT head at a height x width chunk."""
    p = model["patch_size"]
    h, w = height // p, width // p
    h3, w3 = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # the stride-2 3x3 conv
    return {"grid": (h, w), "levels": [(4 * h, 4 * w), (2 * h, 2 * w), (h, w), (h3, w3)],
            "top": (8 * h, 8 * w), "image": (height, width)}


def dpt_flops(model: dict, n: int, height: int, width: int, out_dim: int) -> float:
    """FLOPs of one DPT head on n frames (2 a multiply-add): the 1x1
    projections, the resize convolutions, the four 3x3 scratch convolutions,
    the fusion blocks' residual units and 1x1 out-convs, the output
    convolutions. Interpolations, norms and activations left out (under 1%)."""
    s = _sizes(model, height, width)
    oc, f, d = model["dpt_out_channels"], model["dpt_features"], 2 * model["embed_dim"]
    (h, w), levels = s["grid"], s["levels"]

    def conv(hw, k, c_in, c_out):
        return n * roofline._conv(hw[0] * hw[1], k, c_in, c_out)

    flops = sum(conv((h, w), 1, d, c) for c in oc)
    flops += 2.0 * n * levels[0][0] * levels[0][1] * oc[0] * oc[0]  # transposed 4x4 stride 4
    flops += 2.0 * n * levels[1][0] * levels[1][1] * oc[1] * oc[1]  # transposed 2x2 stride 2
    flops += conv(levels[3], 3, oc[3], oc[3])
    flops += sum(conv(hw, 3, c, f) for hw, c in zip(levels, oc))
    # refinenet 4 (one unit) out at level 2; 3 and 2 (two units) out at the next level up;
    # 1 (two units) out at twice level 0
    flops += 2 * conv(levels[3], 3, f, f) + conv(levels[2], 1, f, f)
    flops += 4 * conv(levels[2], 3, f, f) + conv(levels[1], 1, f, f)
    flops += 4 * conv(levels[1], 3, f, f) + conv(levels[0], 1, f, f)
    flops += 4 * conv(levels[0], 3, f, f) + conv(s["top"], 1, f, f)
    flops += conv(s["top"], 3, f, f // 2)
    flops += conv(s["image"], 3, f // 2, 32) + conv(s["image"], 1, 32, out_dim)
    return flops


def dpt_work(config: dict, traffic: dict, height: int, width: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the depth and point heads on one chunk, fp32: the
    FLOPs of :func:`dpt_flops`; the bytes each head's inputs read once (the
    four kept layers' patch tokens, 2C wide), its weights once and its
    output maps written once."""
    model = config["model"]
    n = traffic["chunk_length"]
    p = model["patch_size"]
    hw = (height // p) * (width // p)
    d = 2 * model["embed_dim"]
    oc, f = model["dpt_out_channels"], model["dpt_features"]
    weights = (sum(d * c + c for c in oc) + oc[0] ** 2 * 16 + oc[1] ** 2 * 4 + oc[3] ** 2 * 9
               + sum(9 * c * f for c in oc) + 14 * (9 * f * f + f) + 4 * (f * f + f)
               + 9 * f * (f // 2) + 9 * (f // 2) * 32 + 2 * d)
    flops = nbytes = 0.0
    for out_dim in (2, 4):
        flops += dpt_flops(model, n, height, width, out_dim)
        nbytes += 4.0 * (4 * n * hw * d + weights + 32 * out_dim + out_dim
                         + n * height * width * out_dim)
    return flops, nbytes


def chunk_flops(config: dict, traffic: dict, height: int, width: int) -> float:
    """The configuration's FLOPs for one chunk of the traffic's length: the
    DINOv2 encoder, the aggregator's frame and global blocks, the camera head's
    iterations, both DPT heads and, with metric depth, MoGe-2 on the chunk's
    first frame."""
    model = config["model"]
    n = traffic["chunk_length"]
    enc = model["encoder"]
    p = model["patch_size"]
    gh, gw = height // p, width // p
    hw = gh * gw
    ce = enc["embed_dim"]
    flops = roofline._linear(n * hw, 3 * p * p, ce)
    flops += enc["depth"] * roofline._block(n, hw + 1 + enc["num_register_tokens"], ce,
                                            ce * enc["mlp_ratio"])
    c = model["embed_dim"]
    t = hw + 1 + model["num_register_tokens"]
    hidden = c * model["mlp_ratio"]
    flops += model["depth"] * (roofline._block(n, t, c, hidden)
                               + roofline._block(1, n * t, c, hidden))
    d = 2 * c
    per_round = (model["camera_depth"] * roofline._block(1, n, d, d * model["camera_mlp_ratio"])
                 + roofline._linear(n, 9, d) + roofline._linear(n, d, 3 * d)
                 + roofline._linear(n, d, d // 2) + roofline._linear(n, d // 2, 9))
    flops += model["camera_iterations"] * per_round
    flops += dpt_work(config, traffic, height, width)[0]
    if config.get("metric_depth") is not None:
        flops += roofline.moge_frame_flops(config["metric_depth"], height, width)
    return flops


@torch.no_grad()
def reference_chunk(config: dict, traffic: dict, seed: int, paths: list, device,
                    prec: Precision | None = None) -> dict:
    """The stored arrays of the chunk over ``paths`` and MoGe's outputs on its
    first frame (``moge``), worked out by the plain reference in float32 (TF32
    off) from the image files and the seed's weights; ``prec`` runs the
    control's lower precision instead (the trunk's products on float8
    operands, the fp32 heads and MoGe-2 in TF32).

    ``heads``: the reference's heads on its float32 kept layers (in TF32 for
    the control: the heads' own control, on the float32 trunk's layers), and
    without ``prec`` ``program_heads``: the held program heads of ``seed``
    on the same layers (None where none is held)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hw = target_size(paths[0], traffic["pixel_limit"])
    images = torch.from_numpy(load_frames(paths, hw)).to(device)
    kps = torch.from_numpy(grid_keypoints(hw[0], hw[1], traffic["max_keypoints"]))
    kps = kps[None].expand(len(paths), -1, -1).to(device)
    moge_out = None
    if config.get("metric_depth") is not None:
        moge = RefMoGe(config["metric_depth"])
        moge.load_state_dict(_moge_state(config, seed, device), strict=True, assign=True)
        moge_out = {k: v.double().cpu().numpy() for k, v in moge.infer(images[0], prec).items()}
        del moge
    model = RefVGGT(config["model"])
    model.load_state_dict(_vggt_state(config, seed, device, torch.float32), strict=True,
                          assign=True)
    kept = []
    aggregate = model.aggregate

    def keep_aggregate(x, p=None):
        kept.append(aggregate(x, p))
        return kept[-1]

    model.aggregate = keep_aggregate
    step = config["step"]
    out = chunk_outputs(model, images, kps, step["conf_threshold"], step["depth_edge_rtol"], prec)
    del model.aggregate  # no cycle through the bound method: the model frees at once
    layers = kept.pop() if prec is None else aggregate(images.float() / 255.0)
    del kept, aggregate
    p = config["model"]["patch_size"]
    grid = (hw[0] // p, hw[1] // p)
    heads = _reference_heads(model, layers, grid, hw, prec is not None and prec.fp8)
    program_heads = _program_heads(layers, grid, hw, seed) if prec is None else None
    del model, layers
    ref = stored(out, None if moge_out is None else moge_out["depth"])
    ref["heads"], ref["program_heads"] = heads, program_heads
    ref["rays_probe"] = rays(out["local_points_probe_kp"].double().cpu().numpy())
    ref["moge"] = moge_out
    return ref


def rays(local: np.ndarray) -> np.ndarray:
    """(x / z, y / z) of local points (..., 3): the pixel rays at unit depth."""
    return local[..., :2] / local[..., 2:]


def compare(program: dict, reference: dict) -> dict:
    """The numbers that can decide ``correct`` for one chunk, in float64 (a
    cell's limits file names those it compares):

    * ``local_points_rel``: the relative L2 gap of the stored keypoint local
      points (depth times the pixel rays of the predicted intrinsics) taken
      along the reference's rays: the program's depth times the reference's
      ray (x / z, y / z, 1) at each keypoint, against the reference's local
      points. The rays themselves are the camera head's and are compared by
      ``ray_probe_ratio``;
    * ``conf_rel``, ``points_rel``: relative L2 gaps of the stored keypoint
      depth confidences and world points (the point head's own, not composed
      with a pose), each scaled by its side's metric scale as stored;
    * ``rotation_probe_ratio``, ``translation_probe_ratio``,
      ``ray_probe_ratio``: the camera rotations', translations' and keypoint
      rays' gap, root mean square over the frames, over the gap that one
      bf16 unit of noise on the camera head's input tokens makes in the
      reference (the Pi3 family's probe, here also through the fields of
      view). A ray's gap is its angles' (atan(x / z), atan(y / z)), root mean
      square over the frame's keypoints, and a frame's probe gap is taken as
      at least the float16 file's resolution of an angle (``RAY_FLOOR``);
    * ``camera_head_rel``, ``depth_head_rel``, ``point_head_rel``: relative
      L2 gaps of each head's raw outputs (``reference_chunk``'s ``heads``)
      on the reference's float32 kept layers: the program's own heads
      (``reference['program_heads']``, run there; a side that brings
      ``heads`` of its own, as the control does, is compared by those);
      inf where the program's heads did not run;
    * with metric depth, MoGe-2's points, mask and metric scale as its
      forward hands them to the shift solve (relative L2).

    Every frame is compared, degenerate ones too. Random weights put fields
    of view anywhere from ReLU's 0 to past pi. At 0 a frame's focal length
    is infinite and its rays lie on the optical axis (x = y = 0) on both
    sides, or within rounding of it (the floor keeps a chunk whose every
    field of view sits at 0 from dividing by nothing). Towards pi the rays
    grow without bound and rounding of the field of view moves them as far
    (tan(fov / 2)'s slope): the program's depth along the reference's rays
    keeps such a frame from swamping the depth's gap, and the rays' angles
    move at most half as fast as the field of view, so the ray ratio stays
    in scale. A quaternion near zero turns its rotation by rounding alone;
    the probe turns it as far.
    """
    P, R = program["camera_poses"].astype(np.float64), reference["camera_poses"]
    Q = reference["camera_poses_probe"]
    scale = reference["metric_scale"] or 1.0

    def rot(a):
        return np.linalg.norm((a[:, :3, :3] - R[:, :3, :3]).reshape(len(R), -1), axis=-1)

    def trans(a, s=1.0):
        return np.linalg.norm(a[:, :3, 3] * s - R[:, :3, 3], axis=-1)

    local, ref_local = program["local_points"].astype(np.float64), reference["local_points"]
    ref_rays = rays(ref_local)

    def ray_gap(r):  # per frame, RMS over the keypoints of the rays' angle gaps
        return np.sqrt(np.mean(np.sum((np.arctan(r) - np.arctan(ref_rays)) ** 2, -1), -1))

    along = local[..., 2:] * np.concatenate([ref_rays, np.ones_like(ref_rays[..., :1])], -1)
    nums = {
        "local_points_rel": _rel(along, ref_local),
        "conf_rel": _rel(program["conf"], reference["conf"]),
        "points_rel": _rel(program["points"], reference["points"]),
        "rotation_probe_ratio": _probe_ratio(rot(P), rot(Q)),
        "translation_probe_ratio": _probe_ratio(trans(P), trans(Q, scale)),
        "ray_probe_ratio": _probe_ratio(ray_gap(rays(local)),
                                        np.maximum(ray_gap(reference["rays_probe"]), RAY_FLOOR)),
    }
    heads = program.get("heads", reference.get("program_heads"))
    for name in HEADS:
        nums[f"{name}_head_rel"] = (float("inf") if heads is None
                                    else _rel(heads[name], reference["heads"][name]))
    if reference.get("moge") is not None:
        a, b = program["moge"], reference["moge"]
        for key in ("points", "mask", "metric_scale"):  # no MoGe output: a fault
            name = "moge_scale_rel" if key == "metric_scale" else f"moge_{key}_rel"
            nums[name] = float("inf") if a is None else _rel(a[key], b[key])
    return nums
