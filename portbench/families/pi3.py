"""The Pi3 family: its program models built from the seed, its FLOPs, its
plain reference and the numbers that decide ``correct``.

``build_program`` is the only place that hands the benchmark's weights to the
program: ``models.convert.build_pi3`` and ``build_moge`` take the state
dicts drawn by ``weights.draw`` on the card (in the type they are served
in: Pi3 in the configuration's compute dtype, MoGe-2 in fp32), in place of
the creator's host-side seed-0 numpy draw.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import roofline
from ..reference.chunk import chunk_outputs, grid_keypoints, load_frames, stored, target_size
from ..reference.moge import MoGe as RefMoGe
from ..reference.pi3 import Pi3 as RefPi3
from ..reference.pi3 import Precision
from ..weights import derive_seed, draw

PI3_STREAM, MOGE_STREAM = 0, 1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _pi3_state(config: dict, seed: int, device, out_dtype=None) -> dict:
    return draw(RefPi3(config["model"]), derive_seed(seed, PI3_STREAM), device,
                DTYPES[config["compute_dtype"]], out_dtype)


def _moge_state(config: dict, seed: int, device) -> dict:
    return draw(RefMoGe(config["metric_depth"]), derive_seed(seed, MOGE_STREAM), device,
                torch.float32)


def moge_program_config(moge: dict) -> str:
    """The program's MoGeConfig JSON: the metric-depth entry without the
    reference's explicit encoder widths."""
    return json.dumps({k: v for k, v in moge.items() if k != "encoder"})


def build_program(config: dict, seed: int, device: torch.device):
    """(pi3 model, Pi3Config, MoGe runner or None) of the program, with the
    seed's weights: what ``slam.chunk_creator.load_models`` returns."""
    from pi3_slam_tpu_torch.models.convert import build_moge, build_pi3
    from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
    from pi3_slam_tpu_torch.models.moge import MoGeRunner
    from pi3_slam_tpu_torch.models.moge_model import MoGeConfig
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config

    fields = dict(config["model"])
    pi3_config = Pi3Config(encoder=DinoV2Config(**fields.pop("encoder")), **fields)
    model = build_pi3(pi3_config, _pi3_state(config, seed, device), device,
                      DTYPES[config["compute_dtype"]])
    moge = None
    if config.get("metric_depth") is not None:
        moge_cfg = MoGeConfig.from_json(moge_program_config(config["metric_depth"]))

        class SeededMoGe(MoGeRunner):
            """The runner over a model built from the drawn weights; the
            model's last outputs (points, mask, metric scale, before the
            focal and shift solve) stay readable as ``last_out``."""

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
    return model, pi3_config, moge


def chunk_flops(config: dict, traffic: dict, height: int, width: int) -> float:
    """The configuration's FLOPs for one chunk of the traffic's length: the
    Pi3 forward and, with metric depth, MoGe-2 on the chunk's first frame."""
    flops = roofline.pi3_chunk_flops(config["model"], traffic["chunk_length"], height, width)
    if config.get("metric_depth") is not None:
        flops += roofline.moge_frame_flops(config["metric_depth"], height, width)
    return flops


@torch.no_grad()
def reference_chunk(config: dict, traffic: dict, seed: int, paths: list, device,
                    prec: Precision | None = None) -> dict:
    """The stored arrays of the chunk over ``paths`` and MoGe's outputs on its
    first frame (``moge``: points, mask, metric_scale, depth), worked out by
    the plain reference in float32 (TF32 off) from the image files and the
    seed's weights; ``prec`` runs the control's lower precision instead."""
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
    model = RefPi3(config["model"])
    model.load_state_dict(_pi3_state(config, seed, device, torch.float32), strict=True,
                          assign=True)
    step = config["step"]
    out = chunk_outputs(model, images, kps, step["conf_threshold"], step["depth_edge_rtol"], prec)
    del model
    ref = stored(out, None if moge_out is None else moge_out["depth"])
    ref["moge"] = moge_out
    return ref


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64; inf where a is not finite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.isfinite(a).all():
        return float("inf")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _probe_ratio(gap: np.ndarray, probe: np.ndarray) -> float:
    """RMS over frames of the program's gap over the RMS of the probe's."""
    if not np.isfinite(gap).all():
        return float("inf")
    return float(np.sqrt(np.mean(gap**2)) / max(np.sqrt(np.mean(probe**2)), 1e-30))


def compare(program: dict, reference: dict) -> dict:
    """The numbers that can decide ``correct`` for one chunk, in float64 (a
    cell's limits file names those it compares):

    * ``local_points_rel``, ``conf_rel``: relative L2 gaps of the stored
      local keypoint points and confidences;
    * ``points_rel``: the stored world keypoint points taken back into each
      camera by the program's own pose, against the reference's local
      points (relative L2);
    * ``rotation_probe_ratio``, ``translation_probe_ratio``: the camera
      rotations' and translations' gap, root mean square over the frames,
      over the gap that one bf16 unit of noise on the camera head's input
      tokens makes in the reference (``camera_poses_probe``). On random
      weights the camera head magnifies its input's rounding by a factor
      that changes from seed to seed (tokens cancel in its mean pool, and
      some frames' closest rotation is ill posed); the probe takes out part
      of it;
    * with metric depth, MoGe-2's points, mask and metric scale as its
      forward hands them to the focal and shift solve (relative L2).
    """
    P, R = program["camera_poses"].astype(np.float64), reference["camera_poses"]
    Q = reference["camera_poses_probe"]
    scale = reference["metric_scale"] or 1.0

    def rot(a):
        return np.linalg.norm((a[:, :3, :3] - R[:, :3, :3]).reshape(len(R), -1), axis=-1)

    def trans(a, s=1.0):
        return np.linalg.norm(a[:, :3, 3] * s - R[:, :3, 3], axis=-1)

    world = program["points"].astype(np.float64)
    in_camera = np.einsum("nji,nkj->nki", P[:, :3, :3], world - P[:, None, :3, 3])
    nums = {
        "local_points_rel": _rel(program["local_points"], reference["local_points"]),
        "conf_rel": _rel(program["conf"], reference["conf"]),
        "points_rel": _rel(in_camera, reference["local_points"]),
        "rotation_probe_ratio": _probe_ratio(rot(P), rot(Q)),
        "translation_probe_ratio": _probe_ratio(trans(P), trans(Q, scale)),
    }
    if reference.get("moge") is not None:
        a, b = program["moge"], reference["moge"]
        for key in ("points", "mask", "metric_scale"):  # no MoGe output: a fault
            name = "moge_scale_rel" if key == "metric_scale" else f"moge_{key}_rel"
            nums[name] = float("inf") if a is None else _rel(a[key], b[key])
    return nums
