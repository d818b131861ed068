"""The control at a size a test run holds: the plain reference put in the
program's place in the next precision below the configuration's (the trunk's
products on float8 e4m3 operands, the fp32 parts in TF32) is not correct
against the cell's limits, where the program (the port, here in float32 on
its plain CPU versions) is. On the card at the cell's own size
``calibrate.py --control-seeds`` reads the same comparison."""

import numpy as np
import pytest
import torch

from portbench import frames, manifest
from portbench.families import pi3 as family
from portbench.reference.pi3 import Precision
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload,config", [("pi3-offline-7scenes", "pi3-moge2"),
                                             ("pi3kv2-offline-7scenes", "pi3-kvmerge2")])
def test_the_control_is_not_correct(tmp_path, workload, config):
    cfg, tr = tiny.config(config), tiny.traffic()
    limits = manifest.limits(workload)
    paths = frames.make_frames(str(tmp_path), tr["chunk_length"], tr["frame_height"],
                               tr["frame_width"])
    seed = 2**31 + 99
    ref = family.reference_chunk(cfg, tr, seed, paths, CPU)
    control = family.reference_chunk(cfg, tr, seed, paths, CPU, Precision(fp8=True))
    numbers = family.compare(control, ref)
    assert set(limits) <= set(numbers)
    over = {k: numbers[k] for k in limits if not numbers[k] <= limits[k]}
    assert over, numbers
    # the same reference, the same precision: every number 0 but the world
    # points taken back into the camera (float32 rounding of the composition)
    same = family.compare(ref, family.reference_chunk(cfg, tr, seed, paths, CPU))
    assert same.pop("points_rel") < 1e-6
    assert all(v == 0 for v in same.values()), same
    assert np.isfinite(list(numbers.values())).all()
