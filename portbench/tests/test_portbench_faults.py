"""The whole harness at a tiny size on the CPU, past its look for a chip: a
sound run comes out correct, and each fault the offline cells can have,
planted under the timed path, comes out not correct."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def _altered_answer(creator):
    """A frame's world points altered where the step produces them."""
    step = creator._step

    def broken(images, kps, cand=None):
        out = step(images, kps, cand)
        out["points_kp"] = out["points_kp"].clone()
        out["points_kp"][0] = 0.0  # the first frame's answers zeroed
        return out

    creator._step = broken


def _half_batch(creator):
    """Half of a chunk's frames left out: the model sees the first half and
    its outputs stand in for the rest."""
    step = creator._step

    def broken(images, kps, cand=None):
        n = images.shape[0] // 2
        out = step(images[:n], kps[:n], cand)
        reps = -(-images.shape[0] // n)
        return {k: (torch.cat([v] * reps)[: images.shape[0]]
                    if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == n else v)
                for k, v in out.items()}

    creator._step = broken


def _run(hook=None, workload="pi3-offline-7scenes", config="pi3-moge2", traced=False):
    return harness.run_cell(workload, 2**31 + 11, 1.0, traced, device="cpu", bench=tiny.bench(),
                            config=tiny.config(config), traffic=tiny.traffic(), hook=hook)


@pytest.mark.parametrize("workload,config", [("pi3-offline-7scenes", "pi3-moge2"),
                                             ("pi3kv2-offline-7scenes", "pi3-kvmerge2")])
def test_a_sound_run_is_correct(tmpdir_env, workload, config):
    r = _run(workload=workload, config=config)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"offline_fps", "setup_s"}
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())


@pytest.mark.parametrize("workload,config", [("pi3-offline-7scenes", "pi3-moge2"),
                                             ("pi3kv2-offline-7scenes", "pi3-kvmerge2")])
def test_a_traced_run_reports_the_per_layer_metrics(tmpdir_env, workload, config):
    r = _run(workload=workload, config=config, traced=True)
    assert r["correct"]
    assert {"outside_step_share.offline", "mfu.offline"} <= set(r["metrics"])
    assert "offline_fps" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch])
def test_a_fault_under_the_timed_path_is_not_correct(tmpdir_env, fault):
    r = _run(fault)
    assert not r["correct"] and r["failed"] == 1
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
