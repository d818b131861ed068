"""The manifest and the files it names, found by name."""

import dataclasses
import glob
import json
import os

import pytest

from portbench import manifest

BENCH = manifest.load_benchmark()


def test_manifest_has_the_contract_keys_and_nothing_else():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_and_unit_has_only_the_allowed_characters():
    assert manifest.check_names(BENCH) == []
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16 and " " not in m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, ".a", "µs"])
def test_the_name_rule_refuses(bad):
    assert not manifest.NAME_RE.match(bad)


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(w):
    cell = manifest.workload(BENCH, w)
    cfg = manifest.config(cell["config"])
    assert cfg["name"] == cell["config"]
    tr = manifest.traffic(cell["traffic"])
    assert tr["entry"] in ("offline",)
    limits = manifest.limits(w)
    assert all(v >= 0 for v in limits.values())
    manifest.family(cfg["family"])
    for trace in (False, True):
        for m in manifest.cell_metrics(BENCH, w, trace):
            mod = manifest.metric_module(m["name"])
            assert mod.NAME == m["name"] and mod.UNIT == m["unit"]
            if trace:
                assert mod.LAYER == m["layer"]


def test_every_config_file_is_its_configuration_as_run():
    from pi3_slam_tpu_torch.models.convert import moge_vits_config
    from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config

    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert manifest.config(c["name"])["reduced"] == c["reduced"]
    for path in glob.glob(os.path.join(manifest.HERE, "configs", "*.json")):
        cfg = manifest.config(os.path.basename(path)[:-5])
        assert cfg["reduced"] == []
        fields = dict(cfg["model"])
        enc = DinoV2Config(**fields.pop("encoder"))
        published = Pi3Config()
        # nothing cut: every width and depth as published, kv-merge the option
        assert enc == published.encoder
        assert dataclasses.replace(Pi3Config(encoder=enc, **fields),
                                   global_kv_merge=1) == published
        if cfg["metric_depth"] is not None:
            program = json.loads(moge_vits_config().to_json())
            assert {k: v for k, v in cfg["metric_depth"].items() if k != "encoder"} == program
            enc = cfg["metric_depth"]["encoder"]
            assert (enc["embed_dim"], enc["depth"], enc["num_heads"]) == (384, 12, 6)


def test_a_roofline_metric_has_kernels_listed_for_its_operation():
    for path in glob.glob(os.path.join(manifest.HERE, "metrics", "*_roofline.py")):
        op = os.path.basename(path)[: -len("_roofline.py")]
        specs = manifest.kernel_specs(op)
        assert specs and all("name" in s for s in specs)


def test_the_command_names_only_files_under_paths():
    cmd = BENCH["command"]
    assert cmd[0] == "python3" and cmd[1].startswith("portbench/")
    assert os.path.exists(os.path.join(manifest.ROOT, cmd[1]))
