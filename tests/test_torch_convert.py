"""The port's checkpoint converters against the JAX package's on the CPU:
``models/convert.py`` (Pi3 and MoGe-2 reference state dicts -> the JAX
layout), ``io/safetensors.py`` and ``tools/convert_checkpoint.py``.

Reference-named state dicts are made from random trees with the inverse key
maps of ``chip_smoke.py`` (which phase 8 drives at full width on the card).
The converters only move, transpose and stack values, so every comparison is
exact (``np.array_equal``). The converters take the reference's five head
blocks, so the tiny Pi3 here is ``TINY`` with ``head_depth`` 5; the CLI
converts the reference depths (24 encoder, 36 decoder blocks), so its tests
use a narrow model of those depths.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import convert_checkpoint as jax_tool  # noqa: E402
from test_moge_parity import MODEL_CONFIG  # noqa: E402
from test_pi3_model import TINY, make_tiny_params  # noqa: E402

from pi3_slam_tpu.models import convert as jconv  # noqa: E402
from pi3_slam_tpu_torch.io.safetensors import read_safetensors  # noqa: E402
from pi3_slam_tpu_torch.models import convert as tconv  # noqa: E402
from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config  # noqa: E402
from pi3_slam_tpu_torch.models.pi3 import Pi3Config  # noqa: E402
from pi3_slam_tpu_torch.tools import convert_checkpoint as tool  # noqa: E402

PORT_TINY = Pi3Config.from_json(TINY.to_json())
TINY5 = dataclasses.replace(PORT_TINY, head_depth=5)
NARROW = Pi3Config(encoder=DinoV2Config(embed_dim=32, depth=24, num_heads=2), dec_embed_dim=32,
                   dec_num_heads=2, dec_depth=36, head_dim=32, head_depth=5, head_num_heads=2,
                   camera_dim=16)


def same_tree(got, want):
    chip_smoke.same_tree("converted tree", got, want)


def moge_tree():
    return tconv.init_moge_params(0, tconv.moge_config_from_model_config(MODEL_CONFIG))


def test_pi3_converter_matches_jax():
    tree = tconv.init_pi3_params(0, TINY5)
    sd = chip_smoke.reference_pi3_state_dict(tree)
    got = tconv.convert_pi3_state_dict(sd, encoder_depth=2, dec_depth=4)
    same_tree(got, jconv.convert_pi3_state_dict(sd, encoder_depth=2, dec_depth=4))
    same_tree(got, tree)


def test_pi3_checkpoint_files_are_the_same(tmp_path):
    """Both packages' save_pi3_checkpoint write the same leaves and config
    JSON, and each package's loader reads the other's file."""
    from pi3_slam_tpu.models import Pi3Config as JaxPi3Config

    tree = tconv.init_pi3_params(0, TINY5)
    tconv.save_pi3_checkpoint(str(tmp_path / "port.npz"), tree, TINY5)
    jconv.save_pi3_checkpoint(str(tmp_path / "jax.npz"), tree, JaxPi3Config.from_json(TINY5.to_json()))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    params, cfg = jconv.load_pi3_checkpoint(str(tmp_path / "port.npz"))
    assert cfg.to_json() == TINY5.to_json()
    same_tree(params, tree)
    params, cfg = tconv.load_pi3_checkpoint(str(tmp_path / "jax.npz"))
    assert cfg == TINY5
    same_tree(params, tree)


def test_moge_converter_matches_jax():
    tree = moge_tree()
    sd, model_config = chip_smoke.reference_moge_checkpoint(tree)
    got = tconv.convert_moge_state_dict(sd, model_config)
    same_tree(got, jconv.convert_moge_state_dict(sd, model_config))
    same_tree(got, tree)
    # the reference's own model_config (lists, a dict encoder) reads the same
    assert (tconv.moge_config_from_model_config(MODEL_CONFIG).to_json()
            == jconv.moge_config_from_model_config(MODEL_CONFIG).to_json()
            == str(tree["_config_json"]))


CONFIG_MISMATCHES = [
    ("embed_dim", None),  # the full-size default against the tiny tree
    ("dec_depth", {"dec_depth": TINY.dec_depth + 2}),
    ("head_dim", {"head_dim": TINY.head_dim * 2}),
    ("camera_dim", {"camera_dim": TINY.camera_dim * 2}),
    ("num_register_tokens", {"num_register_tokens": TINY.num_register_tokens + 1}),
    ("encoder.depth", {"encoder": dataclasses.replace(PORT_TINY.encoder, depth=3)}),
]


@pytest.mark.parametrize("field,change", CONFIG_MISMATCHES, ids=[c[0] for c in CONFIG_MISMATCHES])
def test_check_pi3_config_raises_where_the_jax_one_does(field, change):
    from pi3_slam_tpu.models import Pi3Config as JaxPi3Config

    params = make_tiny_params()
    tconv.check_pi3_config(params, PORT_TINY)  # the matching config passes
    cfg = Pi3Config() if change is None else dataclasses.replace(PORT_TINY, **change)
    with pytest.raises(ValueError, match=field) as ours:
        tconv.check_pi3_config(params, cfg)
    with pytest.raises(ValueError) as theirs:
        jconv.check_pi3_config(params, JaxPi3Config.from_json(cfg.to_json()))
    assert str(ours.value) == str(theirs.value)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


def test_cli_options_match_the_jax_tool(monkeypatch):
    """The JAX tool builds its parser inside main(): catch it at parse_args."""

    class Caught(Exception):
        pass

    def catch(parser, *args, **kwargs):
        raise Caught(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as jax_parser:
        jax_tool.main([])
    monkeypatch.undo()
    assert _flags(tool.build_parser()) == _flags(jax_parser.value.args[0])


def _narrow_files(tmp_path):
    tree = tconv.init_pi3_params(0, NARROW)
    cfg_path = tmp_path / "narrow.json"
    cfg_path.write_text(NARROW.to_json())
    return tree, chip_smoke.reference_pi3_state_dict(tree), str(cfg_path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_cli_converts_a_safetensors_file(tmp_path, capsys, dtype):
    """A model.safetensors written by the safetensors package: the port's
    .npz loads in the JAX package and holds the JAX converter's tree of the
    same (widened) values, with the given config embedded."""
    from safetensors.torch import save_file

    tree, sd, cfg_path = _narrow_files(tmp_path)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()}
    save_file(tensors, str(tmp_path / "model.safetensors"))
    out = str(tmp_path / "pi3.npz")
    assert tool.main(["--model", "pi3", "--input", str(tmp_path / "model.safetensors"),
                      "--output", out, "--pi3-config", cfg_path]) == 0
    assert "peak resident memory" in capsys.readouterr().out
    params, cfg = jconv.load_pi3_checkpoint(out)
    assert cfg.to_json() == NARROW.to_json()
    widened = {k: v.float().numpy() for k, v in tensors.items()}
    same_tree(params, jconv.convert_pi3_state_dict(widened))
    if dtype == torch.float32:
        same_tree(params, tree)


@pytest.mark.parametrize("model", ["pi3", "moge"])
def test_cli_converts_a_torch_file(tmp_path, model):
    """A Pi3 state dict saved by torch.save, and a MoGe-2 model.pt with
    'model' and 'model_config': the .npz loads in the JAX package."""
    if model == "pi3":
        tree, sd, cfg_path = _narrow_files(tmp_path)
        extra = ["--pi3-config", cfg_path]
        payload = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    else:
        tree = moge_tree()
        sd, model_config = chip_smoke.reference_moge_checkpoint(tree)
        extra = []
        payload = {"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   "model_config": model_config}
    torch.save(payload, tmp_path / "model.pt")
    out = str(tmp_path / "out.npz")
    assert tool.main(["--model", model, "--input", str(tmp_path / "model.pt"), "--output", out,
                      *extra]) == 0
    params = jconv.load_params_npz(out)
    if model == "pi3":
        assert str(params.pop("_pi3_config_json")) == NARROW.to_json()
    same_tree(params, tree)


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    """Exit 2, naming why: a path that is not a file (the JAX tool would
    resolve it as a hub id). A MoGe v1 checkpoint converts
    (tests/test_torch_moge_v1.py)."""
    cases = [(["--model", "pi3", "--input", "yyfz233/Pi3"], "local checkpoint files only"),
             (["--model", "moge", "--input", str(tmp_path / "missing.pt")],
              "local checkpoint files only")]
    for argv, message in cases:
        with pytest.raises(SystemExit) as e:
            tool.main(argv + ["--output", str(tmp_path / "out.npz")])
        assert e.value.code == 2, argv
        assert message in capsys.readouterr().err
    assert not (tmp_path / "out.npz").exists()


def test_safetensors_reader_against_the_package(tmp_path):
    """F32, F16 and BF16 tensors (and an empty one) read as float32, equal to
    the safetensors package's values widened; another dtype raises naming
    it; chip_smoke.py's writer writes what the package reads."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    tensors = {"f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
               "f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
               "bf16": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32)).bfloat16(),
               "empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = read_safetensors(str(tmp_path / "a.safetensors"))
    assert got.keys() == tensors.keys()
    for name, t in tensors.items():
        assert got[name].dtype == np.float32 and np.array_equal(got[name], t.float().numpy()), name

    save_file({"i": torch.zeros(2, dtype=torch.int64)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(str(tmp_path / "b.safetensors"))

    arrays = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": np.arange(5, dtype=np.float32)}
    arrays["t"] = arrays["a"].T  # a transposed view is written in C order
    chip_smoke.write_safetensors(str(tmp_path / "c.safetensors"), arrays)
    for reader in (load_file, read_safetensors):
        back = reader(str(tmp_path / "c.safetensors"))
        for name, a in arrays.items():
            assert np.array_equal(back[name], a), name
