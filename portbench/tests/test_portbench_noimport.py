"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names; the reference imports nothing of the program."""

import ast
import glob
import os

import pytest

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("modules,found", [
    (["pi3_slam_tpu_torch", "pi3_slam_tpu_torch.ops", "numpy"], []),
    (["pi3_slam_tpu.models"], ["pi3_slam_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "pi3_slam_tpu_torchx"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "numpy", "torch", "PIL", "cv2"}, path
