"""The harness's CPU tests run the port at a tiny size on one intra-op thread
(several test processes share the machine)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """A TMPDIR of the test's own, as the driver gives each run one."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")
