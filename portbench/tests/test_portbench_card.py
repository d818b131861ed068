"""On the card: the weights drawn from a seed repeat bit for bit, so the
reference draws the program's weights again after the window."""

import pytest
import torch

from portbench.families import pi3 as family
from portbench.tests import tiny


@pytest.mark.cuda
def test_the_draw_on_the_card_repeats_and_follows_the_seed(cuda_card):
    cfg = tiny.config(compute_dtype="bfloat16")
    a = family._pi3_state(cfg, 2**31 + 7, cuda_card)
    b = family._pi3_state(cfg, 2**31 + 7, cuda_card, torch.float32)
    c = family._pi3_state(cfg, 2**31 + 8, cuda_card)
    assert all(v.device.type == "cuda" and v.dtype == torch.bfloat16 for v in a.values())
    assert all(torch.equal(a[k].float(), b[k]) for k in a)
    assert not torch.equal(a["decoder.0.fc1.weight"], c["decoder.0.fc1.weight"])
