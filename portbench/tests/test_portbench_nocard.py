"""The measurement path refuses to run without a card: no CPU fallback, no
result line."""

import pytest
import torch

from portbench import run


def test_run_exits_2_without_a_card_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "pi3-offline-7scenes", "--seed", str(2**31 + 3),
                     "--seconds", "10", "--trace", "0"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_run_exits_2_with_fewer_cards_than_the_cell_asks(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "pi3-offline-7scenes", "--seed", "1", "--seconds", "10",
                     "--trace", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_an_unknown_workload_raises():
    with pytest.raises(KeyError):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])


def test_the_seed_takes_more_than_32_bits():
    assert run.parse(["--workload", "w", "--seed", str(2**31 + 12345), "--seconds", "10",
                      "--trace", "1"]).seed == 2**31 + 12345
