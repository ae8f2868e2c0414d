"""On the card, at each cell's own size: the program reads inside every
limit of its cell and the control (the reference in fp8 in the program's
place) outside one. Marked ``cuda``; skips without a card. Run on the
card as ``python3 -m pytest benchmark/tests/test_bench_card.py -q``."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import calibrate  # noqa: E402
from benchmark.lib import harness  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("cell", harness.cells())
def test_program_passes_and_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = harness.cell(cell)[0]["check"]
    program, control = calibrate.readings(cell, seeds=[2**31 + 5],
                                          controls=[2**31 + 6])
    assert all(program["numbers"][k] <= v for k, v in limits.items()), \
        program
    assert any(control["numbers"][k] > v for k, v in limits.items()), \
        control
