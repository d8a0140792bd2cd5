"""On the card only (skipped here): every cell of ``BENCHMARK.json`` at its
own size, a sound run correct and the control not.  Run on the card with
``PYTHONPATH=src python -m pytest -q portbench/tests/test_portbench_card.py``."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run at their full widths")


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_and_its_control_is_not(card, cell):
    sound, err, _ = harness.run(tiny.ROOT, cell, 2 ** 31 + 99, 5.0, False)
    assert sound["correct"], err
    ctl, err, _ = harness.run(tiny.ROOT, cell, 2 ** 31 + 99, 5.0, False, control=True)
    assert not ctl["correct"], err
