"""On the card (marker ``cuda``; skips where there is none): each cell at a
small size is correct, and its correctness control is not, on three
seeds. ``python -m pytest -q -m cuda portbench/tests/test_portbench_card.py``
from the repository's root."""

import pytest
import torch

from portbench.tests.cells_small import run_small

CELLS = ["grafp-t.build", "nafp.build", "grafp-t.train", "grafp-t.search"]
SEEDS = [11, 2 ** 31 + 7, 987654321987]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_cell_is_correct_and_its_control_is_not(card, cell, seed):
    result, checks = run_small(cell, card, seed=seed)
    assert result["correct"] is True, checks
    result, checks = run_small(cell, card, seed=seed, control=True)
    assert result["correct"] is False, checks
