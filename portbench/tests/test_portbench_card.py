"""On the card: each cell's control fails the check and the program as it
is passes it, at the cell's own sizes (set-up, the checked steps and the
reference, no window), for every cell of ``BENCHMARK.json``.  Run on a
machine with a card:

    python -m pytest portbench/tests -m cuda
"""

import json
import os

import pytest
import torch

from portbench import faults, harness, spec

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


def _correct(cell, seed, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = spec.Cell(REPO, cell)
    mutate, extra = faults.variant(variant)
    try:
        r = harness.run_cell(c, seed, 0, False, torch.device("cuda", 0),
                             0.0, mutate=mutate, extra_argv=extra,
                             window=False)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return r["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2147483659, 1234567891, 3000000019])
def test_the_control_fails(cell, seed):
    assert _correct(cell, seed, "tf32") is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes(cell):
    assert _correct(cell, 2147483693, "program") is True
