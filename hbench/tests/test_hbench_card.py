"""On the card: each cell, run at its own size, is correct, and its control
is not. They skip without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from hbench import run

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _last_line(script: str, cell: str, seed: int) -> tuple[int, dict]:
    proc = subprocess.run([sys.executable, f"hbench/{script}", "--workload", cell, "--seed",
                           str(seed), "--seconds", "3"], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=900)
    return proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_card(card, cell):
    code, result = _last_line("run.py", cell, 3141592653)
    assert code == 0 and result["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_refused_on_card(card, cell):
    code, result = _last_line("control.py", cell, 2718281828)
    assert code == 0 and result["correct"] is False
