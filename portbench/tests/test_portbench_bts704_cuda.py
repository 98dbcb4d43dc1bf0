"""On the card: the control fails train.bts704's comparison and a sound
run passes it, at the cell's own size (BTS, DenseNet-161, 352x704, batch
4), as test_portbench_control_cuda.py holds the other cells.

The control is the program's own path in bf16 autocast, where the
configuration states fp32 with cuDNN's TF32 (calibrate.readings, a short
window at the cell's own load). Marked `cuda`; without a card each test
skips.

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

from __future__ import annotations

import pytest
import torch

from portbench.calibrate import readings

CELL = "train.bts704"
CONTROL_SEEDS = (4000000007, 4000000009, 4000000013)
SOUND_SEED = 4000000021


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
def test_the_control_fails_the_comparison():
    _card()
    records = list(readings(CELL, CONTROL_SEEDS, True, 1.0))
    assert [r["correct"] for r in records] == [False] * len(CONTROL_SEEDS), records


@pytest.mark.cuda
def test_a_sound_run_passes_the_comparison():
    _card()
    records = list(readings(CELL, (SOUND_SEED,), False, 1.0))
    assert records[0]["correct"], records
