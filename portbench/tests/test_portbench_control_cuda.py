"""On the card: the control fails each cell's comparison, and sound runs
pass it, at the cells' own sizes.

The control is the program's own path in the precision below the
configuration's (bf16 autocast, where the configuration states fp32 with
cuDNN's TF32): calibrate.readings runs it on three seeds a cell with a
short window at the cell's own load. Marked `cuda`; without a card each
test skips.

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

from __future__ import annotations

import pytest
import torch

from portbench.calibrate import readings

CELLS = ("train.r18_1280", "serve.bts1216", "serve.bts1216_rig2")
CONTROL_SEEDS = (4000000007, 4000000009, 4000000013)
SOUND_SEED = 4000000021


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    _card()
    records = list(readings(name, CONTROL_SEEDS, True, 1.0))
    assert [r["correct"] for r in records] == [False] * len(CONTROL_SEEDS), records


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_passes_the_comparison(name):
    _card()
    records = list(readings(name, (SOUND_SEED,), False, 1.0))
    assert records[0]["correct"], records
