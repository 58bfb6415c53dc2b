"""On the card: each cell's control comes out as not correct, and the same
cell run soundly as correct, at the cell's own size with a short window.

The control is the program with its TF32 path switched on
(`torch.backends.cuda.matmul.allow_tf32`, `cudnn.allow_tf32`): the program
computes in float32 with TF32 off, and TF32 is the nearest precision below.

    python -m pytest perfbench/tests/test_perfbench_control.py -q -m cuda
"""
import time

import pytest

from perfbench.harness import driver, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda_device):
    sound, _ = driver.run(cell, 20261017, 8.0, False, time.perf_counter())
    assert sound["correct"], sound["checks"]
    control, numbers = driver.run(cell, 20261017, 8.0, False, time.perf_counter(), control="tf32")
    assert not control["correct"], (control["checks"], numbers)
