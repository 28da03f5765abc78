"""The control (control.Control: the reference with TF32 products in the
program's place) comes out not correct against each cell's limits: on
the CPU in the shrunk cells, and, on a card, at the cells' own sizes."""

import pytest
import torch

from gpbench import harness
from gpbench.control import Control

from .shared import ROOT, STREAM_MIN_N, SMALL, small


def _control_run(monkeypatch, workload, device, overrides, seconds):
    from gp_tpu_torch.models import exact
    if workload.startswith("stream") and device == "cpu":
        monkeypatch.setattr(exact, "_STREAM_MIN_N", STREAM_MIN_N)
    return harness.run(ROOT, workload, 31, seconds, False, device,
                       program=Control, overrides=overrides)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct_on_the_cpu(monkeypatch, workload):
    line = _control_run(monkeypatch, workload, "cpu", small(workload), 0.3)
    assert line["attempted"] > 0 and not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct_at_the_cells_size(monkeypatch, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = _control_run(monkeypatch, workload, "cuda", None, 3.0)
    assert line["attempted"] > 0 and not line["correct"], line["checks"]
