"""The controls on the card, at each cell's own size: the plain reference
put in the program's place in the nearest precision below the
configuration's must fail one of the cell's compared numbers. Run on a
machine with the card: ``python -m pytest benchmark/tests -m cuda``."""

import types

import pytest
import torch

import control
from harness import core


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist "
                    "only there")
    return torch.device("cuda", 0)


def _fails(values, limits):
    return any(values[k] > limits[k] for k in values if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dtu-train", "bmvs-mesh"])
def test_control_fails_at_the_cells_size(name):
    device = _card()
    core.set_cache_dirs()
    cell = core.Cell(name)
    args = types.SimpleNamespace(program=False, f32_program=False,
                                 control=True, witness=False, faults=False,
                                 scenes=1, window=3.0)
    readings = (control.train_readings if cell.traffic["loop"] == "train"
                else control.mesh_readings)
    got = dict(readings(cell, cell.loop(), 2 ** 33 + 17, device, args))
    assert _fails(got["control"], cell.limits), got
