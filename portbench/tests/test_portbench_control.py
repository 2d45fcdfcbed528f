"""The control (the reference one width down, in the program's place)
comes out not correct, on every cell, at a size a test run holds."""

import pytest
import torch

from conftest import SMALL, SMALL_MIX
from portbench.control import control_run


@pytest.mark.parametrize("workload", sorted(SMALL_MIX))
@pytest.mark.parametrize("seed", [3, 2**31 + 99])
def test_the_control_is_not_correct(workload, seed):
    checks = control_run(workload, seed, torch.device("cpu"), sizes=SMALL,
                         mix_keys=SMALL_MIX[workload])
    assert checks["genome_sets_wrong"]["value"] > 0
    assert checks["answers_wrong"]["value"] > 0
    assert any(c["value"] > c["limit"] for c in checks.values())
    assert checks["kinds_unchecked"]["value"] == 0
