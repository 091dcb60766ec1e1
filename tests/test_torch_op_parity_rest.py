"""The rest of ``tests/test_torch_op_parity.py``'s archs: each smoke
config's forward and train-step flops, counted by the port's
``analyze_ops``, against the reference's ``analyze_hlo``."""

import pytest

from repro.configs import list_archs
from test_torch_op_parity import ARCHS, check_flops


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a not in ARCHS])
def test_flops_equal_the_reference_hlo_count(arch):
    check_flops(arch)
