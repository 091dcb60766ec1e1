"""The rest of ``tests/test_torch_op_mesh_parity.py``'s archs: each smoke
config's per-device train-step flops on meshes (1, 2) and (2, 2) against
the reference's on 2 and 4 host devices, equal but for the pinned
gaps."""

import pytest

from repro.configs import list_archs
from test_torch_op_mesh_parity import ARCHS, MESHES, check, per_device_flops

REST = [a for a in list_archs() if a not in ARCHS]


@pytest.fixture(scope="module")
def flops(tmp_path_factory):
    return per_device_flops(REST, tmp_path_factory.mktemp("mesh_flops"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", REST)
def test_per_device_flops_equal_the_reference(flops, arch, mesh):
    check(flops, arch, mesh)
