"""``tests/test_torch_dryrun.py``'s record checks on a fake world of 2 x 2
x 2 ranks, the multi-pod mesh's axes ("pod", "data", "model"): every smoke
config at every shape (cut small, 8 rows: two a data shard; one a data
shard is ``tests/test_torch_dryrun_row.py``'s) gives the reference's keys,
``ok`` and ``skip`` where the reference's ``skip_reason`` says."""

import pytest

from test_torch_dryrun import check_keys, check_status, run_worlds

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_worlds(MESHES, [], tmp_path_factory.mktemp("dryrun_pod"))


def test_records_keep_the_reference_keys(records):
    check_keys(records["2x2x2"], 8)


def test_ok_and_skip_follow_the_reference(records):
    check_status(records["2x2x2"])
