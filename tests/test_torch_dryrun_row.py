"""Every smoke config's train step on a fake world of 2 x 2 x 2 ranks
("pod", "data", "model") with one row a data shard (4 rows): a norm that
reads a sublayer's output (gemma2-2b's post-norms, hymba-1.5b's mix) once
handed the product's gradient back split over the sequence on "model" as
well, and DTensor's product rule refused it
(``models/transformer._residual``).  Each train cell is ``ok`` where the
reference's ``skip_reason`` gives none, with the reference's keys."""

import pytest

from repro.configs import list_archs as jlist_archs
from repro.configs import skip_reason as jskip_reason
from test_torch_dryrun import SMALL, check_keys, run_worlds

#: train cells only, one row a data shard
ONE_ROW = {"train": (SMALL["train"][0], 4)}


ARCHS = jlist_archs()
#: three worlds side by side: hymba-1.5b (whose SSD chunk loop and
#: attention trace longest) alone, half the rest each
_REST = [a for a in ARCHS if a != "hymba-1.5b"]
HALVES = {"row0": ["hymba-1.5b"], "row1": _REST[0::2], "row2": _REST[1::2]}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    recs = run_worlds(
        {tag: ((2, 2, 2), ("pod", "data", "model")) for tag in HALVES}, [],
        tmp_path_factory.mktemp("dryrun_row"),
        small={tag: dict(ONE_ROW, archs=archs)
               for tag, archs in HALVES.items()})
    return [r for tag in HALVES for r in recs[tag]]


def test_records_keep_the_reference_keys(records):
    check_keys(records, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_traces_at_one_row_a_data_shard(records, arch):
    (rec,) = [r for r in records if r["arch"] == arch]
    assert jskip_reason(arch, rec["shape"]) is None
    assert rec["status"] == "ok", rec.get("error")
