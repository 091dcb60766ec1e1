"""Each cell on the card, as the benchmark's command runs it, with a short
window: the result line parses and ``correct`` is true.  Marked
``cuda``: ``python -m pytest -q -m cuda perfbench/tests`` on a machine
with an NVIDIA GPU."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SERVE, TRAIN

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(card, cell, trace):
    done = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "5", "--trace", trace], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
