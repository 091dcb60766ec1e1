"""``correct`` has to come out false: each fault a cell can have, planted
under a whole run of the harness (its look for a card skipped), and the
control (the reference at the precision below the configuration's, in
the program's place), both at the small sizes, held to the cell's own
limits."""

import pytest

from conftest import SERVE, TRAIN



@pytest.mark.parametrize("cell,fault", [
    (TRAIN, "state_unchanged"), (TRAIN, "half_batch"),
    (SERVE, "token_altered")])
def test_a_planted_fault_is_not_correct(small, cell, fault):
    from harness import faults
    from harness.run import run_cell
    with faults.plant(fault):
        out = run_cell(small(cell), cell, 2**31 + 11, 0.1, False, device="cpu")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**32 + 17])
def test_the_training_control_is_not_correct(small, seed):
    """AdamW steps of the reference in fp8 against the f32 reference's,
    on the batches and weights a run of the cell gives."""
    from harness import check
    from harness.entries import run_train
    bench = small(TRAIN, "bfloat16")
    cell = bench.cell(TRAIN)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    run = run_train(cfg, mix, seed, 0.0, False, "cpu", 0.0)
    args = (cfg["model"], mix["optimizer"], seed, run.check["batches"],
            "cpu")
    nums = check.train_numbers(check.train_reference(*args, "float8"),
                               check.train_reference(*args))
    correct, _ = check.judge(nums, bench.limits(TRAIN))
    assert not correct, nums


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**32 + 17])
def test_the_serving_control_is_not_correct(small, seed):
    """The tokens the reference in fp8 puts first, on the prompts and
    served tokens of a run of the cell, against the f32 reference.  The
    small model takes 16 layers and 4,096 ids here: at 4 layers and 64
    ids fp8's rounding moves few logits past a neighbour."""
    from harness import check
    from harness.entries import run_generate
    bench = small(SERVE, "bfloat16")
    cell = bench.cell(SERVE)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    cfg = dict(cfg, model=dict(cfg["model"], vocab=4096, n_layers=16,
                               program=[["hyb_full", 1], ["hyb_swa", 14],
                                        ["hyb_full", 1]]))
    run = run_generate(cfg, mix, seed, 0.3, False, "cpu", 0.0)
    sample = check.serve_sample(run.check["served"], seed,
                                mix["check"]["requests"])
    nums = check.serve_numbers(cfg["model"], seed, sample,
                               mix["check"]["rows"], "cpu", "float8")
    correct, _ = check.judge(nums, bench.limits(SERVE))
    assert not correct, nums
