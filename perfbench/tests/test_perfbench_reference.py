"""The plain reference against the port at small sizes on the CPU, both
in f32: served logits (the prefill's last and a decode step's from the
cache), the training loss and its gradients, and whole runs of each cell
through the harness."""

import pytest
import torch

from conftest import SERVE, SMALL, TRAIN



def _model(bench, cell):
    m = bench.config(bench.cell(cell)["config"])["model"]
    return dict(m, **SMALL[cell]["model"])


@pytest.fixture
def f32():
    from repro_torch.models import layers
    saved, layers._COMPUTE = layers._COMPUTE, torch.float32
    yield
    layers._COMPUTE = saved


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_served_logits_prefill_and_decode(bench, f32, cell):
    from harness import weights
    from harness.entries import model_config
    from reference import lm
    from repro_torch.models import LM
    m = _model(bench, cell)
    if m["moe"] is not None:
        # no (token, choice) dropped: a dropped pair depends on the batch,
        # which differs between the prefill, the decode step and the
        # reference's one pass
        m["moe"] = dict(m["moe"], capacity_factor=8.0)
    params = weights.make(m, 5, "cpu")
    model = LM(model_config(m), device="cpu")
    tok = torch.randint(0, m["vocab"], (2, 49), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        got, cache = model.prefill(params, {"tokens": tok[:, :48]},
                                   cache_len=49)
        nxt, _ = model.decode_step(params, cache, tok[:, 48:], 48)
    want = lm.logits_at(params, m, tok, [47, 48])
    scale = want.abs().max()
    assert (got[:, 0] - want[:, 0]).abs().max() / scale < 1e-5
    # the cache keeps k, v and the convolution's window in bf16 whatever
    # the compute dtype: the decode step reads them rounded (2^-8)
    assert (nxt[:, 0] - want[:, 1]).abs().max() / scale < 1e-2


def test_training_loss_and_gradients(bench, f32):
    from harness import weights
    from harness.entries import model_config
    from reference import lm
    from reference.params import flatten
    from repro_torch.models import LM
    from repro_torch.train.trainer import value_and_grad
    m = _model(bench, TRAIN)
    model = LM(model_config(m), device="cpu")
    ids = torch.randint(0, m["vocab"], (2, 65),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    params = weights.make(m, 9, "cpu")
    loss, _, grads = value_and_grad(model, params, batch)
    ref = weights.make(m, 9, "cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten(ref)]
    want, _ = lm.loss(ref, m, batch["tokens"], batch["labels"])
    want.backward()
    want = float(want.detach())
    assert abs(float(loss) - want) < 1e-5 * abs(want)
    for (name, g), r in zip(flatten(grads), leaves):
        assert (g - r.grad).abs().max() <= 1e-4 * r.grad.abs().max() + 1e-9, \
            name


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_cell_runs_correct_at_small_size(small, cell):
    from harness.run import run_cell
    out = run_cell(small(cell), cell, 2**31 + 7, 0.2, True, device="cpu")
    assert out["correct"] and out["failed"] == 0
    # both sides in f32: gaps of norms at rounding; an entry's change can
    # differ where AdamW divides a gradient near zero by its own size
    for name, c in out["checks"].items():
        assert c["value"] < (1e-3 if "diff" in name else 1e-4), (name, c)
