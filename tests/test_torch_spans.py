"""The port's profiler spans (``repro_torch/spans.py``) on the CPU: with no
profiler they add no autograd node and enter no span, and the numbers are
bit-equal either way; under one, the MoE block's parts, the SSD scan,
AdamW, remat's recompute and the serving engine's prefill and decode
steps are host events that nest on every thread, with the backward of a
region inside its span and each layer's recompute outside every region's
backward span."""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models.moe import MoEDims
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import ModelConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import OptimizerConfig, adamw_init, make_train_step
from repro_torch.train.trainer import value_and_grad

MOE_SPANS = ("repro_torch.moe", "repro_torch.moe.route",
             "repro_torch.moe.positions", "repro_torch.moe.dispatch",
             "repro_torch.moe.experts", "repro_torch.moe.combine")
#: the markers' own events, the only host events a backward span may
#: overlap partly (it opens inside one marker's backward, closes inside
#: the other's)
MARKERS = ("_OutputsBackward", "_InputsBackward")
OPENS = "autograd::engine::evaluate_function: _OutputsBackward"
STEPS = 2


def _moe_cfg() -> ModelConfig:
    """deepseek-moe-16b's layer kinds at smoke widths: a dense layer, then
    a stacked MoE segment (stacked, so ``remat="dots"`` checkpoints it)."""
    return ModelConfig(
        name="moe-spans", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv=4, head_dim=16, d_ff=96, vocab=64,
        program=(("attn", 1), ("moe", 2)),
        moe=MoEDims(d_model=64, d_ff=32, n_experts=8, top_k=3, n_shared=2,
                    renorm_topk=False),
        tie_embed=False, remat="dots", q_chunk=16, loss_chunk=16)


def _hybrid_cfg() -> ModelConfig:
    return dataclasses.replace(get_smoke_config("hymba-1.5b"), remat="dots")


CONFIGS = {"moe": _moe_cfg, "hybrid": _hybrid_cfg}


def _setup(kind: str, seed: int = 0):
    model = LM(CONFIGS[kind](), device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    batch = {k: torch.randint(0, model.cfg.vocab, (2, 32), generator=g)
             for k in ("tokens", "labels")}
    return model, params, batch


def _trace(prof, tmp_path) -> list:
    """The trace's complete events as ``(tid, start, end, name, args)``."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0), e["name"],
             e.get("args", {})) for e in ev
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                       "user_annotation")]


def _named(events, name) -> list:
    return [e for e in events if e[3] == name]


def _inside(e, outer) -> bool:
    return e[0] == outer[0] and outer[1] <= e[1] and e[2] <= outer[2]


def _backward_spans(events) -> list:
    """Region spans opened in a backward pass: inside an output marker's
    backward."""
    opens = _named(events, OPENS)
    return [e for e in events if e[3].startswith("repro_torch.")
            and any(o[0] == e[0] and o[1] <= e[1] <= o[2] for o in opens)]


def _graph_nodes(t) -> set:
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


@pytest.fixture(scope="module")
def moe_trace(tmp_path_factory):
    """``STEPS`` training steps of the MoE model under the CPU profiler."""
    model, params, batch = _setup("moe")
    step = make_train_step(model, OptimizerConfig())
    opt = adamw_init(params)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(STEPS):
            params, opt, _ = step(params, opt, batch)
    return _trace(prof, tmp_path_factory.mktemp("moe"))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_no_profiler_no_node_and_no_span(kind, monkeypatch):
    """Without a profiler the spans construct no record function and the
    graph holds no marker; under one it holds all three kinds (so the
    check sees them)."""
    made, fast = [], spans._RecordFunctionFast

    def counting(name):
        made.append(name)
        return fast(name)
    monkeypatch.setattr(spans, "_RecordFunctionFast", counting)
    model, params, batch = _setup(kind)
    grads = tree_map(torch.zeros_like, params)
    markers = {"_OutputsBackward", "_InputsBackward", "_EnterBackward",
               "_RecomputeBackward"}
    with torch.enable_grad():
        loss, _ = model.loss(model.trainable(params, grads), batch)
    assert not made and not _graph_nodes(loss) & markers
    with profile(activities=[ProfilerActivity.CPU]), torch.enable_grad():
        loss, _ = model.loss(model.trainable(params, grads), batch)
    assert made and _graph_nodes(loss) >= markers


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_loss_and_grads_bit_equal_under_profiler(kind):
    model, params, batch = _setup(kind)
    loss0, metrics0, grads0 = value_and_grad(model, params, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        loss1, metrics1, grads1 = value_and_grad(model, params, batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(metrics0[k], metrics1[k]) for k in metrics0)
    a, b = tree_leaves(grads0), tree_leaves(grads1)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


#: ops that launch no kernel: the markers' identities and saved inputs
NO_KERNEL = ("aten::view", "aten::detach")


def _leaf_ops(events) -> collections.Counter:
    """The innermost ``aten::`` ops of each thread, by name."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e[3].startswith("aten::"):
            by_tid[e[0]].append(e)
    leaves = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e[1], -e[2]))
        for e, nxt in zip(evs, evs[1:] + [None]):
            # sorted by start, so an op holds another iff it holds the next
            if nxt is None or nxt[1] >= e[2]:
                leaves.append(e[3])
    return collections.Counter(n for n in leaves if n not in NO_KERNEL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_spans_add_no_op_that_launches(kind, tmp_path, monkeypatch):
    """A traced training step runs the same ops, views aside, with the
    spans as without them: the markers compute nothing, and each layer's
    recompute stops where it stops unmarked."""
    counts = []
    for on in (True, False):
        if not on:
            monkeypatch.setattr(spans, "recording", lambda: False)
        model, params, batch = _setup(kind)
        step = make_train_step(model, OptimizerConfig())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, adamw_init(params), batch)
        counts.append(_leaf_ops(_trace(prof, tmp_path)))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("name", MOE_SPANS)
def test_moe_spans_in_forward_and_backward(moe_trace, name):
    """Each MoE span runs in the forward (and the recompute) of every MoE
    layer; all but ``positions``, whose work has no gradient, also in the
    backward."""
    found = _named(moe_trace, name)
    back = [e for e in _backward_spans(moe_trace) if e[3] == name]
    # 2 MoE layers a step: a forward, a recompute, and a backward
    assert len(found) - len(back) == STEPS * 2 * 2
    assert len(back) == (0 if name == "repro_torch.moe.positions"
                         else STEPS * 2)


def test_spans_nest_on_every_thread(moe_trace):
    """The program's spans nest among themselves; a span overlaps no
    other host event partly but the markers' own events."""
    ours = [e for e in moe_trace if e[3].startswith("repro_torch.")]
    assert ours
    for a in ours:
        for b in moe_trace:
            if b is a or b[0] != a[0]:
                continue
            partly = a[1] < b[1] < a[2] < b[2] or b[1] < a[1] < b[2] < a[2]
            if partly:
                assert any(m in b[3] for m in MARKERS), (a, b)


def test_index_put_backward_inside_dispatch(moe_trace):
    ipb = _named(moe_trace,
                 "autograd::engine::evaluate_function: IndexPutBackward0")
    disp = _named(moe_trace, "repro_torch.moe.dispatch")
    assert len(ipb) == STEPS * 2
    assert all(any(_inside(e, d) for d in disp) for e in ipb)


def _attention_softmax(e) -> bool:
    """The attention's softmax ops, forward or backward (4-D and up; the
    router's softmax is over (tokens, experts))."""
    if e[3] not in ("aten::_softmax", "aten::_softmax_backward_data"):
        return False
    dims = e[4].get("Input Dims") or [[]]
    return len(dims[0]) >= 3


def test_recompute_outside_backward_regions(moe_trace):
    """Each checkpointed layer is recomputed inside its own span, before
    any region of its backward opens: no backward region span holds the
    recompute or any of the attention's work, and the recomputed
    attention lies inside ``repro_torch.remat.recompute``."""
    rec = _named(moe_trace, "repro_torch.remat.recompute")
    back = _backward_spans(moe_trace)
    attn = [e for e in moe_trace if _attention_softmax(e)]
    assert len(rec) == STEPS * 2 and back and attn
    for b in back:
        assert not any(r[0] == b[0] and r[1] < b[2] and b[1] < r[2]
                       for r in rec), b
        assert not any(_inside(a, b) for a in attn), b
    # each recompute holds its layer's forward attention again
    assert all(any(_inside(a, r) for a in attn) for r in rec)


def test_adamw_span_once_a_step(moe_trace):
    assert len(_named(moe_trace, "repro_torch.adamw")) == STEPS


def test_generate_prefill_decode_and_scan_spans(tmp_path):
    """A hybrid model's ``generate``: one prefill span, one decode span a
    new token, and one SSD scan span an SSD layer, all in the prefill."""
    cfg = get_smoke_config("hymba-1.5b")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServeEngine(model, params, max_len=48, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    new = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen, stats = engine.generate(prompts, new)
    ev = _trace(prof, tmp_path)
    pre = _named(ev, "repro_torch.serve.prefill")
    dec = _named(ev, "repro_torch.serve.decode")
    scan = _named(ev, "repro_torch.ssd.scan")
    assert len(pre) == 1 and len(dec) == new
    assert len(scan) == cfg.n_layers          # every hybrid layer has SSD
    assert all(_inside(s, pre[0]) for s in scan)
    assert gen.shape == (2, new)
    assert stats.prefill_seconds > 0 and stats.decode_seconds > 0
