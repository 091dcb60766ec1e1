"""The port's training slice against the JAX package's, on the CPU: the
chunked loss, ``LM.loss`` and its gradients, the remat policies, AdamW,
one training step (and a second one continuing the reference's state),
gradient accumulation, the trainer, the data pipeline copy and the train
launcher.  The same weights (JAX-initialized, moved across with
``params_from_numpy``) and the same seeded numpy batches go to both; the
model comparisons compute in f32 (see ``f32_compute``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.layers as jlayers
import repro.train.optimizer as jopt
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import LM as JLM
from repro.train import make_train_step as jmake_train_step

import repro_torch.configs as tcfg
import repro_torch.models.layers as tlayers
import repro_torch.train.optimizer as topt
from repro_torch.checkpoint import CheckpointManager, flatten_pytree
from repro_torch.data import PipelineConfig, Prefetcher, SyntheticTokens
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy)
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.models.model import _dots_saveable
from repro_torch.models.params import tree_leaves
from repro_torch.train import (OptimizerConfig, Trainer, adamw_init,
                               make_eval_step, make_train_step)
from repro_torch.train.trainer import value_and_grad

ARCHS = ["qwen2.5-3b", "yi-9b", "stablelm-3b", "gemma2-2b", "mamba2-780m",
         "hymba-1.5b"]


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in f32 instead of bf16: in bf16 the two
    frameworks round at different places and the random-weight smoke
    models amplify it (see tests/test_torch_models.py)."""
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fan_in(tree, cfg):
    """Attention projections rescaled to fan-in over the axes their
    products contract, as ``chip_smoke.serving_params`` does.  The
    reference's init takes fan-in from the head axis, so the smoke
    models' scores reach std ~16 and most attention rows are an argmax:
    the two frameworks' f32 rounding then flips near-ties and the
    gradients differ by up to 4e-4 of their max; rescaled, by ~1e-6."""
    if isinstance(tree, list):
        return [_fan_in(t, cfg) for t in tree]
    if not isinstance(tree, dict):
        return tree
    tree = {k: _fan_in(v, cfg) for k, v in tree.items()}
    if "wq" in tree:
        for name, s in (("wq", cfg.n_heads / cfg.d_model),
                        ("wk", cfg.n_kv / cfg.d_model),
                        ("wv", cfg.n_kv / cfg.d_model),
                        ("wo", 1 / cfg.n_heads)):
            tree[name] = tree[name] * np.float32(np.sqrt(s))
    return tree


def _models(arch, seed=0, **over):
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = jax.tree_util.tree_map(
        jnp.asarray, _fan_in(_np(jm.init(jax.random.key(seed))), jc))
    return jm, jp, tm, params_from_numpy(_np(jp), "cpu")


def _batch(vocab, B=2, L=32, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, L)).astype(np.int32),
         "labels": rng.integers(0, vocab, (B, L)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close_trees(got, want, rtol, atol):
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


# -- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("chunk", [32, 8])
def test_cross_entropy_chunked(cap, chunk):
    """Value and gradients (w.r.t. x and the table) against the
    reference's, in one chunk and in four, with and without final_cap:
    rtol 1e-5 / atol 1e-6 (f32 sums in another order)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 32, 16)) * 0.5).astype(np.float32)
    table = (rng.standard_normal((50, 16)) * 2).astype(np.float32)
    labels = rng.integers(0, 50, (2, 32)).astype(np.int32)

    def jf(x, t):
        return jlayers.cross_entropy_chunked(x, t, jnp.asarray(labels),
                                             chunk=chunk, final_cap=cap)

    want, (wx, wt) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx, tt = (torch.from_numpy(a).requires_grad_() for a in (x, table))
    got = tlayers.cross_entropy_chunked(tx, tt, torch.from_numpy(labels),
                                        chunk=chunk, final_cap=cap)
    gx, gt = torch.autograd.grad(got, (tx, tt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in ((gx, wx), (gt, wt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError):      # 30 tokens are not 7 chunks
        tlayers.cross_entropy_chunked(tx[:, :30], tt,
                                      torch.from_numpy(labels[:, :30]),
                                      chunk=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads(arch, f32_compute):
    """``LM.loss`` and every parameter's gradient against
    ``jax.value_and_grad(model.loss)`` on the smoke config, flash off,
    the loss in four chunks: loss at rtol 1e-5, gradients at rtol 1e-4 /
    atol 1e-5 (measured gaps ~1e-6 of each leaf's max)."""
    jm, jp, tm, tp = _models(arch, loss_chunk=8)
    jb, tb = _batch(jm.cfg.vocab)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    loss, met, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    _close_trees(grads, jg, 1e-4, 1e-5)


def test_lm_loss_flash_route(f32_compute):
    """qwen2.5-3b smoke with ``flash=True, flash_block=16``: the port's
    flash backward against the reference's Pallas kernels in interpret
    mode, through the whole model (tolerances as above)."""
    jm, jp, tm, tp = _models("qwen2.5-3b", flash=True, flash_block=16)
    jb, tb = _batch(jm.cfg.vocab, seed=1)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, _, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_trees(grads, jg, 1e-4, 1e-5)


@pytest.mark.parametrize("arch,flash", [("qwen2.5-3b", True),
                                        ("gemma2-2b", False),
                                        ("mamba2-780m", False),
                                        ("hymba-1.5b", True)])
def test_remat_policies_agree(arch, flash):
    """``none``, ``dots`` and ``full`` recompute the same arithmetic, so
    the loss and gradients agree to rtol 1e-6 (bf16 compute)."""
    out = {}
    for remat in ("none", "dots", "full"):
        _, _, tm, tp = _models(arch, remat=remat, flash=flash,
                               flash_block=16)
        _, tb = _batch(tm.cfg.vocab, seed=2)
        loss, _, grads = value_and_grad(tm, tp, tb)
        out[remat] = (loss, tree_leaves(grads))
    for remat in ("dots", "full"):
        torch.testing.assert_close(out[remat][0], out["none"][0], rtol=1e-6,
                                   atol=0)
        for a, b in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_dots_policy_saves_the_projections_only():
    """Matrix products without batch dimensions (``mm``, and ``bmm`` over
    a batch of one, as einsum lowers the projections) are saved; batched
    products (attention scores) and everything else are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    one, many = torch.zeros(1, 4, 4), torch.zeros(3, 4, 4)
    assert _dots_saveable(None, aten.mm.default, one[0], one[0]) == \
        CheckpointPolicy.MUST_SAVE
    assert _dots_saveable(None, aten.bmm.default, one, one) == \
        CheckpointPolicy.MUST_SAVE
    assert _dots_saveable(None, aten.bmm.default, many, many) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert _dots_saveable(None, aten.exp.default, one) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def _dots_in_jaxpr(jaxpr, out):
    """Each ``dot_general`` of ``jaxpr`` and its sub-jaxprs (a scan's body
    once): True where it has batch dimensions."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lhs_batch, _) = eqn.params["dimension_numbers"]
            out.append(bool(lhs_batch))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if hasattr(sub, "eqns"):
                    _dots_in_jaxpr(sub, out)
                elif hasattr(sub, "jaxpr"):
                    _dots_in_jaxpr(getattr(sub.jaxpr, "jaxpr", sub.jaxpr),
                                   out)
    return out


@pytest.mark.parametrize("arch,kind", [("mamba2-780m", "ssd"),
                                       ("hymba-1.5b", "hyb_full"),
                                       ("hymba-1.5b", "hyb_swa"),
                                       ("deepseek-moe-16b", "moe")])
def test_dots_policy_saves_what_the_reference_saves(arch, kind):
    """Under ``remat="dots"`` a block saves the outputs of the products the
    reference's ``dots_with_no_batch_dims_saveable`` saves — the
    projections: as many as its forward's ``dot_general``s without batch
    dimensions (the SSD's in and out projections; the hybrid's attention,
    MLP and SSD projections; the MoE block's router, attention and shared
    experts) — and recomputes every batched product: the SSD chunk loop's
    einsums (four a chunk), the attention scores, the expert FFNs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy
    import repro.models.transformer as jtfm
    from repro.models.params import materialize as jmaterialize
    import repro_torch.models.transformer as ttfm
    aten = torch.ops.aten

    class Policy(TorchDispatchMode):
        saved = recomputed = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.mm.default, aten.addmm.default,
                        aten.bmm.default):
                if _dots_saveable(None, func, *args) == \
                        CheckpointPolicy.MUST_SAVE:
                    self.saved += 1
                else:
                    assert func is aten.bmm.default and args[0].shape[0] > 1
                    self.recomputed += 1
            return func(*args, **(kwargs or {}))

    jc, tc = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jp = jmaterialize(jtfm.block_defs(jc, kind), jax.random.key(0))
    tp = params_from_numpy(_np(jp), "cpu")
    x = np.random.default_rng(0).standard_normal((2, 32, jc.d_model)
                                                 ).astype(np.float32)
    pos = np.arange(32)
    jaxpr = jax.make_jaxpr(lambda p, h: jtfm.block_forward(
        jc, kind, p, h, jnp.asarray(pos))[0])(jp, jnp.asarray(x))
    dots = _dots_in_jaxpr(jaxpr.jaxpr, [])
    with Policy() as mode:
        ttfm.block_forward(tc, kind, tp, torch.from_numpy(x),
                           torch.from_numpy(pos))
    assert mode.saved == dots.count(False) > 0
    assert mode.recomputed >= dots.count(True) > 0
    if kind == "ssd":            # 2 chunks of 16, four products each
        assert mode.recomputed == 2 * dots.count(True) == 8


def test_trainable_leaves_accumulate_into_the_stacked_gradient():
    """Each layer of a stacked segment is its own leaf, a view of the
    stacked weight; its gradient lands in its slice of the stacked
    gradient, equal to autograd's gradient of the stacked tensor."""
    _, _, tm, tp = _models("yi-9b")
    _, tb = _batch(tm.cfg.vocab, seed=3)
    _, _, grads = value_and_grad(tm, tp, tb)
    wq = tp["segments"][0]["attn"]["wq"].detach().requires_grad_()
    seg = dict(tp["segments"][0], attn=dict(tp["segments"][0]["attn"],
                                            wq=wq))
    loss, _ = tm.loss(dict(tp, segments=[seg]), tb)
    (want,) = torch.autograd.grad(loss, (wq,))
    torch.testing.assert_close(grads["segments"][0]["attn"]["wq"], want,
                               rtol=1e-6, atol=1e-9)
    assert not any(p.requires_grad for p in tree_leaves(tp))


# -- the optimizer ---------------------------------------------------------------

OCFG = OptimizerConfig(peak_lr=1e-3, end_lr=1e-4, warmup_steps=10,
                       total_steps=100)


def test_warmup_cosine():
    jc = jopt.OptimizerConfig(**dataclasses.asdict(OCFG))
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        np.testing.assert_allclose(float(topt.warmup_cosine(OCFG, s)),
                                   float(jopt.warmup_cosine(jc, s)),
                                   rtol=1e-6)
    assert float(topt.warmup_cosine(OCFG, torch.tensor(10))) == \
        pytest.approx(1e-3)


def _state(seed, shapes=((3, 4), (5,), (2, 3, 2))):
    rng = np.random.default_rng(seed)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate(shapes)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in params.items()}
    m = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
         for k, v in params.items()}
    v = {k: np.abs(rng.standard_normal(v.shape)).astype(np.float32) * 0.1
         for k, v in params.items()}
    return params, grads, {"m": m, "v": v, "count": np.int32(4)}


def test_global_norm():
    _, grads, _ = _state(0)
    np.testing.assert_allclose(
        float(topt.global_norm(params_from_numpy(grads, "cpu"))),
        float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, grads))),
        rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_the_reference(clip):
    """One update of the same params, grads and state (step 5), clipped
    and not: params, moments, count, grad_norm and lr at rtol 1e-6."""
    cfg = dataclasses.replace(OCFG, grad_clip=clip)
    params, grads, state = _state(1)
    jnew, jstate, jmet = jopt.adamw_update(
        jopt.OptimizerConfig(**dataclasses.asdict(cfg)),
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (grads, state, params)))
    tp = params_from_numpy(params, "cpu")
    new, st, met = topt.adamw_update(cfg, params_from_numpy(grads, "cpu"),
                                     opt_state_from_numpy(state, "cpu"), tp)
    assert new is tp                  # in place
    for a, b in ((new, jnew), (st["m"], jstate["m"]),
                 (st["v"], jstate["v"])):
        _close_trees(a, b, 1e-6, 1e-7)
    assert int(st["count"]) == int(jstate["count"]) == 5
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-6)


def test_zero_moment_defs_match_the_reference():
    sk = LM(tcfg.get_smoke_config("gemma2-2b"), device="cpu").skeleton()
    jsk = JLM(jcfg.get_smoke_config("gemma2-2b")).skeleton()
    got = tree_leaves(topt.zero_moment_defs(sk))
    want = jax.tree_util.tree_leaves(
        jopt.zero_moment_defs(jsk), is_leaf=lambda x: hasattr(x, "init"))
    assert [d.__dict__ for d in got] == [d.__dict__ for d in want]


def test_adamw_init_and_state_round_trip():
    _, _, tm, tp = _models("qwen2.5-3b")
    st = adamw_init(tp)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    assert all(float(x.abs().sum()) == 0 for x in tree_leaves(st["m"]))
    back = opt_state_from_numpy(opt_state_to_numpy(st), "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert torch.equal(a, b)


# -- training steps ------------------------------------------------------------

def test_train_step_matches_the_reference(f32_compute):
    """``make_train_step`` against the reference's on qwen2.5-3b smoke:
    loss, grad_norm, lr, the moments and the updated params after one
    step.  Then the reference's state after that step, carried over with
    ``opt_state_from_numpy``, is stepped once by the port: equal to the
    reference's second step.  The moments carry the gradients (rtol 1e-4,
    atol 1e-6, as the gradients).  An AdamW step moves each weight by
    about lr whatever its gradient's size, so a weight whose gradient is
    ~1e-6 of its leaf's max, where the two frameworks' f32 gradients
    differ, moves by a different share of lr: params at rtol 1e-5 and an
    atol of lr / 4 (measured gaps up to 0.09 lr, on 1 of 32,768)."""
    jm, jp, tm, tp = _models("qwen2.5-3b")
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=10)
    jocfg = jopt.OptimizerConfig(**dataclasses.asdict(ocfg))
    jb, tb = _batch(jm.cfg.vocab, B=4, seed=4)
    jstep = jax.jit(jmake_train_step(jm, jocfg))
    jp1, js1, jm1 = jstep(jp, jopt.adamw_init(jp), jb)
    step = make_train_step(tm, ocfg)
    tp1, ts1, tm1 = step(tp, adamw_init(tp), tb)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5)
    for key in ("m", "v"):
        _close_trees(ts1[key], js1[key], 1e-4, 1e-6)
    lr_atol = float(jm1["lr"]) / 4
    _close_trees(tp1, jp1, 1e-5, lr_atol)

    jp2, js2, jm2 = jstep(jp1, js1, jb)
    tp2, ts2, tm2 = step(params_from_numpy(_np(jp1), "cpu"),
                         opt_state_from_numpy(_np(js1), "cpu"), tb)
    assert int(ts2["count"]) == int(js2["count"]) == 2
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm2[k]), float(jm2[k]), rtol=1e-5)
    for key in ("m", "v"):
        _close_trees(ts2[key], js2[key], 1e-4, 1e-6)
    _close_trees(tp2, jp2, 1e-5, lr_atol)


def test_grad_accum_equivalence():
    """grad_accum=2 matches grad_accum=1 on the same global batch (the
    reference's own check and tolerance, bf16 compute)."""
    _, _, tm, _ = _models("yi-9b")
    jp = JLM(jcfg.get_smoke_config("yi-9b")).init(jax.random.key(0))
    _, tb = _batch(tm.cfg.vocab, B=4, seed=5)
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=10)
    out = []
    for accum in (1, 2):
        p = params_from_numpy(_np(jp), "cpu")
        out.append(make_train_step(tm, ocfg, grad_accum=accum)(
            p, adamw_init(p), tb))
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=5e-2, atol=5e-4)
    np.testing.assert_allclose(float(out[0][2]["loss"]),
                               float(out[1][2]["loss"]), rtol=1e-2)
    with pytest.raises(ValueError):
        make_train_step(tm, ocfg, grad_accum=3)(p, adamw_init(p), tb)


def test_trainer_loss_decreases():
    """The reference's trainer check: 30 steps on the qwen2.5-3b smoke
    config from the synthetic pipeline, the loss falls; then the
    straggler report and the checkpoint hook."""
    cfg = tcfg.get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cpu")
    data = SyntheticTokens(PipelineConfig(global_batch=8, seq_len=32,
                                          vocab=cfg.vocab, seed=1))

    class Manager:
        saved = []

        def save(self, step, params):
            self.saved.append((step, float(params["final_norm"].sum())))

    tr = Trainer(model, OptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                                        total_steps=60), data,
                 ckpt_manager=Manager(), ckpt_every=10)
    params, opt = tr.init(torch.Generator().manual_seed(0))
    params, opt, hist = tr.run(params, opt, num_steps=30, log_every=0)
    first = np.mean([m["loss"] for _, m in hist[:5]])
    last = np.mean([m["loss"] for _, m in hist[-5:]])
    assert last < first, (first, last)
    assert [s for s, _ in Manager.saved] == [10, 20, 30]
    assert int(opt["count"]) == 30 and tr.state.step == 30
    rep = tr.straggler_report()
    assert "median" in rep and rep["median"] > 0
    ev = make_eval_step(model)(params, {k: torch.as_tensor(v) for k, v in
                                        next(data).items()})
    assert np.isfinite(float(ev["loss"]))
    with pytest.raises(RuntimeError, match="checkpoint manager"):
        Trainer(model, OptimizerConfig(), data).resume()


def test_trainer_checkpoints_and_resumes(tmp_path):
    """The trainer's hook saves through a CPU ``CheckpointManager`` every
    ``ckpt_every`` steps; ``resume()`` sets the saved step and returns the
    saved params bit-exact, by name."""
    cfg = tcfg.get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cpu")
    data = SyntheticTokens(PipelineConfig(global_batch=2, seq_len=16,
                                          vocab=cfg.vocab, seed=1))
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    tr = Trainer(model, OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                                        total_steps=10), data,
                 ckpt_manager=mgr, ckpt_every=2)
    params, opt = tr.init(torch.Generator().manual_seed(0))
    params, opt, _ = tr.run(params, opt, num_steps=5, log_every=0)
    assert mgr.steps() == [2, 4]
    tr.run(params, opt, num_steps=1, log_every=0)
    assert mgr.steps() == [4, 6]
    tr2 = Trainer(model, OptimizerConfig(), data, ckpt_manager=mgr)
    flat = tr2.resume()
    want = flatten_pytree(params)
    assert tr2.state.step == 6 and sorted(flat) == sorted(want)
    for name, t in flat.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name])


# -- data pipeline and launcher ------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(global_batch=4, seq_len=16, vocab=100, seed=7),
    dict(global_batch=8, seq_len=16, vocab=151936, seed=3, host_id=1,
         num_hosts=2, start_step=5),
    dict(global_batch=2, seq_len=8, vocab=50, seed=0, frontend="frames",
         d_model=12)], ids=["tokens", "host_shard", "frames"])
def test_pipeline_copy_is_bit_equal(cfg):
    ours, ref = SyntheticTokens(PipelineConfig(**cfg)), \
        JSyntheticTokens(JPipelineConfig(**cfg))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state() == ref.state()
    pf = Prefetcher(SyntheticTokens(PipelineConfig(**cfg)), depth=2)
    np.testing.assert_array_equal(next(pf)["labels"],
                                  next(JSyntheticTokens(
                                      JPipelineConfig(**cfg)))["labels"])


def test_train_launcher(monkeypatch, capsys, tmp_path):
    """``launch.train`` trains the smoke config on the CPU when asked (the
    dense, SSD and hybrid families' finite losses), and otherwise needs a
    GPU; with ``--ckpt-dir`` it saves every
    ``--ckpt-every`` steps and at the end, and ``--resume`` carries on from
    the latest step; ``--mesh host`` trains in a world of this process
    alone (``tests/test_torch_launch_mesh.py`` runs it under torchrun)."""
    train_cli.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "3",
                    "--global-batch", "2", "--seq-len", "16",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=qwen2.5-3b-smoke device=cpu" in out and "loss" in out
    train_cli.main(["--arch", "qwen2.5-3b", "--smoke", "--mesh", "host",
                    "--device", "cpu", "--steps", "2", "--global-batch", "2",
                    "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "mesh=host" in out and "loss" in out
    ckpt = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--steps", "2", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_cli.main(ckpt)
    out = capsys.readouterr().out
    assert "resumed" not in out and "blocks ->" in out
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.steps() == [1, 2]
    saved, _ = mgr.restore(2)
    train_cli.main(ckpt + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert mgr.steps() == [3, 4]
    assert sorted(saved) == sorted(mgr.restore(4)[0])
    for arch in ("mamba2-780m", "hymba-1.5b"):
        train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--global-batch", "2", "--seq-len", "32",
                        "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"arch={arch}-smoke device=cpu" in out and "loss" in out
        line = next(ln for ln in out.splitlines() if ln.startswith("loss "))
        first, last = (float(w) for w in line.split()[1::2])
        assert np.isfinite([first, last]).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen2.5-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(LM(tcfg.get_smoke_config("qwen2.5-3b")), OCFG, iter([]))
