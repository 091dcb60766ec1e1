"""The port's encoder (the kind ``enc``, the ``frames`` frontend and
hubert-xlarge) against the JAX package's, on the CPU: the same weights
(JAX-initialized, the attention projections at true fan-in, moved across
with ``params_from_numpy``) and the same seeded numpy frames through both.

Both packages cast the frames to bf16 whatever the compute dtype, so a
frames model computes in bf16 even under f32 compute.  Where the point is
the algorithm the tests compute in f32 in both packages (``f32_frames``
keeps the frames f32 beside ``f32_compute``); the model's own bf16 path
is held at bf16 tolerances, stated per test."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.layers as jlayers
import repro.models.transformer as jtfm
import repro.serve.kv_cache as jkv
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import LM as JLM
from repro.models.params import materialize as jmaterialize

import repro_torch.configs as tcfg
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as ttfm
import repro_torch.serve.kv_cache as tkv
from repro_torch.data import PipelineConfig, SyntheticTokens
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.models.layers import unembed_chunked
from repro_torch.models.params import tree_leaves
from repro_torch.train.trainer import value_and_grad

ARCH = "hubert-xlarge"
#: f32 blocks and models: f32 sums in another order (the loss at rtol 1e-5)
F32_TOL = (1e-4, 1e-5)
#: bf16 compute, the model's own: the two frameworks round at different
#: places (XLA may keep excess precision inside a fusion), a few bf16
#: steps (2^-8 of a value) on a leaf after the 3-layer smoke stack; the
#: gradient gaps measured 1.8e-2 of a leaf's max at most, the hidden
#: state's 1.4e-2, the loss's 5e-4
STACK_TOL_BF16 = 5e-2
LOSS_TOL_BF16 = 2e-3


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


@pytest.fixture
def f32_frames(monkeypatch, f32_compute):
    """Both packages keep the frames in f32 (each casts them to bf16 in
    ``LM._embed_in``), so the stack computes in f32 and the comparison
    sees the algorithm, not bf16 rounding."""
    monkeypatch.setattr(JLM, "_embed_in",
                        lambda self, params, batch:
                        batch["frames"].astype(jnp.float32))
    monkeypatch.setattr(LM, "_embed_in",
                        lambda self, params, batch:
                        batch["frames"].to(torch.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fan_in(tree, cfg):
    """Attention projections rescaled to fan-in over the axes their
    products contract (as ``chip_smoke.serving_params``): under the
    reference's init most attention rows are an argmax and rounding flips
    near-ties."""
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


def _models(seed=0, **over):
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH), **over)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = jax.tree_util.tree_map(
        jnp.asarray, _fan_in(_np(jm.init(jax.random.key(seed))), jc))
    return jm, jp, tm, params_from_numpy(_np(jp), "cpu")


def _batch(cfg, B=2, L=32, seed=0):
    """Frames as the pipeline draws them (std 0.1) and labels."""
    rng = np.random.default_rng(seed)
    b = {"frames": (rng.standard_normal((B, L, cfg.d_model)) * 0.1
                    ).astype(np.float32),
         "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _gap(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])


# -- the block -----------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True],
                         ids=["q_chunked", "flash"])
def test_enc_block_forward_is_bidirectional(flash):
    """One ``enc`` block in f32 (LayerNorm, ungated GELU MLP, no RoPE)
    with the k/v it collects: rtol 1e-4 / atol 1e-5; every position sees
    the later ones (non-causal), and the kind has no cache."""
    over = dict(flash=flash, flash_block=16)
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH), **over)
    jdefs = jtfm.block_defs(jc, "enc")
    assert ttfm._attn_kwargs(tc, "enc")["causal"] is False
    jp = jax.tree_util.tree_map(jnp.asarray, _fan_in(_np(jmaterialize(
        jdefs, jax.random.key(2))), jc))
    tp = params_from_numpy(_np(jp), "cpu")
    x = (np.random.default_rng(1).standard_normal((2, 32, jc.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(32)
    jy, _, jkv_ = jtfm.block_forward(jc, "enc", jp, jnp.asarray(x),
                                     jnp.asarray(pos), collect_kv=True)
    ty, aux, tkv_ = ttfm.block_forward(tc, "enc", tp, torch.from_numpy(x),
                                       torch.from_numpy(pos),
                                       collect_kv=True)
    _close(ty, jy, F32_TOL)
    assert float(aux) == 0.0
    for n in ("k", "v"):
        _close(tkv_[n], jkv_[n], F32_TOL)
    # a change at the last position moves the first one's output
    x2 = x.copy()
    x2[:, -1] += 1.0
    ty2, _, _ = ttfm.block_forward(tc, "enc", tp, torch.from_numpy(x2),
                                   torch.from_numpy(pos))
    assert not torch.allclose(ty2[:, 0], ty[:, 0])
    assert ttfm.block_cache_defs(tc, "enc", 2, 32) is None
    assert jtfm.block_cache_defs(jc, "enc", 2, 32) is None


# -- the model -------------------------------------------------------------------

def test_skeleton_has_no_embedding():
    """The frames model has no ``embed`` leaf and an untied ``lm_head``:
    the reference's leaf names and shapes, full and smoke."""
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        jsk, tsk = JLM(jc).skeleton(), LM(tc, device="cpu").skeleton()
        assert "embed" not in tsk and "lm_head" in tsk
        assert sorted(tsk) == sorted(jsk)
        jleaves = jax.tree_util.tree_leaves(
            jsk, is_leaf=lambda d: hasattr(d, "init"))
        assert [d.__dict__ for d in tree_leaves(tsk)] == \
            [d.__dict__ for d in jleaves]
        assert LM(tc, device="cpu").num_params() == JLM(jc).num_params()
    assert LM(tcfg.get_config(ARCH), device="cpu").num_params() == \
        944_611_840


def test_frames_enter_as_bf16_whatever_the_compute(f32_compute):
    """``_embed_in`` casts the frames to bf16 even under f32 compute, bit
    for bit as the reference does; so the hidden state is bf16."""
    jm, jp, tm, tp = _models()
    jb, tb = _batch(jm.cfg)
    want = jm._embed_in(jp, jb)
    got = tm._embed_in(tp, tb)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(to_numpy(got, ml_dtypes.bfloat16),
                                  np.asarray(want))
    h, _, _ = tm.hidden(tp, {"frames": tb["frames"]})
    assert h.dtype == torch.bfloat16


@pytest.mark.parametrize("flash", [False, True],
                         ids=["q_chunked", "flash"])
def test_loss_and_grads_f32(flash, f32_frames):
    """``LM.loss`` and every gradient against ``jax.value_and_grad`` in
    f32, on both routes (the flash route against the Pallas kernels in
    interpret mode): the loss at rtol 1e-5, gradients at rtol 1e-4 /
    atol 1e-5."""
    jm, jp, tm, tp = _models(flash=flash, flash_block=16, loss_chunk=8)
    jb, tb = _batch(jm.cfg)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, _, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tree_leaves(grads)) == len(jleaves)
    for got, want in zip(tree_leaves(grads), jleaves):
        _close(got, want, F32_TOL)


def test_loss_and_grads_bf16():
    """The model's own path (bf16 frames, bf16 compute): the loss within
    LOSS_TOL_BF16 and each gradient within STACK_TOL_BF16 of its leaf's
    max."""
    jm, jp, tm, tp = _models()
    jb, tb = _batch(jm.cfg)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, _, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_TOL_BF16)
    for got, want in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jg)):
        assert _gap(got, want) < STACK_TOL_BF16


def test_prefill_on_frames(f32_frames):
    """``LM.prefill`` takes frames: the last frame's logits against the
    reference's (f32, rtol/atol 1e-4), the cache one ``None`` segment in
    both, and no cache bytes."""
    jm, jp, tm, tp = _models()
    jb, tb = _batch(jm.cfg)
    jl, jcache = jm.prefill(jp, {"frames": jb["frames"]})
    tl, tcache = tm.prefill(tp, {"frames": tb["frames"]}, cache_len=40)
    _close(tl, jl, (1e-4, 1e-4))
    assert tcache == [None] and jcache == [None]
    assert tkv.cache_bytes(tm, 2, 40) == jkv.cache_bytes(jm, 2, 40) == 0
    assert tkv.cache_spec_summary(tm, 2, 40) == \
        jkv.cache_spec_summary(jm, 2, 40) == {}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_flash_route_against_q_chunked(f32, monkeypatch):
    """Within the port, as ``chip_smoke`` holds the card's kernels: the
    flash route (its plain version here) against the q-chunked route on
    every frame's logits and on the gradients.  f32 (frames kept f32):
    rtol 1e-4 / atol 1e-5 on the logits, 1e-3 of each leaf's max on the
    gradients; the model's own bf16: 2e-2 (the card's LOGIT_GAP) on the
    logits, STACK_TOL_BF16 on the gradients."""
    if f32:
        monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)
        monkeypatch.setattr(LM, "_embed_in", lambda self, params, batch:
                            batch["frames"].to(torch.float32))
    _, _, flash, tp = _models(flash=True, flash_block=16)
    base = LM(dataclasses.replace(flash.cfg, flash=False), device="cpu")
    _, tb = _batch(flash.cfg, seed=3)
    logits = []
    for m in (flash, base):
        h, _, _ = m.hidden(tp, {"frames": tb["frames"]})
        logits.append(unembed_chunked(h, tp["lm_head"]))
    grads = [tree_leaves(value_and_grad(m, tp, tb)[2])
             for m in (flash, base)]
    if f32:
        _close(logits[0], logits[1].numpy(), F32_TOL)
    else:
        assert _gap(logits[0], logits[1].numpy()) < 2e-2
    for a, b in zip(*grads):
        assert _gap(a, b.numpy()) < (1e-3 if f32 else STACK_TOL_BF16)


def test_pipeline_draws_the_references_frames():
    """``frontend="frames"``: the same frames and labels as the
    reference's pipeline, bit for bit."""
    kw = dict(global_batch=2, seq_len=8, vocab=504, seed=3,
              frontend="frames", d_model=16)
    jb = next(JSyntheticTokens(JPipelineConfig(**kw)))
    tb = next(SyntheticTokens(PipelineConfig(**kw)))
    assert sorted(tb) == sorted(jb) == ["frames", "labels"]
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_train_launcher_runs_the_smoke_encoder(capsys):
    """``python -m repro_torch.launch.train --arch hubert-xlarge --smoke
    --device cpu``: the pipeline draws frames of the model's width, and
    the losses are finite."""
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                    "--global-batch", "2", "--seq-len", "16",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke device=cpu" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("loss "))
    first, last = (float(w) for w in line.split()[1::2])
    assert np.isfinite([first, last]).all()
