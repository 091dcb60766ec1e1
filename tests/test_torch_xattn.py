"""The port's cross-attention (``cross_kv``, ``cross_attn_forward``, the
tanh gate, the kinds ``xattn`` and ``group_sx``) and llama-3.2-vision-90b
against the JAX package's, on the CPU: the same weights (JAX-initialized,
the attention projections at true fan-in, every ``gate`` set nonzero so
the memory reaches the output) and the same seeded numpy inputs and
memory tokens through both.  The memory is bf16 where the model serves it
(under f32 compute too: the reference's launcher draws it so)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.transformer as jtfm
import repro.serve.kv_cache as jkv
from repro.models import LM as JLM
from repro.models.params import materialize as jmaterialize
from repro.serve import ServeEngine as JServeEngine

import repro_torch.configs as tcfg
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as ttfm
import repro_torch.serve.kv_cache as tkv
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM
from repro_torch.models.layers import unembed_chunked
from repro_torch.models.params import tree_leaves
from repro_torch.serve import ServeEngine, flatten_cache
from repro_torch.train.trainer import value_and_grad

ARCH = "llama-3.2-vision-90b"
#: the gate's value in every test: tanh(0.7) = 0.60 of the cross output
GATE = 0.7
#: f32: sums in another order
F32_TOL = (1e-4, 1e-5)
#: bf16 inputs and compute: each framework rounds its bf16 products once
#: from f32 sums of its own order, so an output may differ by a bf16 step
#: of its inputs' products (2^-8) and the probabilities by one of theirs
BF16_TOL = (2 ** -6, 2e-3)
#: a whole bf16 block (residual, cross-attention, MLP each rounded to bf16
#: on their own in each framework): max |d| / max |ref|, a few bf16 steps
#: (2^-8) of the block's largest output
BLOCK_GAP_BF16 = 2e-2
#: a bf16 cache leaf: the same f32 value up to f32 rounding, rounded once
#: to bf16 (one bf16 step; atol for values near 0)
CACHE_TOL = (2 ** -7, 1e-4)
#: a whole smoke model's logits in f32 compute (bf16 memory and caches)
LOGIT_TOL = (1e-3, 1e-3)
#: decode against the forward: the reference's own bound
DECODE_GAP = 0.05


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _prepare(tree, cfg):
    """Attention projections rescaled to fan-in over the axes their
    products contract (as ``chip_smoke.serving_params``), every gate set
    to GATE (the reference initializes it to zero, which hides the
    memory)."""
    if isinstance(tree, list):
        return [_prepare(t, cfg) for t in tree]
    if not isinstance(tree, dict):
        return tree
    tree = {k: _prepare(v, cfg) for k, v in tree.items()}
    if "wq" in tree:
        for name, s in (("wq", cfg.n_heads / cfg.d_model),
                        ("wk", cfg.n_kv / cfg.d_model),
                        ("wv", cfg.n_kv / cfg.d_model),
                        ("wo", 1 / cfg.n_heads)):
            tree[name] = tree[name] * np.float32(np.sqrt(s))
    if "gate" in tree:
        tree["gate"] = np.full_like(tree["gate"], GATE)
    return tree


def _pair(defs, cfg, seed=0):
    jp = jax.tree_util.tree_map(jnp.asarray, _prepare(_np(jmaterialize(
        defs, jax.random.key(seed))), cfg))
    return jp, params_from_numpy(_np(jp), "cpu")


def _cfgs(groups=1, **over):
    jc, tc = jcfg.get_smoke_config(ARCH), tcfg.get_smoke_config(ARCH)
    if groups != 1:
        over.update(program=(("group_sx", groups),), n_layers=5 * groups)
    return (dataclasses.replace(jc, **over), dataclasses.replace(tc, **over))


def _models(groups=1, seed=0, **over):
    jc, tc = _cfgs(groups, **over)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = jax.tree_util.tree_map(
        jnp.asarray, _prepare(_np(jm.init(jax.random.key(seed))), jc))
    return jm, jp, tm, params_from_numpy(_np(jp), "cpu")


def _memory(cfg, B=2, seed=5):
    """0.02·N(0, 1) memory tokens in bf16, as the serve launcher draws
    them (here larger, 0.5·N(0, 1), so the memory moves the logits of the
    small smoke model)."""
    m = (np.random.default_rng(seed).standard_normal(
        (B, cfg.n_memory_tokens, cfg.d_model)) * 0.5).astype(
            ml_dtypes.bfloat16)
    return jnp.asarray(m), params_from_numpy(m, "cpu")


def _batch(cfg, B=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    jm, tm = _memory(cfg, B)
    return (dict({k: jnp.asarray(v) for k, v in b.items()}, memory=jm),
            dict({k: torch.from_numpy(v) for k, v in b.items()}, memory=tm))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])


def _gap(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


# -- cross attention -----------------------------------------------------------

CROSS_CASES = {"f32": (np.float32, np.float32, F32_TOL),
               "bf16": (ml_dtypes.bfloat16, ml_dtypes.bfloat16, BF16_TOL),
               "bf16_memory_f32_compute": (np.float32, ml_dtypes.bfloat16,
                                           F32_TOL)}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_attn_forward(case):
    """``cross_kv`` and ``cross_attn_forward`` with a nonzero gate against
    the reference's, with the result dtype: f32; bf16; and f32 queries
    over bf16 memory (the reference's jnp promotion runs the products in
    f32, the port casts explicitly)."""
    xdt, mdt, tol = CROSS_CASES[case]
    cfg = jcfg.get_smoke_config(ARCH)
    jp, tp = _pair(jattn.attn_defs(64, 4, 2, 16, gated=True), cfg)
    assert tp["gate"].shape == () and float(tp["gate"]) == \
        pytest.approx(GATE)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 12, 64)) * 0.5).astype(xdt)
    mem = (rng.standard_normal((2, 8, 64)) * 0.5).astype(mdt)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(mem))
    tk, tv = tattn.cross_kv(tp, params_from_numpy(mem, "cpu"))
    assert str(tk.dtype).endswith(str(jk.dtype))
    _close(tk, jk, tol)
    _close(tv, jv, tol)
    kw = dict(n_heads=4, n_kv=2, head_dim=16)
    want = jattn.cross_attn_forward(jp, jnp.asarray(x), jk, jv, **kw)
    got = tattn.cross_attn_forward(tp, params_from_numpy(x, "cpu"), tk, tv,
                                   **kw)
    assert str(got.dtype).endswith(str(want.dtype))
    _close(got, want, tol)
    # the gate scales the whole output
    tp0 = dict(tp, gate=torch.zeros(()))
    assert not got.abs().max() == 0
    assert float(tattn.cross_attn_forward(
        tp0, params_from_numpy(x, "cpu"), tk, tv, **kw).abs().max()) == 0


BLOCK_CASES = {"f32": (np.float32, np.float32, F32_TOL),
               "bf16_memory": (np.float32, ml_dtypes.bfloat16, F32_TOL),
               "bf16": (ml_dtypes.bfloat16, ml_dtypes.bfloat16, None)}


def _close_block(got, want, tol):
    """F32_TOL elementwise, or in bf16 (``tol`` None) BLOCK_GAP_BF16 on
    max |d| / max |ref|."""
    if tol is None:
        assert _gap(got, want) < BLOCK_GAP_BF16
    else:
        _close(got, want, tol)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_xattn_block_forward_prefill_decode(case):
    """One ``xattn`` block (it computes in its input's dtype): f32, f32
    over bf16 memory, and bf16.  The defs (the 0-d gate only for
    ``xattn``), the forward against the reference's (F32_TOL, or
    BLOCK_GAP_BF16 in bf16), the ``xk``/``xv`` it collects turned into the
    bf16 cache (one bf16 step; in bf16 BF16_TOL, as K and V are bf16
    products there), and a ``block_decode`` step reading that cache."""
    xdt, mdt, tol = BLOCK_CASES[case]
    jc, tc = _cfgs()
    jdefs = jtfm.block_defs(jc, "xattn")
    tdefs = ttfm.block_defs(tc, "xattn")
    assert [d.__dict__ for d in tree_leaves(tdefs)] == \
        [d.__dict__ for d in jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "init"))]
    assert "gate" in tdefs["attn"]
    assert "gate" not in ttfm.block_defs(tc, "attn")["attn"]
    jp, tp = _pair(jdefs, jc, seed=2)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 12, 64)) * 0.5).astype(xdt)
    mem = (rng.standard_normal((2, jc.n_memory_tokens, 64)) * 0.5).astype(
        mdt)
    pos = np.arange(12)
    jy, _, jkv_ = jtfm.block_forward(jc, "xattn", jp, jnp.asarray(x),
                                     jnp.asarray(pos), jnp.asarray(mem),
                                     collect_kv=True)
    ty, aux, tkv_ = ttfm.block_forward(tc, "xattn", tp,
                                       params_from_numpy(x, "cpu"),
                                       torch.from_numpy(pos),
                                       params_from_numpy(mem, "cpu"),
                                       collect_kv=True)
    assert str(ty.dtype).endswith(str(jy.dtype)) and float(aux) == 0.0
    _close_block(ty, jy, tol)
    jdefs_c = jtfm.block_cache_defs(jc, "xattn", 2, 20)
    tdefs_c = ttfm.block_cache_defs(tc, "xattn", 2, 20)
    assert {k: d.__dict__ for k, d in tdefs_c.items()} == \
        {k: d.__dict__ for k, d in jdefs_c.items()}
    jc_ = jtfm.block_prefill(jc, "xattn", jkv_, jdefs_c, 2, 12)
    tc_ = ttfm.block_prefill(tc, "xattn", tkv_, tdefs_c, 2, 12)
    for n in ("xk", "xv"):
        assert tc_[n].dtype == torch.bfloat16
        _close(tc_[n], jc_[n], CACHE_TOL if tol else BF16_TOL)
    x1 = x[:, :1]
    jy1, _ = jtfm.block_decode(jc, "xattn", jp, jnp.asarray(x1), jc_, 12)
    ty1, tcache = ttfm.block_decode(tc, "xattn", tp,
                                    params_from_numpy(x1, "cpu"),
                                    params_from_numpy(_np(jc_), "cpu"), 12)
    _close_block(ty1, jy1, tol)
    assert sorted(tcache) == ["xk", "xv"]


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_group_sx_loss_and_grads(groups, f32_compute):
    """``LM.loss`` and every gradient (the gate's too) of the VLM smoke
    model at one ``group_sx`` step and at two (stacked: the 0-d gate
    becomes a (2,) leaf) in f32 compute with bf16 memory: the loss at
    rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5."""
    jm, jp, tm, tp = _models(groups, loss_chunk=8)
    gate = tp["segments"][0]["cross"]["attn"]["gate"]
    assert gate.shape == (() if groups == 1 else (groups,))
    jb, tb = _batch(jm.cfg)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    loss, _, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tree_leaves(grads)) == len(jleaves)
    for got, want in zip(tree_leaves(grads), jleaves):
        _close(got, want, F32_TOL)
    assert float(grads["segments"][0]["cross"]["attn"]["gate"]
                 .abs().max()) > 0


@pytest.mark.parametrize("groups", [1, 2])
def test_prefill_cache_and_decode(groups, f32_compute):
    """The prefill's logits (LOGIT_TOL) and its cache against the
    reference's: the self layers' bf16 KV and the cross layer's bf16
    ``xk``/``xv`` within one bf16 step, the same names; then decode steps
    from that cache against the reference's (LOGIT_TOL), and decode
    against the port's own forward over one more token (DECODE_GAP)."""
    jm, jp, tm, tp = _models(groups)
    jb, tb = _batch(jm.cfg)
    jb.pop("labels"), tb.pop("labels")
    jl, jcache = jm.prefill(jp, jb, cache_len=20)
    tl, tcache = tm.prefill(tp, tb, cache_len=20)
    _close(tl, jl, LOGIT_TOL)
    tflat = flatten_cache(tcache)
    jflat = {f"cache/{i}/" + "/".join(str(getattr(p, "key", p))
                                      for p in path): leaf
             for i, seg in enumerate(jcache)
             for path, leaf in jax.tree_util.tree_leaves_with_path(seg)}
    assert sorted(tflat) == sorted(jflat)
    assert any(n.endswith("/cross/xk") for n in tflat)
    for name, want in jflat.items():
        assert tflat[name].dtype == torch.bfloat16, name
        _close(tflat[name], want, CACHE_TOL)
    tok = np.asarray(jl[:, -1].argmax(-1))[:, None].astype(np.int32)
    jd, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), 16)
    td, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), 16)
    _close(td, jd, LOGIT_TOL)
    toks = torch.cat([tb["tokens"], torch.from_numpy(tok)], 1)
    h, _, _ = tm.hidden(tp, {"tokens": toks, "memory": tb["memory"]})
    ref = unembed_chunked(h[:, -1:], tp["lm_head"])
    assert float((td - ref).abs().max() / ref.abs().max()) < DECODE_GAP
    assert tkv.cache_bytes(tm, 2, 20) == jkv.cache_bytes(jm, 2, 20)
    assert tkv.cache_spec_summary(tm, 2, 20) == \
        jkv.cache_spec_summary(jm, 2, 20)


def test_memory_moves_the_logits(f32_compute):
    """With the gate nonzero the memory shapes the logits; with the
    reference's zero gate it does not (unmasked attention is blind to
    the memory's order, so the other memory is another draw)."""
    _, _, tm, tp = _models()
    _, tb = _batch(tm.cfg)
    other = dict(tb, memory=_memory(tm.cfg, seed=6)[1])
    a, _ = tm.prefill(tp, tb)
    b, _ = tm.prefill(tp, other)
    assert float((a - b).abs().max()) > 1e-3
    tp["segments"][0]["cross"]["attn"]["gate"].zero_()
    a, _ = tm.prefill(tp, tb)
    b, _ = tm.prefill(tp, other)
    assert torch.equal(a, b)


def test_generate_with_memory_matches_the_reference(f32_compute):
    """``ServeEngine.generate(extra={"memory": ...})``: the reference's
    greedy tokens, the memory reaching the prefill only (decode reads the
    cross layers' cache)."""
    jm, jp, tm, tp = _models(2)
    jb, tb = _batch(jm.cfg, L=12)
    prompts = np.asarray(jb["tokens"])
    want, _ = JServeEngine(jm, jp, max_len=20).generate(
        prompts, 6, extra={"memory": jb["memory"]})
    got, stats = ServeEngine(tm, tp, max_len=20, device="cpu").generate(
        prompts, 6, extra={"memory": tb["memory"]})
    np.testing.assert_array_equal(got, want)
    assert stats.tokens_generated == 12


def test_serve_launcher_runs_the_vlm_and_refuses_the_encoder(capsys):
    """``python -m repro_torch.launch.serve``: the VLM smoke config with
    its memory tokens, and the encoder-only arch's exit (no decode step
    exists), as the reference's launcher."""
    serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "4",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke device=cpu generated=(2, 4)" in out
    with pytest.raises(SystemExit, match="encoder-only arch"):
        serve_cli.main(["--arch", "hubert-xlarge", "--smoke",
                        "--device", "cpu"])


def test_full_config_and_params_across():
    """The full config is the reference's field by field, its layer count
    100 in 20 ``group_sx`` steps; ``params_from_numpy`` carries the
    stacked tree (the 0-d gate stacked to (2,)) with the reference's
    names and bits."""
    jc, tc = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_memory_tokens == 6404 and tc.total_layers() == 100
    assert LM(tc, device="cpu").num_params() == JLM(jc).num_params()
    jm, jp, tm, tp = _models(2)
    names = jax.tree_util.tree_leaves_with_path(jp)
    assert len(names) == len(tree_leaves(tp))
    for (_, want), got in zip(names, tree_leaves(tp)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
