"""The port's SSD and hybrid layer kinds and the mamba2-780m and hymba-1.5b
smoke models against the JAX package's, on the CPU: the same weights
(JAX-initialized with small random offsets, moved across with
``params_from_numpy``) and the same seeded inputs through both, in f32
compute (see ``f32_compute``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.layers as jlayers
import repro.models.transformer as jtfm
from repro.models import LM as JLM
from repro.models.params import materialize as jmaterialize
from repro.serve import ServeEngine as JServeEngine
from repro.serve import flatten_cache as jflatten_cache

import repro_torch.configs as tcfg
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as ttfm
from repro_torch.interop import params_from_numpy
from repro_torch.models import LM
from repro_torch.models.layers import unembed_chunked
from repro_torch.serve import ServeEngine, flatten_cache

ARCHS = ["mamba2-780m", "hymba-1.5b"]
#: f32 blocks: norms, softmax and the SSD's exp/cumsum add f32 rounding
BLOCK_TOL = (1e-4, 1e-4)
#: logits of the whole smoke model, prefill and each decode step (f32
#: compute; the bf16 KV and conv caches each package rounds on its own)
LOGIT_TOL = 2e-2
#: a bf16 cache leaf: the same f32 value up to f32 rounding, rounded once
#: to bf16, so one bf16 step at most (rtol 2^-7; atol for values near 0)
BF16_TOL = (2 ** -7, 1e-4)
#: an f32 cache leaf (the SSM state) of one block
STATE_TOL = (1e-3, 1e-4)
#: any cache leaf after the whole stack and decode steps: the sources
#: differ by up to the whole stack's f32 gap (``test_lm_hidden``'s atol
#: 1e-3), and each decode step reads the conv window each package rounded
#: to bf16 on its own, so a leaf, the f32 state too, may differ by a bf16
#: step of its inputs
STACK_TOL = (2 ** -7, 1e-3)
#: logit tolerance along a greedy path (as ``tests/test_torch_serve.py``)
GREEDY_TOL = 1e-3


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in f32 instead of bf16 (in bf16 they round at
    different places and the random smoke models amplify it)."""
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)
                              + rng.standard_normal(a.shape) * 0.1, a.dtype),
        tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol[0],
                               atol=tol[1])


def _close_cache(tflat, jflat, tol=None):
    """Every leaf of the cache trees: ``tol``, or BF16_TOL for a bf16 leaf
    and STATE_TOL for an f32 one."""
    assert sorted(tflat) == sorted(jflat)
    for name, want in jflat.items():
        got = tflat[name]
        assert got.shape == want.shape and str(got.dtype).endswith(
            str(want.dtype)), (name, got.dtype, want.dtype)
        _close(got, want, tol or (BF16_TOL if got.dtype == torch.bfloat16
                                  else STATE_TOL))


# -- blocks ---------------------------------------------------------------------

BLOCKS = [("mamba2-780m", "ssd", False), ("hymba-1.5b", "hyb_full", False),
          ("hymba-1.5b", "hyb_swa", False), ("hymba-1.5b", "hyb_full", True),
          ("hymba-1.5b", "hyb_swa", True)]


@pytest.mark.parametrize("arch,kind,flash", BLOCKS,
                         ids=[f"{k}-{'flash' if f else 'q_chunked'}"
                              for _, k, f in BLOCKS])
def test_block_forward_prefill_decode(arch, kind, flash, f32_compute):
    """One block in f32: the forward (rtol/atol 1e-4) with the k/v and SSM
    state it collects, that state turned into the cache (``block_prefill``:
    a ring for ``hyb_swa``, whose window of 8 is shorter than the 32
    tokens), then one ``block_decode`` step from that cache."""
    over = dict(flash=flash, flash_block=16)
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jdefs = jtfm.block_defs(jc, kind)
    assert [d.__dict__ for d in _leaves(ttfm.block_defs(tc, kind))] == \
        [d.__dict__ for d in jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "init"))]
    jp = _randomize(jmaterialize(jdefs, jax.random.key(2)), 2)
    tp = params_from_numpy(_np(jp), "cpu")
    B, L = 2, 32
    x = (np.random.default_rng(0).standard_normal((B, L, jc.d_model)) * 0.5
         ).astype(np.float32)
    pos = np.arange(L)
    jy, _, jkv = jtfm.block_forward(jc, kind, jp, jnp.asarray(x),
                                    jnp.asarray(pos), collect_kv=True)
    ty, aux, tkv = ttfm.block_forward(tc, kind, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), collect_kv=True)
    _close(ty, jy, BLOCK_TOL)
    assert float(aux) == 0.0
    jl, tl = jax.tree_util.tree_leaves(jkv), _leaves(tkv)
    assert len(jl) == len(tl)
    for got, want in zip(tl, jl):
        _close(got, want, BF16_TOL if got.dtype == torch.bfloat16
               else BLOCK_TOL)
    _close(ttfm.block_forward(tc, kind, tp, torch.from_numpy(x),
                              torch.from_numpy(pos))[0], jy, BLOCK_TOL)

    cache_len = L + 8
    jdefs = jtfm.block_cache_defs(jc, kind, B, cache_len)
    tdefs = ttfm.block_cache_defs(tc, kind, B, cache_len)
    assert [d.__dict__ for d in _leaves(tdefs)] == \
        [d.__dict__ for d in jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "init"))]
    jcache = jtfm.block_prefill(jc, kind, jkv, jdefs, B, L)
    tcache = ttfm.block_prefill(tc, kind, tkv, tdefs, B, L)
    _close_cache(flatten_cache(tcache), jflatten_cache(jcache))
    if kind == "hyb_swa":
        assert tcache["attn"]["k"].shape[1] == tc.window < L

    x1 = (np.random.default_rng(1).standard_normal((B, 1, jc.d_model)) * 0.5
          ).astype(np.float32)
    jy1, jcache = jtfm.block_decode(jc, kind, jp, jnp.asarray(x1), jcache,
                                    jnp.int32(L))
    ty1, tcache = ttfm.block_decode(tc, kind, tp, torch.from_numpy(x1),
                                    tcache, L)
    _close(ty1, jy1, BLOCK_TOL)
    _close_cache(flatten_cache(tcache), jflatten_cache(jcache))


# -- whole models ---------------------------------------------------------------

def _models(arch, seed=0, **over):
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = _randomize(jm.init(jax.random.key(seed)), seed)
    return jm, jp, tm, params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_hidden(arch, f32_compute):
    """The whole stack in f32: rtol 1e-3 / atol 1e-3, as the dense
    decoders' (``tests/test_torch_models.py``)."""
    jm, jp, tm, tp = _models(arch)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 40))
    jh, _, _ = jm.hidden(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    th, aux, _ = tm.hidden(tp, {"tokens": torch.from_numpy(toks)})
    assert th.dtype == torch.float32 and float(aux) == 0.0
    _close(th, jh, (1e-3, 1e-3))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flash", [False, True], ids=["q_chunked", "flash"])
def test_prefill_and_decode_steps_match(arch, flash, f32_compute):
    """Prefill 36 tokens into a 44-slot cache (hymba's windowed layers keep
    a ring of 8, already wrapped), then 4 decode steps: the prefill logits
    and each step's logits within LOGIT_TOL of the reference's, and the
    whole cache tree (names, shapes, dtypes; every leaf within STACK_TOL)
    after the prefill and after each step."""
    jm, jp, tm, tp = _models(arch, seed=1, flash=flash, flash_block=12)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, (2, 40))
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :36],
                                                       jnp.int32)},
                            cache_len=44)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :36])},
                            cache_len=44)
    _close(tl, jl, (LOGIT_TOL, LOGIT_TOL))
    _close_cache(flatten_cache(tcache), jflatten_cache(jcache),
                 STACK_TOL)
    for i in range(36, 40):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(
            toks[:, i:i + 1], jnp.int32), jnp.int32(i))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(
            toks[:, i:i + 1]), i)
        _close(tl, jl, (LOGIT_TOL, LOGIT_TOL))
        _close_cache(flatten_cache(tcache), jflatten_cache(jcache),
                     STACK_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_the_reference(arch, f32_compute):
    """Greedy generation gives the reference's tokens, with the same
    guard against near-ties as the dense decoders' test: along the
    reference's path both packages' logits agree within GREEDY_TOL and the
    reference's top-two margin exceeds twice that at every step."""
    jm, jp, tm, tp = _models(arch, seed=2)
    prompts = np.random.default_rng(2).integers(0, jm.cfg.vocab, (2, 12))
    n = 8
    want, _ = JServeEngine(jm, jp, max_len=32).generate(prompts, n)
    got, stats = ServeEngine(tm, tp, max_len=32, device="cpu").generate(
        prompts, n)
    assert got.dtype == np.int32 and got.shape == (2, n)
    assert stats.tokens_generated == 2 * n
    path = np.concatenate([prompts, np.asarray(want)], axis=1)[:, :-1]
    jh, _, _ = jm.hidden(jp, {"tokens": jnp.asarray(path, jnp.int32)})
    jlog = np.asarray(jlayers.unembed_chunked(jh[:, -n:], jp["embed"]))
    th, _, _ = tm.hidden(tp, {"tokens": torch.from_numpy(path)})
    tlog = unembed_chunked(th[:, -n:], tp["embed"]).numpy()
    assert np.abs(tlog - jlog).max() < GREEDY_TOL
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * GREEDY_TOL
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_the_stacked_cache(arch):
    """``decode_step`` keeps the stacked cache it was given (it discards a
    stacked segment's returned caches), so every layer's S and conv must
    change in place: two steps from one prefill differ from one step."""
    tc = tcfg.get_smoke_config(arch)
    model = LM(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tc.vocab, (2, 10)))
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": toks[:, :8]},
                                 cache_len=10)
        before = {k: v.clone() for k, v in flatten_cache(cache).items()}
        model.decode_step(params, cache, toks[:, 8:9], 8)
        after = flatten_cache(cache)
    moved = [k for k in before if k.endswith(("/S", "/conv"))]
    assert moved and all(not torch.equal(before[k], after[k]) for k in moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    """The full configs' parameter counts equal the reference's (and land
    on their nameplates)."""
    jm, tm = JLM(jcfg.get_config(arch)), LM(tcfg.get_config(arch),
                                           device="cpu")
    assert tm.num_params() == jm.num_params()
    lo, hi = {"mamba2-780m": (0.7e9, 0.9e9),
              "hymba-1.5b": (1.2e9, 1.8e9)}[arch]
    assert lo <= tm.num_params() <= hi
