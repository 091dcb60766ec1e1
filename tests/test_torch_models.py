"""The port's model stack against the JAX package's, on the CPU, module by
module: the same seeded numpy inputs and the same weights (JAX-initialized,
moved across with ``params_from_numpy``) through both.  f32 inputs where
the point is the algorithm (tolerances at f32 rounding), the model's own
bf16 compute where the point is the model (tolerances at bf16 rounding,
stated per test)."""

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
from repro.models import LM as JLM
from repro.models.params import count_params as jcount
from repro.models.params import materialize as jmaterialize

import repro_torch.configs as tcfg
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as ttfm
from repro_torch.interop import params_from_numpy, params_to_numpy, to_numpy
from repro_torch.models import LM
from repro_torch.models.params import count_params

ARCHS = ["qwen2.5-3b", "yi-9b", "stablelm-3b", "gemma2-2b"]
#: the SSD and hybrid families (their layers and models: test_torch_ssm.py,
#: test_torch_hybrid.py)
SSM_ARCHS = ["mamba2-780m", "hymba-1.5b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(tree, seed):
    """Zero-initialized norms and biases would hide half the arithmetic:
    give every parameter small random values (same in both packages)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)
                              + rng.standard_normal(a.shape) * 0.1, a.dtype),
        tree)


def _pair(defs, seed=0):
    jp = _randomize(jmaterialize(defs, jax.random.key(seed)), seed)
    return jp, params_from_numpy(_np(jp), "cpu")


def _x(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol, atol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# -- layers --------------------------------------------------------------------

def test_norms():
    x = _x((2, 5, 64))
    g = _x((64,), 1)
    p = {"g": _x((64,), 2), "b": _x((64,), 3)}
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g)), 1e-5, 1e-6)
    _close(tlayers.layer_norm(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in p.items()}),
           jlayers.layer_norm(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()}),
           1e-5, 1e-6)


@pytest.mark.parametrize("rotary_dim", [None, 4], ids=["full", "partial"])
def test_rope(rotary_dim):
    """f32 rotation of positions 0..31: cos/sin of the same f32 angles
    (rtol 1e-5, atol 1e-5)."""
    x = _x((2, 4, 32, 16))
    pos = np.arange(32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                        rotary_dim)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                       rotary_dim)
    _close(got, want, 1e-5, 1e-5)
    if rotary_dim:
        np.testing.assert_array_equal(got[..., rotary_dim:].numpy(),
                                      x[..., rotary_dim:])


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"),
                                       (False, "silu"), (False, "gelu")])
def test_mlp_forward(gated, act):
    jp, tp = _pair(jlayers.mlp_defs(32, 48, gated=gated))
    x = _x((2, 6, 32))
    _close(tlayers.mlp_forward(tp, torch.from_numpy(x), act=act),
           jlayers.mlp_forward(jp, jnp.asarray(x), act=act), 1e-5, 1e-5)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_lookup_is_bf16(scale):
    """A gather and a cast (and a bf16 product with a bf16 sqrt(d)): the
    same bits in both."""
    table = _x((50, 24), scale=1.0)
    toks = np.random.default_rng(0).integers(0, 50, (3, 7))
    want = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(toks), scale)
    got = tlayers.embed_lookup(torch.from_numpy(table),
                               torch.from_numpy(toks), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got, ml_dtypes.bfloat16),
                                  np.asarray(want))


@pytest.mark.parametrize("cap", [None, 30.0])
def test_unembed_chunked(cap):
    table = _x((50, 24), scale=1.0)
    x = _x((3, 1, 24))
    _close(tlayers.unembed_chunked(torch.from_numpy(x),
                                   torch.from_numpy(table), cap),
           jlayers.unembed_chunked(jnp.asarray(x), jnp.asarray(table), cap),
           1e-5, 1e-5)


# -- attention -----------------------------------------------------------------

ATTN_CASES = {
    "q_chunked": dict(q_chunk=8),
    "q_chunked_window_cap": dict(q_chunk=8, window=6, attn_cap=5.0),
    "one_chunk_noncausal": dict(causal=False, q_chunk=512),
    "flash": dict(flash=True, flash_block=16),
    "flash_window_cap": dict(flash=True, flash_block=16, window=6,
                             attn_cap=5.0),
    "flash_partial_rope": dict(flash=True, flash_block=32, rotary_dim=8),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_forward(case):
    """Both routes, f32 (rtol 1e-4, atol 1e-5: f32 sums in another
    order)."""
    jp, tp = _pair(jattn.attn_defs(64, 4, 2, 16, qkv_bias=True))
    x = _x((2, 32, 64))
    kw = dict(n_heads=4, n_kv=2, head_dim=16, **ATTN_CASES[case])
    _close(tattn.attn_forward(tp, torch.from_numpy(x), **kw),
           jattn.attn_forward(jp, jnp.asarray(x), **kw), 1e-4, 1e-5)


@pytest.mark.parametrize("S,pos,window", [(24, 13, None), (8, 13, 8),
                                          (8, 5, 8)],
                         ids=["full", "ring_wrapped", "ring_filling"])
def test_attn_decode(S, pos, window):
    """One step against a bf16 cache: the output at f32 tolerance (rtol
    1e-4, atol 1e-5), and the written slot within one bf16 step."""
    jp, tp = _pair(jattn.attn_defs(64, 4, 2, 16, qkv_bias=True))
    rng = np.random.default_rng(1)
    cache = {n: rng.standard_normal((2, S, 2, 16)).astype(ml_dtypes.bfloat16)
             for n in ("k", "v")}
    x = _x((2, 1, 64))
    kw = dict(n_heads=4, n_kv=2, head_dim=16, window=window, attn_cap=20.0)
    jy, jc = jattn.attn_decode(jp, jnp.asarray(x), {
        n: jnp.asarray(c) for n, c in cache.items()}, jnp.int32(pos), **kw)
    ty, tc = tattn.attn_decode(tp, torch.from_numpy(x),
                               params_from_numpy(cache, "cpu"), pos, **kw)
    _close(ty, jy, 1e-4, 1e-5)
    for n in ("k", "v"):
        _close(tc[n], jc[n], 0.0, 2e-2)
        np.testing.assert_array_equal(
            np.delete(to_numpy(tc[n], ml_dtypes.bfloat16), pos % S, axis=1),
            np.delete(cache[n], pos % S, axis=1))


def test_kv_cache_defs_match():
    for seq_sharded in (False, True):
        assert tattn.init_kv_cache_defs(2, 9, 2, 16, seq_sharded=seq_sharded
                                        )["k"].__dict__ == \
            jattn.init_kv_cache_defs(2, 9, 2, 16, seq_sharded=seq_sharded
                                     )["k"].__dict__


# -- blocks --------------------------------------------------------------------

def _cfgs(arch):
    return (jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch))


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "attn"),
                                       ("stablelm-3b", "attn"),
                                       ("gemma2-2b", "swa"),
                                       ("gemma2-2b", "pair_lg")])
@pytest.mark.parametrize("flash", [False, True])
def test_block_forward(arch, kind, flash):
    """One block in f32 with the prefill k/v it collects (rtol 1e-4, atol
    1e-4: norms and softmax add f32 rounding on top of attention's)."""
    jc, tc = _cfgs(arch)
    jc = dataclasses.replace(jc, flash=flash, flash_block=16)
    tc = dataclasses.replace(tc, flash=flash, flash_block=16)
    jp, tp = _pair(jtfm.block_defs(jc, kind), seed=2)
    x = _x((2, 32, jc.d_model))
    pos = np.arange(32)
    jy, _, jkv = jtfm.block_forward(jc, kind, jp, jnp.asarray(x),
                                    jnp.asarray(pos), collect_kv=True)
    ty, aux, tkv = ttfm.block_forward(tc, kind, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), collect_kv=True)
    _close(ty, jy, 1e-4, 1e-4)
    assert float(aux) == 0.0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jkv),
                                 _leaves(tkv)):
        _close(got, want, 1e-4, 1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in f32 instead of bf16.  In bf16 the two
    frameworks round at different places (XLA may keep excess precision
    inside a fusion; PyTorch rounds every op), one bf16 step on a share of
    a block's outputs, and the random-weight smoke models amplify that
    layer by layer into the final hidden state.  In f32 the comparison
    sees the algorithm, not the rounding."""
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _hidden_pair(arch, seed=0):
    jc, tc = _cfgs(arch)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = _randomize(jm.init(jax.random.key(seed)), seed)
    tp = params_from_numpy(_np(jp), "cpu")
    toks = np.random.default_rng(seed).integers(0, jc.vocab, (2, 32))
    jh, _, _ = jm.hidden(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    th, aux, _ = tm.hidden(tp, {"tokens": torch.from_numpy(toks)})
    assert th.shape == (2, 32, jc.d_model) and float(aux) == 0.0
    return th, jh


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_hidden(arch, f32_compute):
    """The whole stack (embedding, every block, final norm) in f32: rtol
    1e-3 / atol 1e-3 (measured gaps are ~1e-4 at |h| ~ 4)."""
    th, jh = _hidden_pair(arch)
    assert th.dtype == torch.float32
    _close(th, jh, 1e-3, 1e-3)


def test_lm_hidden_bf16_gemma2():
    """In the model's own bf16 compute, on the smoke model whose residual
    stream stays small (post-norms): max|dh| / max|h| < 0.05, the
    reference's own bound for its decode check (measured about 0.02)."""
    th, jh = _hidden_pair("gemma2-2b")
    assert th.dtype == torch.bfloat16
    d = np.abs(th.float().numpy() - np.asarray(jh, np.float32)).max()
    assert d / np.abs(np.asarray(jh, np.float32)).max() < 0.05


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_config_and_param_count(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    jc, tc = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert LM(tc, device="cpu").num_params() == JLM(jc).num_params()
    assert count_params(LM(tc, device="cpu").skeleton()) == \
        jcount(JLM(jc).skeleton())


def test_skeleton_paths_match_the_reference():
    """The parameter tree has the reference's path names and shapes (what
    a checkpoint's ``blocks_map`` keys on)."""
    for arch in ARCHS + SSM_ARCHS:
        jc, tc = _cfgs(arch)
        jsk = JLM(jc).skeleton()
        tsk = LM(tc, device="cpu").skeleton()
        jpaths = {jax.tree_util.keystr(p): d.shape for p, d in
                  jax.tree_util.tree_leaves_with_path(
                      jsk, is_leaf=lambda x: hasattr(x, "init"))}
        tpaths = {}

        def walk(node, name):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{name}[{k!r}]")
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, f"{name}[{i}]")
            else:
                tpaths[name] = node.shape

        walk(tsk, "")
        assert tpaths == jpaths


def test_params_round_trip_numpy():
    jc, tc = _cfgs("gemma2-2b")
    jp = _np(JLM(jc).init(jax.random.key(3)))
    back = params_to_numpy(params_from_numpy(jp, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_materialize_laws():
    """Seeded draws follow the reference's init laws (not its numbers)."""
    tm = LM(tcfg.get_config("qwen2.5-3b"), device="cpu")
    sk = tm.skeleton()
    small = {"embed": sk["embed"].__class__((4096, 64), ("vocab", "embed"),
                                           init="normal", scale=1.0),
             "wq": sk["segments"][0]["attn"]["wq"].__class__(
                 (256, 4, 16), ("embed", "heads", "head_dim"), init="fan_in"),
             "norm": sk["final_norm"]}
    from repro_torch.models.params import materialize
    p = materialize(small, torch.Generator().manual_seed(0))
    assert abs(float(p["embed"].std()) - 1.0) < 0.02
    # fan_in is shape[-2], the heads axis of a (d_model, heads, head_dim)
    # projection, exactly as in the reference
    assert abs(float(p["wq"].std()) - 1 / 4 ** 0.5) < 0.01
    assert torch.equal(p["norm"], torch.zeros(2048))
    q = materialize(small, torch.Generator().manual_seed(0))
    assert torch.equal(p["wq"], q["wq"])


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_every_reference_arch_is_registered(arch):
    """Every arch of the JAX package's registry is in the port's, in the
    same order, its config and smoke config equal field by field, with
    the same shape cells and skip reasons."""
    assert tcfg.list_archs() == jcfg.list_archs()
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tcfg, get)(arch)) == \
            dataclasses.asdict(getattr(jcfg, get)(arch))
    assert [dataclasses.asdict(c) for c in tcfg.shapes_for(arch)] == \
        [dataclasses.asdict(c) for c in jcfg.shapes_for(arch)]
    for cell in jcfg.shapes_for(arch):
        assert tcfg.skip_reason(arch, cell.name) == \
            jcfg.skip_reason(arch, cell.name)


def _fan_in(tree, cfg):
    """Attention projections at fan-in over the axes their products
    contract, every cross-attention gate 0.5 (the reference's zero gate
    would hide the memory)."""
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
    if "gate" in tree:
        tree["gate"] = np.full_like(tree["gate"], 0.5)
    return tree


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_smoke_loss_parity(arch, f32_compute, monkeypatch):
    """``LM.loss`` (and its ``ce`` and ``aux`` terms) on every reference
    smoke config against the reference's, in f32 compute on the same
    weights (attention at true fan-in) and batch: rtol 1e-5.  hubert's
    frames stay f32 in both packages (each casts them to bf16 otherwise);
    the VLM gets bf16 memory tokens, as its launcher draws them."""
    monkeypatch.setattr(JLM, "_embed_in", lambda self, params, batch:
                        batch["frames"].astype(jnp.float32)
                        if "frames" in batch else
                        jlayers.embed_lookup(params["embed"],
                                             batch["tokens"],
                                             scale=self.cfg.embed_scale))
    monkeypatch.setattr(LM, "_embed_in", lambda self, params, batch:
                        batch["frames"].float() if "frames" in batch else
                        tlayers.embed_lookup(params["embed"],
                                             batch["tokens"],
                                             scale=self.cfg.embed_scale))
    jc, tc = _cfgs(arch)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = jax.tree_util.tree_map(
        jnp.asarray, _fan_in(_np(jm.init(jax.random.key(0))), jc))
    tp = params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(0)
    b = {"labels": rng.integers(0, jc.vocab, (2, 32)).astype(np.int32)}
    if jc.frontend == "frames":
        b["frames"] = (rng.standard_normal((2, 32, jc.d_model)) * 0.1
                       ).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, jc.vocab, (2, 32)).astype(np.int32)
    if jc.n_memory_tokens:
        b["memory"] = (rng.standard_normal(
            (2, jc.n_memory_tokens, jc.d_model)) * 0.5).astype(
                ml_dtypes.bfloat16)
    jloss, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, tmet = tm.loss(tp, params_from_numpy(b, "cpu"))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
