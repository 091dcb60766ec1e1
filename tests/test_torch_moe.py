"""The port's MoE block (``models/moe.py``, the kind ``moe``) and the
deepseek-moe-16b and arctic-480b smoke models against the JAX package's,
on the CPU: the same weights (JAX-initialized, moved across with
``params_from_numpy``) and the same seeded inputs through both, in f32
compute (see ``f32_compute``).  Routing is discrete, so the experts each
token picks and the dispatch buffer must be bit-equal; the arithmetic is
held to f32 tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.layers as jlayers
import repro.models.moe as jmoe
import repro.models.transformer as jtfm
from repro.models import LM as JLM
from repro.models.params import materialize as jmaterialize
from repro.serve import flatten_cache as jflatten_cache

import repro_torch.configs as tcfg
import repro_torch.models.layers as tlayers
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttfm
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import LM
from repro_torch.models.params import tree_leaves
from repro_torch.serve import flatten_cache
from repro_torch.train.trainer import value_and_grad

ARCHS = ["deepseek-moe-16b", "arctic-480b"]
#: block dims of each family: deepseek's shared experts, arctic's top-2
DIMS = {"deepseek": dict(d_model=32, d_ff=16, n_experts=8, top_k=3,
                         n_shared=2),
        "arctic": dict(d_model=32, d_ff=32, n_experts=8, top_k=2)}
#: capacity factors: one that drops tokens at T = 48, the configs' own,
#: and one that drops none
CAPACITY = {"drops": 0.5, "default": 1.25, "no_drops": 16.0}
#: f32 on both sides, sums in another order
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in f32 instead of bf16 (in bf16 the two
    frameworks round at different places)."""
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dims(name, **over):
    kw = dict(DIMS[name], **over)
    return jmoe.MoEDims(**kw), tmoe.MoEDims(**kw)


def _block_params(jd, seed=0):
    jp = jmaterialize(jmoe.moe_defs(jd), jax.random.key(seed))
    return jp, params_from_numpy(_np(jp), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# -- routing and dispatch ------------------------------------------------------

@pytest.mark.parametrize("name", list(DIMS))
def test_dims_and_defs_match(name):
    jd, td = _dims(name)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    jdefs = jax.tree_util.tree_leaves(jmoe.moe_defs(jd),
                                      is_leaf=lambda d: hasattr(d, "init"))
    assert [d.__dict__ for d in tree_leaves(tmoe.moe_defs(td))] == \
        [d.__dict__ for d in jdefs]


def test_capacity_matches():
    for name in DIMS:
        for cf in CAPACITY.values():
            jd, td = _dims(name, capacity_factor=cf)
            for T in (1, 7, 48, 1000, 8192):
                assert tmoe._capacity(T, td) == jmoe._capacity(T, jd)


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("name", list(DIMS))
def test_route_matches(name, renorm):
    """The f32 router: the same experts in the same order (bit-equal),
    the gate weights (renormalized or not) and the switch aux loss at
    rtol 1e-5."""
    jd, td = _dims(name, renorm_topk=renorm)
    jp, tp = _block_params(jd)
    xf = _x((48, 32))
    jw, je, ja = jmoe._route(jp, jnp.asarray(xf), jd)
    tw, te, ta = tmoe._route(tp, torch.from_numpy(xf), td)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tw, jw)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL)


def test_positions_count_earlier_choices_in_token_order():
    e = torch.tensor([2, 0, 2, 1, 2, 0, 1, 1])
    want, seen = [], {}
    for x in e.tolist():
        want.append(seen.get(x, 0))
        seen[x] = seen.get(x, 0) + 1
    assert tmoe._positions(e, 3).tolist() == want


def _capture(monkeypatch, module, store):
    """Record the dispatch buffer ``module._expert_ffn`` is given and what
    it returns."""
    inner = module._expert_ffn

    def spy(p, h, x_dtype):
        out = inner(p, h, x_dtype)
        store.update(disp=h, out=out)
        return out
    monkeypatch.setattr(module, "_expert_ffn", spy)


@pytest.mark.parametrize("cap", list(CAPACITY))
@pytest.mark.parametrize("name", list(DIMS))
def test_dispatch_and_combine_match(name, cap, monkeypatch):
    """``moe_forward`` on 48 tokens: the (E, C, M) dispatch buffer the
    experts get is bit-equal to the reference's (each kept choice in its
    expert's slot by token order, dropped ones nowhere), the experts'
    outputs, and the combined output and aux loss at rtol 1e-5; with the
    low capacity factor some choices are dropped, with the high none."""
    jd, td = _dims(name, capacity_factor=CAPACITY[cap])
    jp, tp = _block_params(jd, seed=1)
    x = _x((2, 24, 32), seed=1)
    ref, port = {}, {}
    _capture(monkeypatch, jmoe, ref)
    _capture(monkeypatch, tmoe, port)
    jy, ja = jmoe.moe_forward(jp, jnp.asarray(x), jd)
    ty, ta = tmoe.moe_forward(tp, torch.from_numpy(x), td)
    assert port["disp"].shape == ref["disp"].shape
    np.testing.assert_array_equal(port["disp"].numpy(),
                                  np.asarray(ref["disp"]))
    _close(port["out"], ref["out"])
    _close(ty, jy)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL)
    _, te, _ = tmoe._route(tp, torch.from_numpy(x.reshape(48, 32)), td)
    C = tmoe._capacity(48, td)
    dropped = int((tmoe._positions(te.reshape(-1), td.n_experts) >= C)
                  .sum())
    if cap == "drops":
        assert dropped > 0
    if cap == "no_drops":
        assert dropped == 0


@pytest.mark.parametrize("name", list(DIMS))
def test_local_dispatch_takes_the_gather_path(name):
    """Without a mesh ``dispatch="local"`` is the gather path, as the
    reference's is without a sharding context."""
    jd, td = _dims(name)
    _, tp = _block_params(jd)
    x = torch.from_numpy(_x((2, 24, 32)))
    y0, a0 = tmoe.moe_forward(tp, x, td)
    y1, a1 = tmoe.moe_forward(tp, x, dataclasses.replace(td,
                                                         dispatch="local"))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_a2a_dispatch_takes_the_gather_path(monkeypatch):
    """The reference has no body for ``dispatch="a2a"``: it takes the
    gather path (``moe_forward`` branches on ``"local"`` alone).  The port
    does the same: the dispatch buffer bit-equal to the reference's, the
    experts' outputs, the output and aux loss at rtol 1e-5, as
    ``test_dispatch_and_combine_match`` holds the gather path."""
    jd, td = _dims("deepseek", dispatch="a2a",
                   capacity_factor=CAPACITY["drops"])
    jp, tp = _block_params(jd, seed=1)
    x = _x((2, 24, 32), seed=1)
    ref, port = {}, {}
    _capture(monkeypatch, jmoe, ref)
    _capture(monkeypatch, tmoe, port)
    jy, ja = jmoe.moe_forward(jp, jnp.asarray(x), jd)
    ty, ta = tmoe.moe_forward(tp, torch.from_numpy(x), td)
    np.testing.assert_array_equal(port["disp"].numpy(),
                                  np.asarray(ref["disp"]))
    _close(port["out"], ref["out"])
    _close(ty, jy)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL)
    y0, a0 = tmoe.moe_forward(tp, torch.from_numpy(x), dataclasses.replace(
        td, dispatch="gather"))
    assert torch.equal(ty, y0) and torch.equal(ta, a0)


# -- the block -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_block_forward_prefill_decode(arch, f32_compute):
    """One ``moe`` block (attention + MoE FFN; arctic's dense residual
    beside it) in f32, attention at fan-in (``_fan_in``): defs, the
    forward (rtol 1e-4 / atol 1e-5) and its aux loss, the k/v it collects
    turned into the cache, then one decode step."""
    jc, tc = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jdefs = jtfm.block_defs(jc, "moe")
    assert [d.__dict__ for d in tree_leaves(ttfm.block_defs(tc, "moe"))] \
        == [d.__dict__ for d in jax.tree_util.tree_leaves(
            jdefs, is_leaf=lambda d: hasattr(d, "init"))]
    assert ("dense" in jdefs) == jc.dense_residual
    jp = jax.tree_util.tree_map(jnp.asarray, _fan_in(_np(jmaterialize(
        jdefs, jax.random.key(2))), jc))
    tp = params_from_numpy(_np(jp), "cpu")
    B, L = 2, 16
    x = _x((B, L, jc.d_model), seed=2) * np.float32(0.5)
    pos = np.arange(L)
    jy, ja, jkv = jax.jit(lambda p, h: jtfm.block_forward(
        jc, "moe", p, h, jnp.asarray(pos), collect_kv=True))(
            jp, jnp.asarray(x))
    ty, ta, tkv = ttfm.block_forward(tc, "moe", tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), collect_kv=True)
    _close(ty, jy, 1e-4, 1e-5)
    assert float(ta) > 0
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL)
    for got, want in zip(tree_leaves(tkv), jax.tree_util.tree_leaves(jkv)):
        _close(got, want, 1e-4, 1e-5)
    jdefs = jtfm.block_cache_defs(jc, "moe", B, L + 4)
    tdefs = ttfm.block_cache_defs(tc, "moe", B, L + 4)
    jcache = jtfm.block_prefill(jc, "moe", jkv, jdefs, B, L)
    tcache = ttfm.block_prefill(tc, "moe", tkv, tdefs, B, L)
    x1 = _x((B, 1, jc.d_model), seed=3) * np.float32(0.5)
    jy1, jcache = jax.jit(lambda p, h, c: jtfm.block_decode(
        jc, "moe", p, h, c, jnp.int32(L)))(jp, jnp.asarray(x1), jcache)
    ty1, tcache = ttfm.block_decode(tc, "moe", tp, torch.from_numpy(x1),
                                    tcache, L)
    _close(ty1, jy1, 1e-4, 1e-5)
    jflat, tflat = jflatten_cache(jcache), flatten_cache(tcache)
    assert sorted(tflat) == sorted(jflat)
    for name, want in jflat.items():
        _close(tflat[name], want, 2 ** -7, 1e-4)   # bf16 KV: one step


# -- whole models --------------------------------------------------------------

def _fan_in(tree, cfg):
    """Attention projections rescaled to fan-in over the axes their
    products contract (as ``tests/test_torch_train.py`` does: under the
    reference's init most attention rows are an argmax and f32 rounding
    flips near-ties)."""
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


def _models(arch, seed=0, **moe_over):
    jc, tc = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    if moe_over:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_over))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_over))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_aux_and_grads(arch, f32_compute):
    """``LM.loss`` on the smoke config against
    ``jax.value_and_grad(model.loss)``: the loss, its cross-entropy and
    the blocks' summed aux loss (positive: every layer routes) at rtol
    1e-5, every parameter's gradient — routers and experts included — at
    rtol 1e-4 / atol 1e-5, as the dense decoders'."""
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batch(jm.cfg.vocab)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    loss, met, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=RTOL)
    assert float(met["aux"]) > 0
    want = jax.tree_util.tree_leaves(jg)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


def test_local_dispatch_loss_matches_the_reference_mesh(f32_compute):
    """The twin of ``tests/test_optimized_paths.py``'s check: the
    reference's ``local`` dispatch under a (1, 1) mesh and the port's
    ``local`` (the gather path on one rank) give the gather path's loss,
    at capacity factor 16 (no drops)."""
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh_compat
    jm, jp, tm, tp = _models("deepseek-moe-16b", seed=2,
                             capacity_factor=16.0)
    local = dict(capacity_factor=16.0, dispatch="local")
    jml, _, tml, _ = _models("deepseek-moe-16b", seed=2, **local)
    jb, tb = _batch(jm.cfg.vocab, seed=2)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    with shd.use_sharding(mesh, shd.DEFAULT_RULES):
        jl, _ = jax.jit(jml.loss)(jp, jb)
    with torch.no_grad():
        l0, _ = tm.loss(tp, tb)
        ll, _ = tml.loss(tp, tb)
    assert torch.equal(l0, ll)
    assert abs(float(ll) - float(jl)) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, f32_compute):
    """Prefill 16 tokens into a 20-slot cache, then 2 decode steps, at
    capacity factor 16 (so the forward and the decode drop nothing, as
    the reference's own decode test sets it): the logits of each within
    2e-2 of the reference's (``tests/test_torch_serve.py``'s bound)."""
    jm, jp, tm, tp = _models(arch, seed=1, capacity_factor=16.0)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, (2, 18))
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16],
                                                       jnp.int32)},
                            cache_len=20)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                            cache_len=20)
    _close(tl, jl, 2e-2, 2e-2)
    for i in (16, 17):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(
            toks[:, i:i + 1], jnp.int32), jnp.int32(i))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(
            toks[:, i:i + 1]), i)
        _close(tl, jl, 2e-2, 2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    """The full configs' parameter counts equal the reference's and land
    in its ranges (``tests/test_models.py``)."""
    jm, tm = JLM(jcfg.get_config(arch)), LM(tcfg.get_config(arch),
                                           device="cpu")
    assert tm.num_params() == jm.num_params()
    lo, hi = {"deepseek-moe-16b": (1.4e10, 1.8e10),
              "arctic-480b": (4.3e11, 5.2e11)}[arch]
    assert lo <= tm.num_params() <= hi


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_moe_smoke_configs(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "4",
                    "--device", "cpu"])
    assert f"arch={arch}-smoke device=cpu generated=(2, 4)" in \
        capsys.readouterr().out
    train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                    "--global-batch", "2", "--seq-len", "16",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("loss "))
    assert f"arch={arch}-smoke device=cpu" in out
    assert np.isfinite([float(w) for w in line.split()[1::2]]).all()
