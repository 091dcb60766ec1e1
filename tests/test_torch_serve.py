"""The port's serving path against the JAX package's, on the CPU: prefill
logits on both attention routes, decode against a full forward, greedy
generation token for token, and the KV-cache accounting and names.  The
same weights (JAX-initialized, moved across with ``params_from_numpy``)
and the same seeded prompts go to both."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.layers as jlayers
from repro.models import LM as JLM
from repro.serve import ServeEngine as JServeEngine
from repro.serve import cache_bytes as jcache_bytes
from repro.serve import cache_spec_summary as jcache_spec_summary
from repro.serve import flatten_cache as jflatten_cache

import repro_torch.configs as tcfg
import repro_torch.models.layers as tlayers
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM
from repro_torch.models.layers import unembed_chunked
from repro_torch.serve import (ServeEngine, cache_bytes, cache_spec_summary,
                               flatten_cache)

ARCHS = ["qwen2.5-3b", "yi-9b", "stablelm-3b", "gemma2-2b", "mamba2-780m",
         "hymba-1.5b", "deepseek-moe-16b"]
#: logit tolerance of the cross-package checks (f32 compute, see below)
RTOL = ATOL = 2e-2
#: logit tolerance along a greedy path (f32 compute; measured gaps ~1e-4)
GREEDY_TOL = 1e-3


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in f32 instead of bf16 for the cross-package
    checks.  In bf16 the frameworks round at different places (one bf16
    step on some outputs of every block) and the 4-layer smoke models
    amplify that to 3-14% of the largest prefill logit of qwen2.5-3b smoke,
    which can flip a greedy token; in f32 the same logits agree to ~1e-4."""
    monkeypatch.setattr(jlayers, "_COMPUTE", jnp.float32)
    monkeypatch.setattr(tlayers, "_COMPUTE", torch.float32)


def _models(arch, seed=0, **over):
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b"])
@pytest.mark.parametrize("flash", [False, True], ids=["q_chunked", "flash"])
def test_prefill_logits_match(arch, flash, f32_compute):
    """Last-position prefill logits within rtol 2e-2 / atol 2e-2 of the
    reference's, on the flash route (``flash_block=16`` at L=32) and the
    q-chunked one; the bf16 prefill caches agree to about one bf16 step
    (rtol 2^-7, and atol 1e-4 for the values under 1e-2 whose f32 sources
    round to neighbouring bf16 values)."""
    jm, jp, tm, tp = _models(arch, flash=flash, flash_block=16)
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 32))
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            cache_len=40)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            cache_len=40)
    assert tl.shape == (2, 1, jm.cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    jflat, tflat = jflatten_cache(jcache), flatten_cache(tcache)
    assert sorted(jflat) == sorted(tflat)
    for name, want in jflat.items():
        got = tflat[name]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-4)


def test_prefill_logits_match_at_head_dim_256(f32_compute):
    """gemma2-2b's attention at its own head_dim of 256 on the flash route:
    a two-layer ``pair_lg`` model (one local layer under a window of 96,
    one global; softcap 50, narrow d_model 64) prefilling 256 tokens in
    two 128-row flash blocks.  Its last-position logits are within rtol
    2e-2 / atol 2e-2 of the reference's, whose flash prefill runs the
    Pallas forward in interpret mode (the port's CPU route runs the plain
    version that the head_dim-256 kernel is held to on the card)."""
    over = dict(n_layers=2, program=(("pair_lg", 1),), head_dim=256,
                window=96, flash=True, flash_block=128)
    jm, jp, tm, tp = _models("gemma2-2b", seed=2, **over)
    assert jm.cfg.head_dim == 256 and jm.cfg.attn_cap == 50.0
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (2, 256))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, jm.cfg.vocab) and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(L) + decode(token L) == forward(L+1) at the last position,
    in the port alone and its bf16 compute: the reference's own check and
    bound, max|d| / max|ref| < 0.05 (``tests/test_models.py``), and its
    capacity factor of 16 for MoE, so the forward over L+1 tokens and the
    prefill over L drop no token."""
    tc = tcfg.get_smoke_config(arch)
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=16.0))
    model = LM(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, L = 2, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tc.vocab, (B, L + 1)))
    with torch.inference_mode():
        h, _, _ = model.hidden(params, {"tokens": toks})
        ref = unembed_chunked(h[:, -1:], params.get("lm_head",
                                                     params["embed"]),
                              final_cap=tc.final_cap)
        _, cache = model.prefill(params, {"tokens": toks[:, :L]},
                                 cache_len=L + 1)
        dec, _ = model.decode_step(params, cache, toks[:, L:L + 1], L)
    diff = float((dec - ref).abs().max())
    scale = float(ref.abs().max()) + 1e-9
    assert diff / scale < 0.05, (arch, diff, scale)


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 0), ("yi-9b", 1)])
def test_greedy_tokens_match_the_reference(arch, seed, f32_compute):
    """Greedy generation gives the reference's tokens.  Along the
    reference's greedy path both packages' next-token logits agree within
    GREEDY_TOL, and the reference's top-two margin exceeds twice that at
    every step, so a near-tie cannot flip a token and pass unnoticed."""
    jm, jp, tm, tp = _models(arch, seed=seed)
    prompts = np.random.default_rng(seed).integers(0, jm.cfg.vocab, (2, 12))
    n = 8
    want, _ = JServeEngine(jm, jp, max_len=32).generate(prompts, n)
    got, stats = ServeEngine(tm, tp, max_len=32, device="cpu").generate(
        prompts, n)
    assert got.dtype == np.int32 and got.shape == (2, n)
    assert stats.tokens_generated == 2 * n and stats.prefill_seconds > 0
    path = np.concatenate([prompts, np.asarray(want)], axis=1)[:, :-1]
    jh, _, _ = jm.hidden(jp, {"tokens": jnp.asarray(path, jnp.int32)})
    jlog = np.asarray(jlayers.unembed_chunked(
        jh[:, -n:], jp.get("lm_head", jp.get("embed")),
        final_cap=jm.cfg.final_cap))
    th, _, _ = tm.hidden(tp, {"tokens": torch.from_numpy(path)})
    tlog = unembed_chunked(th[:, -n:], tp.get("lm_head", tp["embed"]),
                           final_cap=tm.cfg.final_cap).numpy()
    assert np.abs(tlog - jlog).max() < GREEDY_TOL
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * GREEDY_TOL
    np.testing.assert_array_equal(got, np.asarray(want))


def test_temperature_sampling_draws_from_the_generator():
    tc = tcfg.get_smoke_config("qwen2.5-3b")
    model = LM(tc, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServeEngine(model, params, max_len=24, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tc.vocab, (3, 8))
    a, _ = engine.generate(prompts, 8, temperature=1.0,
                           generator=torch.Generator().manual_seed(7))
    b, _ = engine.generate(prompts, 8, temperature=1.0,
                           generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < tc.vocab
    g, _ = engine.generate(prompts, 8)
    np.testing.assert_array_equal(g, engine.generate(prompts, 8)[0])
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(prompts, 17)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,cache_len", [(1, 1024), (4, 64)])
def test_cache_accounting_matches(arch, batch, cache_len):
    jm = JLM(jcfg.get_smoke_config(arch))
    tm = LM(tcfg.get_smoke_config(arch), device="cpu")
    assert cache_bytes(tm, batch, cache_len) == \
        jcache_bytes(jm, batch, cache_len)
    assert cache_spec_summary(tm, batch, cache_len) == \
        jcache_spec_summary(jm, batch, cache_len)


def test_full_config_cache_bytes():
    """qwen2.5-3b at the chip run's batch: 36 layers x k, v x (4, 2080, 2,
    128) bf16."""
    tm = LM(tcfg.get_config("qwen2.5-3b"), device="cpu")
    assert cache_bytes(tm, 4, 2080) == 36 * 2 * 4 * 2080 * 2 * 128 * 2 == \
        jcache_bytes(JLM(jcfg.get_config("qwen2.5-3b")), 4, 2080)


def test_gemma2_full_config_cache_bytes():
    """gemma2-2b at the chip run's batch: 26 layers x k, v x (4, 2080, 4,
    256) bf16 (the local layers' ring of 4096 slots is cut to the 2080 the
    run needs)."""
    tm = LM(tcfg.get_config("gemma2-2b"), device="cpu")
    assert cache_bytes(tm, 4, 2080) == 26 * 2 * 4 * 2080 * 4 * 256 * 2 == \
        jcache_bytes(JLM(jcfg.get_config("gemma2-2b")), 4, 2080)


def test_ssm_full_config_cache_bytes():
    """mamba2-780m's cache is its state, whatever the cache length: 48
    layers x (f32 S (4, 48, 128, 64) + bf16 conv (4, 3, 3328)).  hymba-1.5b
    at the chip run's batch: 3 full layers' KV of 2080 slots, 29 windowed
    layers' rings of 1024, and every layer's state."""
    tm = LM(tcfg.get_config("mamba2-780m"), device="cpu")
    ssm = 48 * (4 * 48 * 128 * 64 * 4 + 4 * 3 * 3328 * 2)
    assert cache_bytes(tm, 4, 2080) == cache_bytes(tm, 4, 256) == ssm == \
        jcache_bytes(JLM(jcfg.get_config("mamba2-780m")), 4, 2080)
    tm = LM(tcfg.get_config("hymba-1.5b"), device="cpu")
    kv = 2 * 4 * 5 * 64 * 2
    state = 4 * 25 * 16 * 64 * 4 + 4 * 3 * (1600 + 32) * 2
    assert cache_bytes(tm, 4, 2080) == 3 * 2080 * kv + 29 * 1024 * kv + \
        32 * state == jcache_bytes(JLM(jcfg.get_config("hymba-1.5b")), 4,
                                   2080)
    assert cache_spec_summary(tm, 4, 2080) == jcache_spec_summary(
        JLM(jcfg.get_config("hymba-1.5b")), 4, 2080)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_serve_launcher_offers_the_ssm_archs(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "4",
                    "--device", "cpu"])
    assert f"arch={arch}-smoke device=cpu generated=(2, 4)" in \
        capsys.readouterr().out


def test_serve_batched_example_runs_on_cpu(tmp_path, capsys):
    """The twin of ``examples/serve_batched.py``: the four smoke configs
    serve, and the live serving state (qwen2.5-3b's params and its bf16
    KV cache) snapshots through the checkpoint manager and restores
    equal."""
    from repro_torch.examples import serve_batched
    serve_batched.main(["--device", "cpu", "--snap-dir", str(tmp_path)])
    out = capsys.readouterr().out
    for arch in serve_batched.ARCHS:
        assert f"{arch:14s} generated (4, 16)" in out
    assert "restored equal: True" in out
    with open(next(tmp_path.glob("step_*")) / "index.json") as f:
        dtypes = {v["dtype"] for v in json.load(f)["variables"].values()}
    assert dtypes == {"float32", "bfloat16"}


def test_entry_points_need_a_gpu_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "qwen2.5-3b", "--smoke"])
    serve_cli.main(["--arch", "gemma2-2b", "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "4",
                    "--device", "cpu"])
    assert "arch=gemma2-2b-smoke device=cpu generated=(2, 4)" in \
        capsys.readouterr().out
