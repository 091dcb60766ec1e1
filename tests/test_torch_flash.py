"""The port's flash attention against the JAX package's, on the CPU: the
plain version (what a CPU tensor takes) against the Pallas kernel in
interpret mode over the reference's own sweep and tolerance, its LSE
against the Pallas ``_fwd``'s, and both model routes of ``attn_forward``
(``tests/test_optimized_paths.py``)."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _fwd as jax_fwd
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import attn_defs as jax_attn_defs
from repro.models.attention import attn_forward as jax_attn_forward
from repro.models.params import materialize as jax_materialize

import repro_torch.models.attention as tattn
from repro_torch.interop import params_from_numpy, to_numpy, to_tensor
from repro_torch.kernels import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

SWEEP = [(True, None, None), (False, None, None), (True, 48, None),
         (True, None, 30.0)]
GQA = [(4, 4), (4, 2), (4, 1)]


def _qkv(H, Hkv, B=2, L=128, D=32, Lk=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Lk = Lk or L
    return tuple((rng.standard_normal(s) * 0.5).astype(dtype)
                 for s in ((B, H, L, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


def _torch(*arrays):
    return tuple(to_tensor(a, "cpu") for a in arrays)


@pytest.mark.parametrize("causal,window,softcap", SWEEP)
@pytest.mark.parametrize("gqa", GQA)
def test_flash_matches_pallas_interpret(causal, window, softcap, gqa):
    """The reference's sweep and tolerance (rtol 1e-4, atol 1e-5)."""
    q, k, v = _qkv(*gqa)
    scale = 1 / math.sqrt(q.shape[-1])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                     causal, window, softcap, 64, 64, True)
    got = flash_attention(*_torch(q, k, v), scale, causal, window, softcap,
                          64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", SWEEP)
@pytest.mark.parametrize("gqa", GQA)
def test_flash_lse_matches_pallas_fwd(causal, window, softcap, gqa):
    """O and the row log-sum-exp the backward pass reads: O at the f32
    tolerance above, LSE at rtol 1e-5 / atol 1e-5 (both are f32 sums of
    the same terms in another order)."""
    q, k, v = _qkv(*gqa, seed=1)
    scale = 1 / math.sqrt(q.shape[-1])
    o_want, lse_want = jax_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale=scale, causal=causal,
                               window=window, softcap=softcap, bq=64, bk=64,
                               interpret=True)
    o, lse = flash_attention(*_torch(q, k, v), scale, causal, window,
                             softcap, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want),
                               rtol=1e-5, atol=1e-5)


def test_flash_window_softcap_noncausal_and_unequal_lengths():
    """Window + softcap together, non-causal (the window stays one-sided),
    and Lq != Lk."""
    q, k, v = _qkv(4, 2, L=64, Lk=128, seed=2)
    scale = 0.2
    o_want, lse_want = jax_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale=scale, causal=False,
                               window=40, softcap=20.0, bq=32, bk=64,
                               interpret=True)
    o, lse = flash_attention(*_torch(q, k, v), scale, False, 40, 20.0,
                             return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want),
                               rtol=1e-5, atol=1e-5)


def test_flash_bf16_inputs():
    """bf16 in, bf16 O: both compute in f32 and round once, so they agree
    to one bf16 step (rtol 2^-7; atol 1e-5 where O cancels to near 0)."""
    q, k, v = _qkv(4, 2, dtype=ml_dtypes.bfloat16, seed=3)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                     True, None, None, 64, 64, True)
    got = flash_attention(*_torch(q, k, v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        to_numpy(got, ml_dtypes.bfloat16).astype(np.float32),
        np.asarray(want, np.float32), rtol=2 ** -7, atol=1e-5)


def test_masked_rows_use_the_finite_sentinel():
    """A window of 1 with causal masking leaves one live key per row; the
    -1e30 sentinel (not -inf) keeps every value finite and the result is
    exactly v at that key."""
    q, k, v = _torch(*_qkv(2, 2, L=16, D=8, seed=4))
    o, lse = flash_attention_ref(q, k, v, None, True, 1, None)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, v, rtol=1e-6, atol=1e-6)


def test_flash_checks_its_inputs():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 8, 12), torch.zeros(1, 2, 8, 12),
                        torch.zeros(1, 2, 8, 12))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 8, 264), torch.zeros(1, 2, 8, 264),
                        torch.zeros(1, 2, 8, 264))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# -- the model routes ----------------------------------------------------------

def _attn_params(bias, seed=0):
    p = jax_materialize(jax_attn_defs(64, 4, 2, 16, qkv_bias=bias),
                        jax.random.key(seed))
    if bias:        # zero-initialized: give the biases values to test
        rng = np.random.default_rng(seed)
        p = {k: (jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                 if k.startswith("b") else a) for k, a in p.items()}
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def test_flash_model_path_matches_baseline_f32():
    """``flash_block=16`` at L=32 takes the flash route; it matches the
    q-chunked route (rtol 1e-4, atol 1e-4, the reference's bound) and the
    JAX flash route (rtol 1e-4, atol 1e-5)."""
    jp, tp = _attn_params(True)
    x = (np.random.default_rng(0).standard_normal((2, 32, 64)) * 0.5
         ).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, causal=True)
    y0 = tattn.attn_forward(tp, torch.from_numpy(x), **kw)
    yf = tattn.attn_forward(tp, torch.from_numpy(x), flash=True,
                            flash_block=16, **kw)
    np.testing.assert_allclose(y0.numpy(), yf.numpy(), rtol=1e-4, atol=1e-4)
    want = jax_attn_forward(jp, jnp.asarray(x), flash=True, flash_block=16,
                            **kw)
    np.testing.assert_allclose(yf.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_flash_falls_back_on_indivisible_length(monkeypatch):
    """37 % 16 != 0: the q-chunked route, and the kernel is never called."""
    jp, tp = _attn_params(False)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(a) or flash_attention(
                            *a, **k))
    x = np.ones((1, 37, 64), np.float32) * 0.1
    kw = dict(n_heads=4, n_kv=2, head_dim=16, causal=True)
    y = tattn.attn_forward(tp, torch.from_numpy(x), flash=True,
                           flash_block=16, **kw)
    assert y.shape == (1, 37, 64) and calls == []
    want = jax_attn_forward(jp, jnp.asarray(x), flash=True, flash_block=16,
                            **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    tattn.attn_forward(tp, torch.from_numpy(x[:, :32]), flash=True,
                       flash_block=16, **kw)
    assert len(calls) == 1
