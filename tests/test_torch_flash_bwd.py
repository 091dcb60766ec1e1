"""The port's flash-attention backward against the JAX package's, on the
CPU: gradients through the port's ``flash_attention`` (its plain backward,
what a CPU tensor takes) against ``jax.grad`` through the Pallas kernels
in interpret mode, the plain backward against the Pallas ``_bwd``, and the
``autograd.Function`` against autograd through the plain forward."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd as jax_bwd
from repro.kernels.flash_attention import _fwd as jax_fwd
from repro.kernels.flash_attention import flash_attention as jax_flash

import repro_torch.kernels as K
from repro_torch.interop import to_numpy, to_tensor
from repro_torch.kernels import (flash_attention, flash_attention_dkv,
                                 flash_attention_dq)
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_bwd_ref, \
    flash_attention_ref

SWEEP = [(True, None, None), (False, None, None), (True, 48, None),
         (True, None, 30.0)]
GQA = [(4, 4), (4, 2), (4, 1)]
#: the reference's gradient tolerance (tests/test_optimized_paths.py)
RTOL, ATOL = 1e-3, 1e-4


def _arrays(H, Hkv, B=2, L=128, D=32, Lk=None, seed=0, dtype=np.float32):
    """q, k, v (std 0.5, as the reference's sweep) and an output
    gradient, from one seed."""
    rng = np.random.default_rng(seed)
    Lk = Lk or L
    return tuple((rng.standard_normal(s) * 0.5).astype(dtype)
                 for s in ((B, H, L, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D),
                           (B, H, L, D)))


def _torch(*arrays, grad=False):
    return tuple(to_tensor(a, "cpu").requires_grad_(grad) for a in arrays)


@pytest.mark.parametrize("causal,window,softcap", SWEEP)
@pytest.mark.parametrize("gqa", GQA)
def test_flash_grads_match_pallas_interpret(causal, window, softcap, gqa):
    """dQ, dK, dV through the port's ``flash_attention`` against ``jax.vjp``
    through the Pallas forward and backward kernels (interpret mode,
    blocks of 64), the same output gradient to both."""
    q, k, v, do = _arrays(*gqa)
    scale = 1 / math.sqrt(q.shape[-1])

    def f(a, b, c):
        return jax_flash(a, b, c, scale, causal, window, softcap, 64, 64,
                         True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _torch(q, k, v, grad=True)
    o = flash_attention(tq, tk, tv, scale, causal, window, softcap, 64, 64)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, 40, 20.0)])
def test_plain_backward_matches_pallas_bwd(dtype, causal, window, softcap):
    """``flash_attention_bwd_ref`` on the Pallas forward's own O and LSE
    against the Pallas ``_bwd`` (GQA 4:2, Lq != Lk).  f32 at the
    reference's tolerance; bf16 in, both compute in f32 and round once, so
    within one bf16 step (rtol 2^-7) plus the f32 atol."""
    q, k, v, do = _arrays(4, 2, L=64, Lk=128, seed=1, dtype=dtype)
    scale = 0.2
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, scale=scale, causal=causal, window=window,
                     softcap=softcap, bq=32, bk=64, interpret=True)
    want = jax_bwd(scale, causal, window, softcap, 32, 64, True,
                   (jq, jk, jv, o, lse), jdo)
    got = flash_attention_bwd_ref(
        *_torch(q, k, v, np.asarray(o), np.asarray(lse), do), scale, causal,
        window, softcap)
    rtol = RTOL if dtype == np.float32 else 2 ** -7
    for g, w in zip(got, want):
        assert g.dtype == to_tensor(q, "cpu").dtype
        np.testing.assert_allclose(to_numpy(g, dtype).astype(np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=ATOL)


@pytest.mark.parametrize("causal,window,softcap,Lk",
                         [(True, None, None, 40), (False, 7, 3.0, 40),
                          (True, 5, None, 48), (False, None, 2.0, 33)])
def test_function_matches_autograd_through_plain_forward(causal, window,
                                                         softcap, Lk):
    """The ``autograd.Function`` (the port's backward) against autograd
    through the plain forward, f32: lengths that are no multiple of any
    tile, and Lq != Lk."""
    q, k, v, do = _torch(*_arrays(4, 2, L=40, D=16, Lk=Lk, seed=2))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(
        flash_attention(q, k, v, None, causal, window, softcap), (q, k, v),
        do)
    want = torch.autograd.grad(
        flash_attention_ref(q, k, v, None, causal, window, softcap)[0],
        (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_rows_with_every_key_masked_follow_the_reference():
    """Causal with a window of 8 and Lk 32 < Lq 64 masks every key of rows
    39..63.  Their forward output is the mean of V (uniform weights over
    the -1e30 sentinel), but the reference's backward recomputes P as
    exp(-1e30 - LSE) = exp(0) = 1 (LSE rounds to -1e30), not 1/Lk: its dV
    is not the gradient of its own forward there.  The port reproduces the
    reference's backward, not autograd through the forward."""
    q, k, v, do = _arrays(2, 2, B=1, L=64, D=16, Lk=32, seed=6)

    def f(a, b, c):
        return jax_flash(a, b, c, None, True, 8, None, 32, 32, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _torch(q, k, v, grad=True)
    tdo = torch.from_numpy(do)
    got = torch.autograd.grad(flash_attention(tq, tk, tv, None, True, 8),
                              (tq, tk, tv), tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    auto = torch.autograd.grad(
        flash_attention_ref(tq, tk, tv, None, True, 8)[0], (tv,), tdo)[0]
    assert (auto - got[2]).abs().max() > 1.0


def test_wrappers_compose_the_plain_backward_without_launches():
    """On the CPU the dQ and dK/dV wrappers take their plain versions
    (no launch counted); glued with the group sum they equal the whole
    plain backward."""
    q, k, v, do = _torch(*_arrays(8, 2, L=32, D=16, seed=3))
    o, lse = flash_attention_ref(q, k, v, 0.25, True, None, None)
    K.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, 0.25)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, 0.25)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(n == 0 for n in K.launch_counts().values())
    delta = (do * o).sum(-1)
    dkh, dvh = flash_attention_dkv(q, k, v, do, lse, delta, 0.25)
    assert dkh.shape == dvh.shape == (2, 8, 32, 16)
    assert dkh.dtype == torch.float32


def test_lse_output_has_no_gradient():
    q, k, v, _ = _torch(*_arrays(2, 2, L=16, D=8, seed=4))
    q.requires_grad_()
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    (g,) = torch.autograd.grad(o.sum() + lse.sum(), (q,), allow_unused=True)
    (g0,) = torch.autograd.grad(flash_attention(q, k, v).sum(), (q,))
    torch.testing.assert_close(g, g0)


def test_backward_wrappers_check_their_inputs():
    q, k, v, do = _torch(*_arrays(4, 2, L=16, D=8, seed=5))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="do"):
        flash_attention_dq(q, k, v, do[:, :, :8], lse, lse, 0.3)
    with pytest.raises(ValueError, match="do"):
        flash_attention_dq(q, k, v, do.double(), lse, lse, 0.3)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dkv(q, k, v, do, lse.double(), lse, 0.3)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_dkv(q, k, v, do, lse, lse[..., :4], 0.3)
    with pytest.raises(ValueError):
        flash_attention_dq(q, k[:, :1].expand(2, 3, 16, 8), v, do, lse, lse,
                           0.3)
