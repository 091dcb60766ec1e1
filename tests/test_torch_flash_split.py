"""The numerics of the sm90 flash forward (``csrc/flash_fwd_sm90.cu``),
emulated on the CPU, and its dispatch.

The kernel computes S = Q.K^T from bf16 inputs in f32, runs the online
softmax over 64-key tiles in f32, and multiplies P.V on bf16 tensor cores
with P carried as two bf16 halves, hi = bf16(P) and lo = bf16(P - hi),
summed in f32; O is rounded once to bf16.  ``_emulate`` repeats that
arithmetic in torch.  The chip check holds the kernel's bf16 O to one bf16
step of the f32 plain version (``FLASH_TOL["bfloat16"]``: rtol 2^-7, atol
1e-5); these tests pin that the split meets that tolerance on every mask,
and that P rounded once to bf16 does not, so the split cannot be dropped.
Inputs come from numpy with a seed and are bf16-exact; q and k have std
sqrt(2), so the scores have std 2 as in the chip check's serving shape.
"""

import importlib
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash

from repro_torch.interop import to_tensor
from repro_torch.kernels.ref import flash_attention_ref

# the package's ``flash_attention`` attribute is the function, not the module
FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: the chip check's bf16 tolerance on O (chip_smoke.FLASH_TOL)
RTOL, ATOL = 2.0 ** -7, 1e-5
#: causal, one-sided window, softcap, and a one-sided non-causal window
MASKS = {"causal": (True, None, None), "window": (True, 96, None),
         "softcap": (True, None, 30.0), "window_noncausal": (False, 96, None)}
TILE = 64
LOG2E = 1.4426950408889634


def _qkv(H=2, L=512, D=128, seed=0):
    """bf16-exact q, k (std sqrt(2)) and v (std 1/2) as f32 arrays."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal((1, H, L, D)) * std).astype(
        ml_dtypes.bfloat16).astype(np.float32)
        for std in (math.sqrt(2.0), math.sqrt(2.0), 0.5)]
    return tuple(torch.from_numpy(a) for a in arrays)


def _emulate(q, k, v, causal, window, softcap, split=True):
    """The kernel's arithmetic: f32 scores, the online softmax over
    64-key tiles with exp2((s - m) * log2 e), P as hi + lo bf16 halves (or
    one bf16 if not ``split``) against bf16 V in f32, O rounded once."""
    _, _, L, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qp = torch.arange(L)[:, None]
    m = torch.full((1, q.shape[1], L, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, Lk, TILE):
        s = q @ k[:, :, k0:k0 + TILE].transpose(-1, -2) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = torch.arange(k0, min(k0 + TILE, Lk))[None, :]
        keep = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            keep &= qp >= kp
        if window is not None:
            keep &= (qp - kp) < window
        s = torch.where(keep, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ v[:, :, k0:k0 + TILE]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ v[:, :, k0:k0 + TILE]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _violations(got, want):
    d = (got.double() - want.double()).abs()
    return int((d > ATOL + RTOL * want.double().abs()).sum())


@pytest.mark.parametrize("mask", MASKS)
def test_split_p_meets_one_bf16_step(mask):
    """P as hi + lo: every output within one bf16 step of the plain
    version, and of the JAX package's Pallas forward in interpret mode."""
    q, k, v = _qkv()
    causal, window, softcap = MASKS[mask]
    got = _emulate(q, k, v, causal, window, softcap)
    want, _ = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  None, causal, window, softcap)
    assert _violations(got, want) == 0
    pallas = jax_flash(*(jnp.asarray(x.bfloat16().float().numpy(),
                                     jnp.bfloat16) for x in (q, k, v)),
                       None, causal, window, softcap, 128, 128, True)
    assert _violations(got, to_tensor(np.asarray(pallas, np.float32),
                                      "cpu")) == 0


@pytest.mark.parametrize("mask", MASKS)
def test_one_bf16_p_breaks_the_tolerance(mask):
    """P rounded once to bf16 before P.V moves O by more than one bf16
    step on a share of the outputs: the reason the kernel splits P."""
    q, k, v = _qkv()
    causal, window, softcap = MASKS[mask]
    got = _emulate(q, k, v, causal, window, softcap, split=False)
    want, _ = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  None, causal, window, softcap)
    assert _violations(got, want) > 0.001 * got.numel()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("D", [8, 16, 24, 32, 48, 64, 72, 80, 120, 128,
                               136, 256])
def test_forward_route(dtype, D):
    """bf16 with head_dim padded to 16, 32, 64, 80 or 128 (any multiple of
    8 up to 128) takes the sm90 kernel; f32 and wider heads the CUDA-core
    kernel."""
    want = "sm90" if dtype == torch.bfloat16 and D <= 128 else "simt"
    assert FA._forward_route(dtype, D) == want


def test_sm90_route_refuses_what_it_cannot_run():
    """Naming the sm90 route for f32, or for a head wider than 128,
    raises before anything is built or launched."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 256)):
        x = torch.zeros(1, 2, 8, D, dtype=dtype)
        with pytest.raises(ValueError):
            FA._launch(x, x, x, 0.125, True, None, None, route="sm90")
