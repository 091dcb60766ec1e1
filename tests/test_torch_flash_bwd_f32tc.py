"""The numerics of the f32 flash backward on the tensor cores
(``csrc/flash_bwd_f32tc.cu``, 3xTF32), emulated on the CPU.

The kernels split every operand x of their products (S = Q.K^T, dP =
dO.V^T and dQ += dS.K in dq; S^T = K.Q^T, dP^T = V.dO^T, dV += P^T.dO and
dK += dS^T.Q in dkv) into hi = tf32(x) and lo = tf32(x - hi), TF32 by
truncation (the low 13 bits of an f32 cleared), and form each product as
lo*hi + hi*lo + hi*hi summed in f32.  P = exp2((x - LSE) * log2 e) on the
scaled, softcapped and masked scores, Pd = P * (1 - t^2 under the softcap)
* scale (zero where masked) and dS = Pd * (dP - delta).  dQ is summed over
k tiles of 32 keys (16 above head_dim 128), dK and dV over q tiles of 64
rows (16 above 128), each tile's product summed from zero and folded into
the running total with one f32 add.  ``_emulate`` repeats that arithmetic
in torch, the truncation done by bit operations on ``int32`` views; head
dims such as 200 run on columns zero-padded to 256 in the kernels, which
adds exact zeros.  The chip check holds the kernels to the plain versions
within the reference's gradient tolerance (``BWD_TOL["float32"]``: rtol
1e-3, atol 1e-4); these tests pin that the emulation meets it on every
mask, GQA group and head dim, with ragged lengths, against the plain
versions and against the JAX package's Pallas ``_bwd`` in interpret mode,
and that one TF32 product does not, so the split cannot be dropped.
Inputs come from numpy with a seed; q and k have std sqrt(2), so the
scores have std 2 as in the chip check.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd as jax_bwd
from repro.kernels.flash_attention import _fwd as jax_fwd

from repro_torch.kernels.ref import (flash_attention_dkv_ref,
                                     flash_attention_dq_ref,
                                     flash_attention_ref)

#: the chip check's f32 gradient tolerance (chip_smoke.BWD_TOL)
RTOL, ATOL = 1e-3, 1e-4
#: gemma2-2b's softcap of 50, alone and under a window that masks within
#: the sequence; a one-sided non-causal window; plain causal
MASKS = {"causal": (True, None, None), "non_causal": (False, None, None),
         "window": (True, 96, None), "softcap_50": (True, None, 50.0),
         "softcap_50_window": (False, 96, 50.0)}
#: the kernels' truncation to TF32: sign, exponent, 10 mantissa bits
TF32_MASK = torch.tensor(-(1 << 13), dtype=torch.int32)
LOG2E = 1.4426950408889634


def _tf32(x):
    """x with the low 13 bits of each f32 cleared."""
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def _product(a, b, split=True):
    """a @ b as the kernels form it: lo*hi + hi*lo + hi*hi in f32, or with
    ``split`` False one TF32 product hi*hi."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _p_pd(s, lse, qpos, kpos, scale, causal, window, softcap):
    """P and Pd of raw scores ``s`` (rows ``qpos``, columns ``kpos``, or
    transposed when ``qpos`` is a row vector), ``lse`` broadcast alike."""
    x, dcap = s * scale, 1.0
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x, dcap = softcap * t, 1.0 - t * t
    keep = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    x = torch.where(keep, x, torch.tensor(-1e30))
    p = torch.exp2((x - lse) * LOG2E)
    return p, torch.where(keep, p * dcap * scale, torch.tensor(0.0))


def _emulate(q, k, v, do, lse, delta, scale, causal, window, softcap,
             split=True):
    """The kernels' arithmetic on f32 (B, Hq, L, D) q, dO and (B, Hkv, Lk,
    D) k, v: (dQ, per-q-head dK, per-q-head dV)."""
    L, D = q.shape[2:]
    Lk = k.shape[2]
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bk, bq = (16, 16) if D > 128 else (32, 64)
    mask = (scale, causal, window, softcap)
    rows = torch.arange(L)
    dq = torch.zeros_like(q)
    for k0 in range(0, Lk, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = _product(q, kt.transpose(-1, -2), split)
        dp = _product(do, vt.transpose(-1, -2), split) - delta[..., None]
        _, pd = _p_pd(s, lse[..., None], rows[:, None],
                      torch.arange(k0, k0 + kt.shape[2])[None, :], *mask)
        dq = dq + _product(pd * dp, kt, split)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    keys = torch.arange(Lk)
    for q0 in range(0, L, bq):
        qt, dot = q[:, :, q0:q0 + bq], do[:, :, q0:q0 + bq]
        st = _product(k, qt.transpose(-1, -2), split)
        dpt = _product(v, dot.transpose(-1, -2), split)
        cols = slice(q0, q0 + qt.shape[2])
        pt, pdt = _p_pd(st, lse[:, :, None, cols], rows[None, cols],
                        keys[:, None], *mask)
        dst = pdt * (dpt - delta[:, :, None, cols])
        dv = dv + _product(pt, dot, split)
        dk = dk + _product(dst, qt, split)
    return dq, dk, dv


def _inputs(D, g, L, Lk, Hkv=2, seed=0):
    """f32 q (std sqrt(2), g * Hkv heads), k (std sqrt(2)), v (std 1/2)
    of Hkv kv-heads, and dO (std 1/2)."""
    rng = np.random.default_rng([D, g, L, Lk, seed])
    return tuple(torch.from_numpy(
        (rng.standard_normal((1, h, n, D)) * std).astype(np.float32))
        for std, h, n in ((math.sqrt(2.0), g * Hkv, L),
                          (math.sqrt(2.0), Hkv, Lk), (0.5, Hkv, Lk),
                          (0.5, g * Hkv, L)))


def _args(D, g, mask, L=160, Lk=None, split=True):
    """The emulated and the plain (dQ, dK, dV) on one case, LSE and delta
    from the plain forward."""
    q, k, v, do = _inputs(D, g, L, Lk or L)
    causal, window, softcap = MASKS[mask]
    scale = 1.0 / math.sqrt(D)
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    args = (q, k, v, do, lse, (do * o).sum(-1), scale, causal, window,
            softcap)
    return (_emulate(*args, split=split),
            (flash_attention_dq_ref(*args), *flash_attention_dkv_ref(*args)))


def _violations(got, want):
    d = (got.double() - want.double()).abs()
    return int((d > ATOL + RTOL * want.double().abs()).sum())


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128, 200, 256])
@pytest.mark.parametrize("mask", MASKS)
def test_3xtf32_backward_meets_the_f32_gradient_tolerance(mask, D, g):
    """The 3xTF32 backward's arithmetic, every mask, GQA groups 1, 2 and 4
    at ragged lengths (Lq 160 against 64-row q tiles; Lk 136 for groups of
    2, against 32-key tiles), D 200 as the kernels' zero-padded 256: dQ
    and the per-q-head dK, dV within rtol 1e-3 / atol 1e-4 of the plain
    versions."""
    got, want = _args(D, g, mask, Lk=136 if g == 2 else None)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _violations(a, b) == 0


#: the Pallas comparison's GQA group per head dim, so that every mask
#: meets every group
PALLAS_GROUPS = {64: 4, 128: 1, 200: 2, 256: 4}


@pytest.mark.parametrize("D", [64, 128, 200, 256])
@pytest.mark.parametrize("mask", MASKS)
def test_3xtf32_backward_meets_the_f32_tolerance_of_the_pallas_bwd(mask, D):
    """The same arithmetic against the JAX package's Pallas ``_bwd`` in
    interpret mode (64-row tiles, L 128, one kv-head of
    ``PALLAS_GROUPS[D]`` q-heads), both on the Pallas forward's O and LSE:
    dQ, and dK, dV summed over each GQA group as ``_bwd`` sums them."""
    g = PALLAS_GROUPS[D]
    q, k, v, do = _inputs(D, g, 128, 128, Hkv=1, seed=1)
    causal, window, softcap = MASKS[mask]
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, scale=scale, causal=causal, window=window,
                     softcap=softcap, bq=64, bk=64, interpret=True)
    want = jax_bwd(scale, causal, window, softcap, 64, 64, True,
                   (jq, jk, jv, o, lse), jdo)
    o, lse = (torch.from_numpy(np.array(x, np.float32)) for x in (o, lse))
    dq, dk, dv = _emulate(q, k, v, do, lse.reshape(q.shape[:3]),
                          (do * o).sum(-1), scale, causal, window, softcap)
    got = (dq, dk.sum(1, keepdim=True), dv.sum(1, keepdim=True))
    for a, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        assert a.shape == w.shape
        assert _violations(a, w) == 0


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("mask", MASKS)
def test_one_tf32_product_breaks_the_gradient_tolerance(mask, D):
    """One TF32 product (both operands truncated, no lo terms) moves dQ,
    dK or dV beyond the f32 gradient tolerance: the reason the kernels
    take three."""
    got, want = _args(D, 4, mask, split=False)
    assert sum(_violations(a, b) for a, b in zip(got, want)) > 0


@pytest.mark.parametrize("variant", ["dq_paired", "dkv_bq32",
                                     "running_accumulator",
                                     "one_tf32_product"])
def test_probe_patches_match_the_kernels_once(variant):
    """``tools/flash_bwd_f32tc_probe.py`` builds the designs the 3xTF32
    backward was chosen over by patching a copy of its source; each patch
    must still find its text exactly once in the committed source."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "flash_bwd_f32tc_probe", root / "tools" / "flash_bwd_f32tc_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "src" / "repro_torch" / "kernels" / "csrc"
           / f"{probe.LIB}.cu").read_text()
    for old, new in probe.VARIANTS[variant]:
        assert src.count(old) == 1, old
        assert new not in src
