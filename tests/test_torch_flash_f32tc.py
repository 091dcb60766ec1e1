"""The numerics of the f32 flash forward on the tensor cores
(``csrc/flash_fwd_f32tc.cu``, 3xTF32), emulated on the CPU, and the routes
of the f32 passes (the backward's numerics:
``tests/test_torch_flash_bwd_f32tc.py``).

The kernel splits every operand x of both products, S = Q.K^T and O +=
P.V, into hi = tf32(x) and lo = tf32(x - hi), TF32 by truncation (the low
13 bits of an f32 cleared), and forms each product as lo*hi + hi*lo +
hi*hi summed in f32.  The online softmax runs over key tiles (64 keys up to
head_dim 128, 16 at 256) in f32 with p = exp2((s - m) * log2 e); head dims
such as 200 run on columns zero-padded to 256; O = acc / max(l, 1e-30) and
LSE = m + log(max(l, 1e-30)).  ``_emulate`` repeats that arithmetic in
torch, the truncation done by bit operations on ``int32`` views.  The chip
check holds the kernel to the plain version within the reference's f32
tolerance (``FLASH_TOL["float32"]``: rtol 1e-4, atol 1e-5; the LSE within
1e-4); these tests pin that the emulation meets it on every mask, GQA
group and head dim, against the plain version and against the JAX
package's Pallas forward in interpret mode, and that one TF32 product does
not, so the split cannot be dropped.  Inputs come from numpy with a seed;
q and k have std sqrt(2), so the scores have std 2 as in the chip check.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _fwd as jax_fwd

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# the package's ``flash_attention`` attribute is the function, not the module
FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: the chip check's f32 tolerances (chip_smoke.FLASH_TOL, LSE_TOL)
RTOL, ATOL = 1e-4, 1e-5
LSE_TOL = dict(rtol=1e-4, atol=1e-4)
#: gemma2-2b's softcap of 50, alone and under a window that masks within
#: the sequence; a one-sided non-causal window; plain causal
MASKS = {"causal": (True, None, None), "non_causal": (False, None, None),
         "window": (True, 96, None), "softcap_50": (True, None, 50.0),
         "softcap_50_window": (False, 96, 50.0)}
#: the kernel's truncation to TF32: sign, exponent, 10 mantissa bits
TF32_MASK = torch.tensor(-(1 << 13), dtype=torch.int32)
LOG2E = 1.4426950408889634


def _tf32(x):
    """x with the low 13 bits of each f32 cleared."""
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def _product(a, b, split=True):
    """a @ b as the kernel forms it: lo*hi + hi*lo + hi*hi in f32, or with
    ``split`` False one TF32 product hi*hi."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _emulate(q, k, v, causal, window, softcap, split=True):
    """The kernel's arithmetic on f32 (B, Hq, L, D) q and (B, Hkv, Lk, D)
    k, v: (O, LSE)."""
    B, H, L, D = q.shape
    Lk = k.shape[2]
    g = H // k.shape[1]
    scale = 1.0 / math.sqrt(D)
    pad = 256 if D > 128 else D
    tile = 16 if pad > 128 else 64
    q, k, v = (torch.nn.functional.pad(x, (0, pad - D)) for x in (q, k, v))
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    qp = torch.arange(L)[:, None]
    m = torch.full((B, H, L, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, L, pad))
    for k0 in range(0, Lk, tile):
        s = _product(q, k[:, :, k0:k0 + tile].transpose(-1, -2), split)
        s = s * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = torch.arange(k0, min(k0 + tile, Lk))[None, :]
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
        acc = acc * alpha + _product(p, v[:, :, k0:k0 + tile], split)
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc)[..., :D], (m + torch.log(lc))[..., 0]


def _inputs(D, g, L=256, Lk=256, seed=0):
    """f32 q (std sqrt(2), 2g heads), k (std sqrt(2)) and v (std 1/2) of 2
    kv-heads."""
    rng = np.random.default_rng([D, g, seed])
    return tuple(torch.from_numpy(
        (rng.standard_normal((1, h, n, D)) * std).astype(np.float32))
        for std, h, n in ((math.sqrt(2.0), 2 * g, L),
                          (math.sqrt(2.0), 2, Lk), (0.5, 2, Lk)))


def _violations(got, want, rtol=RTOL, atol=ATOL):
    d = (got.double() - want.double()).abs()
    return int((d > atol + rtol * want.double().abs()).sum())


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128, 200, 256])
@pytest.mark.parametrize("mask", MASKS)
def test_3xtf32_meets_the_f32_tolerance(mask, D, g):
    """The 3xTF32 forward's arithmetic, every mask, GQA groups 1, 2 and 4
    (groups of 2 at Lq 256 > Lk 192, ragged against the 64-key tiles), D
    200 on zero-padded columns: O within rtol 1e-4 / atol 1e-5 of the plain
    version, the LSE within 1e-4."""
    q, k, v = _inputs(D, g, Lk=192 if g == 2 else 256)
    causal, window, softcap = MASKS[mask]
    o, lse = _emulate(q, k, v, causal, window, softcap)
    ro, rlse = flash_attention_ref(q, k, v, None, causal, window, softcap)
    assert o.shape == ro.shape and lse.shape == rlse.shape
    assert _violations(o, ro) == 0
    assert _violations(lse, rlse, **LSE_TOL) == 0


@pytest.mark.parametrize("D", [64, 128, 200, 256])
@pytest.mark.parametrize("mask", MASKS)
def test_3xtf32_meets_the_f32_tolerance_of_the_pallas_forward(mask, D):
    """The same arithmetic against the JAX package's Pallas ``_fwd`` in
    interpret mode (128-row tiles, GQA 2:1 at L 256), O and LSE."""
    q, k, v = _inputs(D, 2, seed=1)
    causal, window, softcap = MASKS[mask]
    o, lse = _emulate(q, k, v, causal, window, softcap)
    po, plse = jax_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                       scale=1.0 / math.sqrt(D), causal=causal,
                       window=window, softcap=softcap, bq=128, bk=128,
                       interpret=True)
    po = torch.from_numpy(np.array(po, np.float32))
    plse = torch.from_numpy(np.array(plse, np.float32)).reshape(lse.shape)
    assert _violations(o, po) == 0
    assert _violations(lse, plse, **LSE_TOL) == 0


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("mask", ["causal", "softcap_50"])
def test_one_tf32_product_breaks_the_tolerance(mask, D):
    """One TF32 product (both operands truncated, no lo terms) moves O
    beyond the f32 tolerance on most outputs: the reason the kernel takes
    three."""
    q, k, v = _inputs(D, 2)
    causal, window, softcap = MASKS[mask]
    o, _ = _emulate(q, k, v, causal, window, softcap, split=False)
    ro, _ = flash_attention_ref(q, k, v, None, causal, window, softcap)
    assert _violations(o, ro) > 0.5 * o.numel()


@pytest.mark.parametrize("D", [8, 16, 24, 64, 80, 128, 136, 200, 256])
def test_routes_of_the_f32_and_bf16_passes(D):
    """f32: both passes on the 3xTF32 kernels (libraries ``flash_fwd_f32tc``
    and ``flash_bwd_f32tc``, each kernel its own launch counter); bf16:
    both passes on the sm90 route."""
    assert FA._route(torch.float32, D, "fwd") == "f32tc"
    assert FA._route(torch.float32, D, "bwd") == "f32tc"
    assert FA._route(torch.bfloat16, D, "fwd") == "sm90"
    assert FA._route(torch.bfloat16, D, "bwd") == "sm90"
    lib, entry = FA._FORWARD["f32tc"]
    assert entry in _build.SOURCES[lib]
    assert FA._COUNTERS[entry] is FA.f32tc_forward
    lib, entries = FA._BACKWARD["f32tc"]
    assert lib == "flash_bwd_f32tc" and set(entries.values()) == \
        set(_build.SOURCES[lib])
    assert FA._COUNTERS[entries["dq"]] is FA.f32tc_dq
    assert FA._COUNTERS[entries["dkv"]] is FA.f32tc_dkv


def test_f32_forward_goes_to_the_3xtf32_library():
    """An f32 forward on the default route loads ``flash_fwd_f32tc``; on a
    machine without nvcc or a card that is where it stops."""
    x = torch.zeros(1, 2, 8, 64)
    seen = []

    def load(name):
        seen.append(name)
        raise RuntimeError("no build here")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA._build, "load", load)
        with pytest.raises(RuntimeError, match="no build here"):
            FA._launch(x, x, x, 0.125, True, None, None)
    assert seen == ["flash_fwd_f32tc"]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_f32_backward_goes_to_the_3xtf32_library(kernel):
    """An f32 backward kernel on the default route loads
    ``flash_bwd_f32tc``; on a machine without nvcc or a card that is where
    it stops."""
    x = torch.zeros(1, 2, 8, 64)
    rows = torch.zeros(1, 2, 8)
    outs = (x.clone(),) if kernel == "dq" else (x.clone(), x.clone())
    seen = []

    def load(name):
        seen.append(name)
        raise RuntimeError("no build here")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA._build, "load", load)
        with pytest.raises(RuntimeError, match="no build here"):
            FA._launch_bwd(kernel, outs, x, x, x, x, rows, rows, 0.125, True,
                           None, None)
    assert seen == ["flash_bwd_f32tc"]


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_f32tc_route_refuses_bf16(kernel):
    """Naming the f32tc route for bf16 raises, for the forward and for
    each backward kernel, before anything is built or launched."""
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA._build, "load", pytest.fail)
        with pytest.raises(ValueError, match="f32tc"):
            if kernel == "fwd":
                FA._launch(x, x, x, 0.125, True, None, None, route="f32tc")
            else:
                FA._launch_bwd(kernel, (x.float(),) * (1 + (kernel == "dkv")),
                               x, x, x, x, rows, rows, 0.125, True, None,
                               None, route="f32tc")
