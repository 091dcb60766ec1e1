"""The numerics of the sm90 flash backward (``csrc/flash_bwd_sm90.cu``),
emulated on the CPU, and its dispatch.

The kernels recompute S = Q.K^T and dP = dO.V^T from bf16 inputs in f32,
form P = exp2((s - LSE) * log2 e) and dS on the accumulator fragment, and
multiply dS.K (dQ, over 64-key tiles) and P^T.dO, dS^T.Q (dV, dK, over
64-row q tiles) on bf16 tensor cores with P and dS carried as two bf16
halves, hi = bf16(x) and lo = bf16(x - hi), summed in f32; dQ is rounded
once to bf16, dK and dV stay f32 per q-head.  ``_emulate`` repeats that
arithmetic in torch.  The chip check holds the kernels to the plain
versions within ``BWD_TOL`` (bf16 dQ: rtol 2^-7, atol 1e-4; the f32 dK,
dV: rtol 1e-3, atol 1e-4, whatever the input dtype); these tests pin that
the split meets it on every mask, with GQA, ragged Lq != Lk and rows whose
every key is masked, and that P and dS rounded once to bf16 do not, so the
split cannot be dropped.  Inputs come from numpy with a seed and are
bf16-exact; q and k have std sqrt(2), so the scores have std 2 as in the
chip check.
"""

import importlib
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd as jax_bwd
from repro.kernels.flash_attention import _fwd as jax_fwd

from repro_torch.interop import to_tensor
from repro_torch.kernels.ref import (_mask, flash_attention_dkv_ref,
                                     flash_attention_dq_ref,
                                     flash_attention_ref)

# the package's ``flash_attention`` attribute is the function, not the module
FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: the chip check's tolerances (chip_smoke.BWD_TOL): bf16 dQ, f32 dK and dV
DQ_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
DKV_TOL = dict(rtol=1e-3, atol=1e-4)
MASKS = {"causal": (True, None, None), "non_causal": (False, None, None),
         "window": (True, 48, None), "softcap": (True, None, 30.0),
         "window_softcap": (False, 48, 30.0)}
#: GQA groups of 4 at Lq = Lk, and of 2 at Lq 200 > Lk 136, where causal
#: with a window of 48 masks every key of rows 183..199
SHAPES = {"gqa4": dict(Hq=8, Hkv=2, L=200, Lk=200),
          "gqa2_ragged": dict(Hq=4, Hkv=2, L=200, Lk=136)}
TILE = 64
LOG2E = 1.4426950408889634


def _inputs(Hq, Hkv, L, Lk, B=2, D=64, seed=0):
    """bf16 q, k (std sqrt(2)), v and dO (std 1/2) from one seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * std).astype(
        np.float32)).bfloat16()
        for std, shape in ((math.sqrt(2.0), (B, Hq, L, D)),
                           (math.sqrt(2.0), (B, Hkv, Lk, D)),
                           (0.5, (B, Hkv, Lk, D)), (0.5, (B, Hq, L, D))))


def _args(q, k, v, do, causal, window, softcap):
    """The backward's arguments from the plain forward's O and LSE."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta, scale, causal, window, softcap)


def _halves(x, split):
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _emulate(q, k, v, do, lse, delta, scale, causal, window, softcap,
             split=True):
    """The kernels' arithmetic: (dQ in bf16, per-q-head dK, dV in f32)."""
    g = q.shape[1] // k.shape[1]
    qf, dof = q.float(), do.float()
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = qf @ kk.transpose(-1, -2) * scale
    dcap = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    keep = _mask(q.shape[2], k.shape[2], causal, window, "cpu")
    s = torch.where(keep, s, torch.tensor(-1e30))
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    dp = dof @ vv.transpose(-1, -2)
    ds = torch.where(keep, p * (dp - delta[..., None]) * dcap * scale, 0.0)
    dq = torch.zeros(qf.shape)
    for k0 in range(0, kk.shape[2], TILE):
        for part in _halves(ds[..., k0:k0 + TILE], split):
            dq += part @ kk[:, :, k0:k0 + TILE]
    dk = torch.zeros(kk.shape)
    dv = torch.zeros(kk.shape)
    for q0 in range(0, qf.shape[2], TILE):
        for part in _halves(p[:, :, q0:q0 + TILE], split):
            dv += part.transpose(-1, -2) @ dof[:, :, q0:q0 + TILE]
        for part in _halves(ds[:, :, q0:q0 + TILE], split):
            dk += part.transpose(-1, -2) @ qf[:, :, q0:q0 + TILE]
    return dq.bfloat16(), dk, dv


def _violations(got, want, rtol, atol):
    d = (got.double() - want.double()).abs()
    return int((d > atol + rtol * want.double().abs()).sum())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
def test_split_meets_the_chip_tolerance(mask, shape):
    """P and dS as hi + lo: dQ within one bf16 step of the plain version,
    the per-q-head dK and dV within the f32 gradient tolerance."""
    args = _args(*_inputs(**SHAPES[shape]), *MASKS[mask])
    dq, dk, dv = _emulate(*args)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _violations(dq, flash_attention_dq_ref(*args), **DQ_TOL) == 0
    assert _violations(dk, rdk, **DKV_TOL) == 0
    assert _violations(dv, rdv, **DKV_TOL) == 0


def test_rows_with_every_key_masked_take_p_one():
    """Causal with a window of 48 at Lq 200 > Lk 136 masks every key of
    rows 183..199: their LSE is -1e30, and exp2((s - LSE) * log2 e) with
    the difference taken first gives the reference's P = 1 there (the
    difference of the scaled terms would not), which reaches dV."""
    q, k, v, do, lse, *rest = _args(*_inputs(**SHAPES["gqa2_ragged"]),
                                    True, 48, None)
    assert (lse[:, :, 183:] == -1e30).all() and (lse[:, :, :183] > -1e3).all()
    s = torch.full((), -1e30)
    assert torch.exp2((s - lse[0, 0, 190]) * LOG2E) == 1.0
    _, _, dv = _emulate(q, k, v, do, lse, *rest)
    _, rdv = flash_attention_dkv_ref(q, k, v, do, lse, *rest)
    assert _violations(dv, rdv, **DKV_TOL) == 0
    # without those rows' P = 1 the dV of every key would differ
    assert (rdv - flash_attention_dkv_ref(
        q[:, :, :183], k, v, do[:, :, :183], lse[:, :, :183],
        rest[0][:, :, :183], *rest[1:])[1]).abs().amax() > 0.1


@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, 40, 20.0)])
def test_split_matches_pallas_bwd(causal, window, softcap):
    """The emulation against the JAX package's ``_bwd`` in Pallas
    interpret mode on the Pallas forward's own O and LSE (GQA 4:2, Lq 64 !=
    Lk 128): dQ and the group-summed dK, dV, each rounded once to bf16,
    within one bf16 step (rtol 2^-7) plus the f32 atol."""
    q, k, v, do = _inputs(Hq=4, Hkv=2, L=64, Lk=128, B=1, D=32, seed=1)
    scale = 0.2
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy().astype(
        ml_dtypes.bfloat16)) for x in (q, k, v, do))
    o, lse = jax_fwd(jq, jk, jv, scale=scale, causal=causal, window=window,
                     softcap=softcap, bq=32, bk=64, interpret=True)
    want = jax_bwd(scale, causal, window, softcap, 32, 64, True,
                   (jq, jk, jv, o, lse), jdo)
    to = to_tensor(np.asarray(o), "cpu")
    tlse = torch.from_numpy(np.asarray(lse, np.float32))
    delta = (do.float() * to.float()).sum(-1)
    dq, dkh, dvh = _emulate(q, k, v, do, tlse, delta, scale, causal, window,
                            softcap)
    B, Hkv, Lk, D = k.shape
    got = (dq, dkh.view(B, Hkv, 2, Lk, D).sum(2).bfloat16(),
           dvh.view(B, Hkv, 2, Lk, D).sum(2).bfloat16())
    for g, w in zip(got, want):
        assert _violations(g.float(), torch.from_numpy(
            np.asarray(w, np.float32)), **DQ_TOL) == 0


@pytest.mark.parametrize("mask", MASKS)
def test_one_bf16_p_and_ds_break_the_tolerance(mask):
    """P and dS rounded once to bf16 before the tensor-core products move
    the f32 dK or dV beyond rtol 1e-3 / atol 1e-4 of the plain version: the
    reason the kernels split them."""
    args = _args(*_inputs(**SHAPES["gqa4"]), *MASKS[mask])
    _, dk, dv = _emulate(*args, split=False)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _violations(dk, rdk, **DKV_TOL) + \
        _violations(dv, rdv, **DKV_TOL) > 0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("D", [8, 16, 24, 32, 48, 64, 72, 80, 120, 128,
                               136, 200, 256])
def test_backward_route(dtype, D):
    """bf16 with head_dim up to 128 takes the sm90 kernels; f32 and wider
    heads (bf16 at 256 too, though its forward runs on the sm90 route) the
    CUDA-core ones."""
    want = "sm90" if dtype == torch.bfloat16 and D <= 128 else "simt"
    assert FA._backward_route(dtype, D) == want


def test_sm90_backward_route_refuses_what_it_cannot_run():
    """Naming the sm90 route for f32, or for a head wider than 128, raises
    before anything is built or launched, for both kernels."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 256)):
        x = torch.zeros(1, 2, 8, D, dtype=dtype)
        rows = torch.zeros(1, 2, 8)
        for kernel, outs in (("dq", (x,)), ("dkv", (x.float(), x.float()))):
            with pytest.raises(ValueError, match="sm90"):
                FA._launch_bwd(kernel, outs, x, x, x, x, rows, rows, 0.125,
                               True, None, None, route="sm90")
