"""The numerics of the sm90 flash backward (``csrc/flash_bwd_sm90.cu``,
and ``csrc/flash_bwd_sm90_d256.cu`` above head_dim 128), emulated on the
CPU, its dispatch, and the chip check's gate on a training run's launches.

The kernels recompute S = Q.K^T and dP = dO.V^T from bf16 inputs in f32,
form P = exp2((s - LSE) * log2 e) and dS on the accumulator fragment, and
multiply dS.K (dQ, over 64-key tiles) and P^T.dO, dS^T.Q (dV, dK, over
64-row q tiles) on bf16 tensor cores with P and dS carried as two bf16
halves, hi = bf16(x) and lo = bf16(x - hi), summed in f32; dQ is rounded
once to bf16, dK and dV stay f32 per q-head.  ``_emulate`` repeats that
arithmetic in torch; with ``D256`` it takes the head_dim-256 kernels' tiles
(32 keys a dQ step; dK, dV in two 128-column halves over 32-row q halves),
their zero padding to 256 and their exp form of the softcap.  The chip
check holds the kernels to the plain versions within ``BWD_TOL`` (bf16 dQ:
rtol 2^-7, atol 1e-4; the f32 dK, dV: rtol 1e-3, atol 1e-4, whatever the
input dtype); these tests pin that the split meets it on every mask, with
GQA, ragged Lq != Lk and rows whose every key is masked, at head dims up to
128 and at 200 and 256, and that P and dS rounded once to bf16 do not, so
the split cannot be dropped.  Inputs come from numpy with a seed and are
bf16-exact; q and k have std sqrt(2), so the scores have std 2 as in the
chip check.
"""

import importlib
import math
import pathlib
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd as jax_bwd
from repro.kernels.flash_attention import _fwd as jax_fwd

from repro_torch.configs import get_config
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
#: the head_dim-256 kernels' arithmetic (``_emulate``'s options)
D256 = dict(dq_tile=32, dkv_tile=32, d_parts=2, pad_to=256,
            exp_softcap=True)


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
             split=True, dq_tile=TILE, dkv_tile=TILE, d_parts=1, pad_to=None,
             exp_softcap=False):
    """The kernels' arithmetic: (dQ in bf16, per-q-head dK, dV in f32).
    dQ sums ``dq_tile``-key tiles, dK and dV ``dkv_tile``-row q tiles, each
    in ``d_parts`` column blocks of their own; with ``pad_to`` on head dims
    zero-padded to that width (the scale stays the true head dim's) and cut
    back; the softcap through tanh or, with ``exp_softcap``, as
    t = 1 - 2 / (exp(2x/c) + 1)."""
    D = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    qf, dof, kk, vv = (
        torch.nn.functional.pad(x.float(), (0, (pad_to or D) - D))
        for x in (q, do, k.repeat_interleave(g, dim=1),
                  v.repeat_interleave(g, dim=1)))
    s = qf @ kk.transpose(-1, -2) * scale
    dcap = 1.0
    if softcap is not None and exp_softcap:
        e = torch.exp2(torch.clamp(s * (2 * LOG2E / softcap), max=64.0))
        t = 1.0 - 2.0 / (e + 1.0)
        s, dcap = softcap * t, 1.0 - t * t
    elif softcap is not None:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    keep = _mask(q.shape[2], k.shape[2], causal, window, "cpu")
    s = torch.where(keep, s, torch.tensor(-1e30))
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    dp = dof @ vv.transpose(-1, -2)
    ds = torch.where(keep, p * (dp - delta[..., None]) * dcap * scale, 0.0)
    dq = torch.zeros(qf.shape)
    for k0 in range(0, kk.shape[2], dq_tile):
        for part in _halves(ds[..., k0:k0 + dq_tile], split):
            dq += part @ kk[:, :, k0:k0 + dq_tile]
    dk = torch.zeros(kk.shape)
    dv = torch.zeros(kk.shape)
    width = qf.shape[-1] // d_parts
    for c in range(0, qf.shape[-1], width):
        cols = slice(c, c + width)
        for q0 in range(0, qf.shape[2], dkv_tile):
            rows = slice(q0, q0 + dkv_tile)
            for part in _halves(p[:, :, rows], split):
                dv[..., cols] += part.transpose(-1, -2) @ dof[:, :, rows, cols]
            for part in _halves(ds[:, :, rows], split):
                dk[..., cols] += part.transpose(-1, -2) @ qf[:, :, rows, cols]
    return dq.bfloat16()[..., :D], dk[..., :D], dv[..., :D]


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


def _against_pallas(D, causal, window, softcap, **emulation):
    """The emulation against the JAX package's ``_bwd`` in Pallas
    interpret mode on the Pallas forward's own O and LSE (GQA 4:2, Lq 64 !=
    Lk 128): dQ and the group-summed dK, dV, each rounded once to bf16,
    within one bf16 step (rtol 2^-7) plus the f32 atol."""
    q, k, v, do = _inputs(Hq=4, Hkv=2, L=64, Lk=128, B=1, D=D, seed=1)
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
                            softcap, **emulation)
    B, Hkv, Lk, D = k.shape
    got = (dq, dkh.view(B, Hkv, 2, Lk, D).sum(2).bfloat16(),
           dvh.view(B, Hkv, 2, Lk, D).sum(2).bfloat16())
    for g, w in zip(got, want):
        assert _violations(g.float(), torch.from_numpy(
            np.asarray(w, np.float32)), **DQ_TOL) == 0


@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, 40, 20.0)])
def test_split_matches_pallas_bwd(causal, window, softcap):
    """The head_dim-128 kernels' arithmetic at D 32 against Pallas."""
    _against_pallas(32, causal, window, softcap)


@pytest.mark.parametrize("D", [256, 200], ids=["d256", "d200_padded"])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, 40, 20.0)])
def test_d256_split_matches_pallas_bwd(causal, window, softcap, D):
    """The head_dim-256 kernels' arithmetic (``D256``) against Pallas."""
    _against_pallas(D, causal, window, softcap, **D256)


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
    """bf16 at every head_dim up to 256 takes the sm90 kernels (those of
    ``csrc/flash_bwd_sm90_d256.cu`` above 128); f32 the 3xTF32 ones
    (``csrc/flash_bwd_f32tc.cu``)."""
    want = "sm90" if dtype == torch.bfloat16 else "f32tc"
    assert FA._route(dtype, D, "bwd") == want


def test_sm90_backward_route_refuses_what_it_cannot_run():
    """Naming the sm90 route for f32, or for a head wider than 256, raises
    before anything is built or launched, for both kernels."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 264)):
        x = torch.zeros(1, 2, 8, D, dtype=dtype)
        rows = torch.zeros(1, 2, 8)
        for kernel, outs in (("dq", (x,)), ("dkv", (x.float(), x.float()))):
            with pytest.raises(ValueError, match="sm90"):
                FA._launch_bwd(kernel, outs, x, x, x, x, rows, rows, 0.125,
                               True, None, None, route="sm90")


@pytest.mark.parametrize("D", [256, 200], ids=["d256", "d200_padded"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
def test_d256_split_meets_the_chip_tolerance(mask, shape, D):
    """The head_dim-256 kernels' arithmetic (``D256``: 32-key dQ tiles, dK
    and dV in two 128-column halves over 32-row q halves, D 200 on columns
    zero-padded to 256, the exp form of the softcap): dQ within one bf16
    step of the plain version, the per-q-head dK and dV within the f32
    gradient tolerance, on every mask, with GQA, ragged Lq != Lk and rows
    whose every key is masked (``gqa2_ragged`` with a window)."""
    args = _args(*_inputs(**SHAPES[shape], D=D), *MASKS[mask])
    dq, dk, dv = _emulate(*args, **D256)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert dq.shape == args[0].shape and dk.shape == rdk.shape
    assert _violations(dq, flash_attention_dq_ref(*args), **DQ_TOL) == 0
    assert _violations(dk, rdk, **DKV_TOL) == 0
    assert _violations(dv, rdv, **DKV_TOL) == 0


@pytest.mark.parametrize("mask", MASKS)
def test_one_bf16_p_and_ds_break_the_tolerance_at_d256(mask):
    """At head_dim 256 too, P and dS rounded once to bf16 move the f32 dK
    or dV beyond the tolerance: the head_dim-256 kernels split them."""
    args = _args(*_inputs(**SHAPES["gqa4"], D=256), *MASKS[mask])
    _, dk, dv = _emulate(*args, split=False, **D256)
    rdk, rdv = flash_attention_dkv_ref(*args)
    assert _violations(dk, rdk, **DKV_TOL) + \
        _violations(dv, rdv, **DKV_TOL) > 0


def _chip_smoke():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def _gemma2_training_run() -> dict:
    """The record ``chip_smoke.train`` returns for gemma2-2b (one stacked
    segment: every layer under remat), with the launches a right run
    counts: per step the head_dim-256 sm90 forward twice a layer (the dots
    recompute runs it again) and its dq and dkv once; the f32 route comparison's backward on the 3xTF32 kernels after
    the 3xTF32 forward, the bf16 one's on the head_dim-256 ones, once a
    layer."""
    cs = _chip_smoke()
    cfg = get_config("gemma2-2b")
    n = cfg.n_layers

    def counts(**ran):
        return {**dict.fromkeys(cs.FLASH_KERNELS, 0), **ran}

    return {"layers": n, "recomputed_layers": n, "head_dim": cfg.head_dim,
            "flash_vs_q_chunked": {
                "bfloat16": {"loss_gap": 2e-3, "flash_launches": counts(
                    flash_attention_d256=n, flash_attention_dq_d256=n,
                    flash_attention_dkv_d256=n)},
                "float32": {"over_limit": {}, "flash_launches": counts(
                    flash_attention_f32tc=n, flash_attention_dq_f32tc=n,
                    flash_attention_dkv_f32tc=n)}},
            "losses": [12.4, 11.8, 11.1], "grad_norms": [2.0, 1.7, 1.5],
            "launches_per_step": counts(flash_attention_d256=2 * n,
                                        flash_attention_dq_d256=n,
                                        flash_attention_dkv_d256=n)}


def test_check_training_accepts_gemma2_launch_counts():
    """The chip check's training gate, generalised over the arch, takes
    gemma2-2b's 26 layers at head_dim 256 on the head_dim-256 kernels."""
    run = _gemma2_training_run()
    assert (run["layers"], run["head_dim"]) == (26, 256)
    _chip_smoke().check_training(run)


@pytest.mark.parametrize("kernel", ["flash_attention_dq_simt",
                                    "flash_attention_dkv_simt",
                                    "flash_attention_dq_f32tc",
                                    "flash_attention_dkv_f32tc",
                                    "flash_attention_dq",
                                    "flash_attention_dkv"])
def test_check_training_refuses_another_backward_kernel(kernel):
    """One launch a step of a CUDA-core or 3xTF32 backward kernel, or of
    the sm90 route's head_dim-128 one, fails gemma2-2b's training gate."""
    run = _gemma2_training_run()
    run["launches_per_step"][kernel] += 1
    with pytest.raises(AssertionError, match="launches per step"):
        _chip_smoke().check_training(run)


@pytest.mark.parametrize("kernel", ["flash_attention_simt",
                                    "flash_attention_d256"])
def test_check_training_refuses_another_f32_forward(kernel):
    """The f32 route comparison's forward must run the 3xTF32 kernel: on
    the CUDA-core forward, or on an sm90 one, the gate fails."""
    run = _gemma2_training_run()
    got = run["flash_vs_q_chunked"]["float32"]["flash_launches"]
    got[kernel] = got.pop("flash_attention_f32tc")
    got["flash_attention_f32tc"] = 0
    with pytest.raises(AssertionError, match="float32 route comparison"):
        _chip_smoke().check_training(run)


def test_check_training_refuses_a_cuda_core_bf16_comparison():
    """The bf16 route comparison's backward must run the head_dim-256
    sm90 kernels: on the CUDA-core ones the gate fails."""
    run = _gemma2_training_run()
    got = run["flash_vs_q_chunked"]["bfloat16"]["flash_launches"]
    for kind in ("dq", "dkv"):
        got[f"flash_attention_{kind}_simt"] = got.pop(
            f"flash_attention_{kind}_d256")
        got[f"flash_attention_{kind}_d256"] = 0
    with pytest.raises(AssertionError, match="bfloat16 route comparison"):
        _chip_smoke().check_training(run)


def test_check_training_refuses_a_cuda_core_f32_comparison():
    """The f32 route comparison's backward must run the 3xTF32 kernels: on
    the CUDA-core ones the gate fails."""
    run = _gemma2_training_run()
    got = run["flash_vs_q_chunked"]["float32"]["flash_launches"]
    for kind in ("dq", "dkv"):
        got[f"flash_attention_{kind}_simt"] = got.pop(
            f"flash_attention_{kind}_f32tc")
        got[f"flash_attention_{kind}_f32tc"] = 0
    with pytest.raises(AssertionError, match="float32 route comparison"):
        _chip_smoke().check_training(run)


def _hymba_training_run() -> dict:
    """The record ``chip_smoke.train`` returns for hymba-1.5b: 32 layers,
    29 of them in stacked segments under remat (its 3 single-layer
    segments run without it, as in the reference), so per step 61 sm90
    forward launches at head_dim 64 and one dq and one dkv a layer."""
    cs = _chip_smoke()
    cfg = get_config("hymba-1.5b")
    n = cfg.n_layers
    recomputed = sum(c for _, c in cfg.program if c > 1)

    def counts(**ran):
        return {**dict.fromkeys(cs.FLASH_KERNELS, 0), **ran}

    return {"arch": "hymba-1.5b", "layers": n,
            "recomputed_layers": recomputed, "head_dim": cfg.head_dim,
            "flash_vs_q_chunked": {
                "bfloat16": {"loss_gap": 4e-5, "flash_launches": counts(
                    flash_attention=n + recomputed, flash_attention_dq=n,
                    flash_attention_dkv=n)},
                "float32": {"over_limit": {}, "flash_launches": counts(
                    flash_attention_f32tc=n + recomputed,
                    flash_attention_dq_f32tc=n,
                    flash_attention_dkv_f32tc=n)}},
            "losses": [10.8, 9.7, 8.1, 7.9], "grad_norms": [35.0, 31.0,
                                                          20.0, 44.0],
            "launches_per_step": counts(flash_attention=n + recomputed,
                                        flash_attention_dq=n,
                                        flash_attention_dkv=n)}


@pytest.mark.parametrize("forwards,ok", [(61, True), (64, False),
                                         (32, False)])
def test_check_training_counts_the_forwards_remat_implies(forwards, ok):
    """hymba-1.5b's gate: one sm90 forward a layer and one more for each
    of the 29 layers under remat (61), not two for every layer (64) nor
    one (32)."""
    assert sum(c for _, c in get_config("hymba-1.5b").program if c > 1) \
        == 29
    run = _hymba_training_run()
    run["launches_per_step"]["flash_attention"] = forwards
    if ok:
        _chip_smoke().check_training(run)
    else:
        with pytest.raises(AssertionError, match="launches per step"):
            _chip_smoke().check_training(run)


@pytest.mark.parametrize("launched", [None, "flash_attention",
                                      "flash_attention_dq_simt"])
def test_check_training_takes_a_model_without_attention(launched):
    """mamba2-780m's record has no route comparison; its gate holds the
    losses and grad norms and refuses any flash launch."""
    cs = _chip_smoke()
    run = {"arch": "mamba2-780m", "layers": 48, "recomputed_layers": 48,
           "head_dim": 1, "flash_vs_q_chunked": None,
           "losses": [11.3, 11.0, 10.7, 10.4],
           "grad_norms": [102.0, 93.0, 94.0, 101.0],
           "launches_per_step": dict.fromkeys(cs.FLASH_KERNELS, 0)}
    if launched is None:
        cs.check_training(run)
        run["losses"] = [11.3, 11.4, float("nan"), 11.2]
        with pytest.raises(AssertionError, match="losses"):
            cs.check_training(run)
    else:
        run["launches_per_step"][launched] = 1
        with pytest.raises(AssertionError, match="has no attention"):
            cs.check_training(run)


def test_train_says_what_its_depth_cut_requires():
    """``chip_smoke.train``'s ``depth=`` cuts a one-segment program only:
    hymba-1.5b's five segments are refused by name before anything is
    built."""
    with pytest.raises(ValueError, match="one-segment program; "
                       "hymba-1.5b has 5 segments"):
        _chip_smoke().train(torch, torch.device("cpu"), None, "hymba-1.5b",
                            depth=4)
