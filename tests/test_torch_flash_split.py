"""The numerics of the sm90 flash forward's two kernels
(``csrc/flash_fwd_sm90.cu`` for head_dim up to 128,
``csrc/flash_fwd_sm90_d256.cu`` above), emulated on the CPU, and the
dispatch of the forward and backward routes.

Each kernel computes S = Q.K^T from bf16 inputs in f32, runs the online
softmax over 64-key tiles in f32, and multiplies P.V on bf16 tensor
cores with P carried as two bf16 halves, hi = bf16(P) and lo = bf16(P -
hi), summed in f32; O is rounded once to bf16.  The head_dim-256 kernel
pads head dims such as 200 with zero columns up to 256 and takes the
softcap c*tanh(x/c) as c - 2c / (exp(2x/c) + 1).  ``_emulate`` repeats that
arithmetic in torch.  The chip check holds the kernel's bf16 O to one bf16
step of the f32 plain version (``FLASH_TOL["bfloat16"]``: rtol 2^-7, atol
1e-5); these tests pin that the split meets that tolerance on every mask,
and that P rounded once to bf16 does not, so the split cannot be dropped.
Inputs come from numpy with a seed and are bf16-exact; q and k have std
sqrt(2), so the scores have std 2 as in the chip check's serving shape.
"""

import importlib
import importlib.util
import math
import pathlib

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
#: gemma2-2b's: the softcap of 50 under its local layers' window of 4096,
#: and under a window of 96 that masks within the sequence
GEMMA2_MASKS = {"softcap_window_4096": (True, 4096, 50.0),
                "softcap_window_96": (True, 96, 50.0)}
TILE = 64
LOG2E = 1.4426950408889634


def _qkv(H=2, L=512, D=128, seed=0):
    """bf16-exact q, k (std sqrt(2)) and v (std 1/2) as f32 arrays."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal((1, H, L, D)) * std).astype(
        ml_dtypes.bfloat16).astype(np.float32)
        for std in (math.sqrt(2.0), math.sqrt(2.0), 0.5)]
    return tuple(torch.from_numpy(a) for a in arrays)


def _emulate(q, k, v, causal, window, softcap, split=True, pad_to=None,
             exp_softcap=False):
    """The kernel's arithmetic: f32 scores, the softcap (through tanh, or
    with ``exp_softcap`` as c - 2c / (exp(2x/c) + 1)), the online softmax
    over TILE-key tiles with exp2((s - m) * log2 e), P as hi + lo bf16
    halves (or one bf16 if not ``split``) against bf16 V in f32, O rounded
    once; with ``pad_to``, on head dims zero-padded to that width (the
    scale stays the true head dim's) and O cut back."""
    _, _, L, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    if pad_to is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, pad_to - D))
                   for x in (q, k, v))
    qp = torch.arange(L)[:, None]
    m = torch.full((1, q.shape[1], L, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, Lk, TILE):
        s = q @ k[:, :, k0:k0 + TILE].transpose(-1, -2) * scale
        if softcap is not None and exp_softcap:
            e = torch.exp2(torch.clamp(s * (2 * LOG2E / softcap), max=64.0))
            s = softcap - 2 * softcap / (e + 1)
        elif softcap is not None:
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
    return (acc / l.clamp_min(1e-30)).bfloat16()[..., :D]


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


def _pallas(q, k, v, causal, window, softcap):
    """The JAX package's Pallas forward in interpret mode on the bf16
    inputs, as an f32 tensor."""
    o = jax_flash(*(jnp.asarray(x.bfloat16().float().numpy(), jnp.bfloat16)
                    for x in (q, k, v)),
                  None, causal, window, softcap, 128, 128, True)
    return to_tensor(np.asarray(o, np.float32), "cpu")


@pytest.mark.parametrize("D", [256, 200], ids=["d256", "d200_padded"])
@pytest.mark.parametrize("mask", GEMMA2_MASKS)
def test_split_p_meets_one_bf16_step_at_head_dim_256(mask, D):
    """The head_dim-256 kernel's arithmetic (its softcap form; 64-key
    tiles; D 200 on columns zero-padded to 256) under gemma2-2b's masks:
    every output within one bf16 step of the plain version and of the
    Pallas forward in interpret mode."""
    q, k, v = _qkv(L=384, D=D, seed=D + TILE)
    causal, window, softcap = GEMMA2_MASKS[mask]
    got = _emulate(q, k, v, causal, window, softcap, pad_to=256,
                   exp_softcap=True)
    want, _ = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  None, causal, window, softcap)
    assert got.shape == want.shape
    assert _violations(got, want) == 0
    assert _violations(got, _pallas(q, k, v, causal, window, softcap)) == 0


@pytest.mark.parametrize("mask", GEMMA2_MASKS)
def test_one_bf16_p_breaks_the_tolerance_at_head_dim_256(mask):
    """At head_dim 256 too, P rounded once to bf16 puts a share of the
    outputs beyond one bf16 step: the head_dim-256 kernel splits P."""
    q, k, v = _qkv(L=384, D=256, seed=1)
    causal, window, softcap = GEMMA2_MASKS[mask]
    got = _emulate(q, k, v, causal, window, softcap, split=False,
                   exp_softcap=True)
    want, _ = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  None, causal, window, softcap)
    assert _violations(got, want) > 0.001 * got.numel()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("D", [8, 16, 24, 32, 48, 64, 72, 80, 120, 128,
                               136, 200, 256])
def test_forward_route(dtype, D):
    """bf16 at every head_dim up to 256 takes the sm90 route (padded to
    16, 32, 64, 80 or 128 on its first kernel, to 256 on its head_dim-256
    kernel); f32 the 3xTF32 tensor-core kernel
    (``csrc/flash_fwd_f32tc.cu``)."""
    want = "sm90" if dtype == torch.bfloat16 else "f32tc"
    assert FA._route(dtype, D, "fwd") == want


def test_sm90_route_refuses_what_it_cannot_run():
    """Naming the sm90 forward route for f32, or for a head wider than
    256, raises before anything is built or launched (the backward's
    refusals: ``tests/test_torch_flash_bwd_split.py``)."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 264)):
        x = torch.zeros(1, 2, 8, D, dtype=dtype)
        with pytest.raises(ValueError):
            FA._launch(x, x, x, 0.125, True, None, None, route="sm90")


def test_sm90_route_names_its_wide_kernel():
    """Naming the sm90 route for bf16 at head_dim 256 passes the route
    check and goes on to the head_dim-256 kernel's library: on a machine
    without nvcc or a card that is where it stops."""
    x = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16)
    seen = []

    def load(name):
        seen.append(name)
        raise RuntimeError("no build here")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA._build, "load", load)
        with pytest.raises(RuntimeError, match="no build here"):
            FA._launch(x, x, x, 0.0625, True, None, None, route="sm90")
    assert seen == ["flash_fwd_sm90_d256"]


@pytest.mark.parametrize("variant", ["bk32_3_stages", "tanhf_softcap"])
def test_d256_probe_patches_match_the_kernel_once(variant):
    """``tools/flash_d256_probe.py`` builds the designs the head_dim-256
    kernel was chosen over by patching a copy of its source; each patch
    must still find its text exactly once in the committed source."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "flash_d256_probe", root / "tools" / "flash_d256_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "src" / "repro_torch" / "kernels" / "csrc"
           / f"{probe.LIB}.cu").read_text()
    for old, new in probe.VARIANTS[variant]:
        assert src.count(old) == 1, old
        assert new not in src


def _probe(name):
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(name,
                                                  root / "tools" / f"{name}.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return root / "src" / "repro_torch" / "kernels" / "csrc", probe


@pytest.mark.parametrize("variant", ["d128_nw4_bk32", "d128_nw12_bk32",
                                     "d256_nw4_bk32",
                                     "expf", "running_accumulator",
                                     "one_tf32_product"])
def test_f32tc_probe_patches_match_the_kernel_once(variant):
    """``tools/flash_f32tc_probe.py`` builds the designs the 3xTF32
    forward was chosen over by patching a copy of its source; each patch
    must still find its text exactly once in the committed source."""
    csrc, probe = _probe("flash_f32tc_probe")
    src = (csrc / f"{probe.LIB}.cu").read_text()
    for old, new in probe.VARIANTS[variant]:
        assert src.count(old) == 1, old
        assert new not in src


def test_pack_rows_probe_patches_match_the_kernel_once():
    """``tools/pack_rows_probe.py``'s patched variant of the committed
    ``csrc/pack_rows.cu`` still finds each text it replaces exactly once."""
    csrc, probe = _probe("pack_rows_probe")
    src = (csrc / f"{probe.LIB}.cu").read_text()
    for name, source in probe.VARIANTS.items():
        if isinstance(source, str):
            assert "extern \"C\" int repro_pack_rows(" in source, name
            continue
        for old, new in source:
            assert src.count(old) == 1, old
            assert new not in src
