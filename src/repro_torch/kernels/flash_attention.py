"""Flash attention on the card: the online-softmax forward and its
backward, each a hand-written CUDA kernel.

The forward replaces the JAX package's Pallas ``_fwd_kernel``: it keeps
each score tile on chip with a running row max and sum, so attention's
device-memory traffic is Q, K, V and O only.  The backward kernels replace
``_dq_kernel`` and ``_dkv_kernel``: they recompute P from the forward's
LSE, dQ over k tiles and per-q-head dK, dV over q tiles; the GQA group sum
follows in f32, as the reference's custom vjp does.  Each pass takes
a route picked by dtype and head dim (``_route``): bf16 runs the
``"sm90"`` route (wgmma and TMA on Hopper's tensor cores),
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` for head_dim up
to 128 and ``csrc/flash_fwd_sm90_d256.cu`` and
``csrc/flash_bwd_sm90_d256.cu`` above; f32, and only f32, runs both
passes on the ``"f32tc"`` route (``csrc/flash_fwd_f32tc.cu`` and
``csrc/flash_bwd_f32tc.cu``: 3xTF32 on the tensor cores).  The CUDA-core
kernels of the ``"simt"`` route (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) run only when a caller names their route.
Every kernel counts its own launches (``_COUNTERS``).
The three passes enter through torch custom ops (``repro_torch::flash_fwd``,
``flash_dq``, ``flash_dkv``): their fake implementations give the outputs'
shapes and dtypes to a trace under ``FakeTensorMode`` or on meta tensors,
and their flop formulas count the useful work (4·D flops a live (q, k)
pair forward, 6·D dq, 8·D dkv: ``live_pairs``).
``flash_attention`` is differentiable through a
``torch.autograd.Function`` over the three.  Causal and
one-sided sliding-window masks, a logit softcap and GQA, as the
reference; any Lq and Lk (ragged edge tiles are masked) and head_dim a
multiple of 8 up to 256.  A tensor on the CPU takes the plain versions in
:mod:`.ref`; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import (flash_attention_dkv_ref, flash_attention_dq_ref,
                  flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_flops", "live_pairs"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256
#: the widest head of the sm90 route's first kernels; wider ones up to 256
#: run its head_dim-256 kernels (``csrc/flash_fwd_sm90_d256.cu``,
#: ``csrc/flash_bwd_sm90_d256.cu``)
_SM90_NARROW_HEAD_DIM = 128
#: forward route -> (library, C entry point); the sm90 route's wide heads
#: take ``_FORWARD_SM90_D256``
_FORWARD = {"sm90": ("flash_fwd_sm90", "repro_flash_fwd_sm90"),
            "f32tc": ("flash_fwd_f32tc", "repro_flash_fwd_f32tc"),
            "simt": ("flash_fwd", "repro_flash_fwd")}
_FORWARD_SM90_D256 = ("flash_fwd_sm90_d256", "repro_flash_fwd_sm90_d256")
#: backward route -> (library, {kernel: C entry point}); the sm90 route's
#: wide heads take ``_BACKWARD_SM90_D256``
_BACKWARD = {"sm90": ("flash_bwd_sm90", {"dq": "repro_flash_dq_sm90",
                                         "dkv": "repro_flash_dkv_sm90"}),
             "f32tc": ("flash_bwd_f32tc", {"dq": "repro_flash_dq_f32tc",
                                           "dkv": "repro_flash_dkv_f32tc"}),
             "simt": ("flash_bwd", {"dq": "repro_flash_dq",
                                    "dkv": "repro_flash_dkv"})}
_BACKWARD_SM90_D256 = ("flash_bwd_sm90_d256",
                       {"dq": "repro_flash_dq_sm90_d256",
                        "dkv": "repro_flash_dkv_sm90_d256"})


#: the f32 route of each pass, whose tolerances bf16 tensor cores cannot
#: meet: both in 3xTF32 on the tensor cores
_F32_ROUTES = {"fwd": "f32tc", "bwd": "f32tc"}


def _route(dtype: torch.dtype, head_dim: int, kind: str) -> str:
    """The route of the ``kind`` pass (``"fwd"`` or ``"bwd"``) for inputs
    of ``dtype`` and ``head_dim``: ``"sm90"`` for bf16 with head_dim up to
    256 (the ``csrc/flash_*_sm90.cu`` kernels with it padded to 16, 32, 64,
    80 or 128; the ``csrc/flash_*_sm90_d256.cu`` ones above, padded to
    256); for f32 ``_F32_ROUTES[kind]``, ``"f32tc"`` for both
    (``csrc/flash_fwd_f32tc.cu``, ``csrc/flash_bwd_f32tc.cu``)."""
    if dtype == torch.bfloat16 and head_dim <= _MAX_HEAD_DIM:
        return "sm90"
    return _F32_ROUTES[kind]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Lq, D) and k, v (B, Hkv, Lk, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head_dim")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} q-heads are not groups of {k.shape[1]} "
                         f"kv-heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D % 8 or not 0 < D <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} is not a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    block_q: int = 256, block_k: int = 256, *,
                    return_lse: bool = False):
    """``q``: (B, Hq, Lq, D); ``k``/``v``: (B, Hkv, Lk, D), Hq % Hkv == 0.
    Returns O (B, Hq, Lq, D) in ``q``'s dtype, and with ``return_lse`` also
    the row log-sum-exp (B, Hq, Lq) in f32.

    ``block_q``/``block_k`` are the reference's tile sizes, kept so calls
    read the same in both packages; the CUDA kernels pick their own tiles
    and take any Lq, Lk.  The kernels follow ``_route``.
    """
    _check(q, k, v)
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive: {block_q}, "
                         f"{block_k}")
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    _device(q, "flash_attention")
    o, lse = _FlashAttention.apply(q, k, v, scale, causal, window, softcap)
    return (o, lse) if return_lse else o


class _FlashAttention(torch.autograd.Function):
    """The reference's custom vjp: the forward kernel, then the two
    backward kernels on the saved q, k, v, O (in its own dtype) and the
    f32 LSE.  The LSE is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        o, lse = torch.ops.repro_torch.flash_fwd(q, k, v, scale, causal,
                                                 window, softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, window, softcap)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, *ctx.args),
                None, None, None, None)


def _device(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def flash_attention_bwd(q, k, v, o, lse, do, scale: float,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None) -> tuple:
    """The reference's ``_bwd``: ``(dq, dk, dv)`` in the dtypes of ``q``,
    ``k``, ``v`` from the forward's O and LSE and the output gradient
    ``do``.  delta = rowsum(dO * O) in f32 from the stored O; dK and dV
    come per q-head in f32 and are summed over each GQA group, then cast
    once."""
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    dq = flash_attention_dq(*args)
    dkh, dvh = flash_attention_dkv(*args)
    B, Hkv, Lk, D = k.shape
    g = q.shape[1] // Hkv
    return (dq, dkh.view(B, Hkv, g, Lk, D).sum(2).to(k.dtype),
            dvh.view(B, Hkv, g, Lk, D).sum(2).to(v.dtype))


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {do.dtype}{tuple(do.shape)} on {do.device} "
                         f"does not match q {q.dtype}{tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or \
                x.device != q.device:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:3])} on "
                             f"{q.device}; got {x.dtype}{tuple(x.shape)}")


def flash_attention_dq(q, k, v, do, lse, delta, scale: float,
                       causal: bool = True, window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """dQ (B, Hq, Lq, D) in ``q``'s dtype: the ``_dq_kernel`` kernel of
    ``_route`` on a CUDA tensor (counted on that kernel's counter),
    the plain version on a CPU one."""
    _check_bwd(q, k, v, do, lse, delta)
    _device(q, "flash_attention_dq")
    return torch.ops.repro_torch.flash_dq(q, k, v, do, lse, delta, scale,
                                          causal, window, softcap)


def flash_attention_dkv(q, k, v, do, lse, delta, scale: float,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None) -> tuple:
    """Per-q-head dK and dV, each (B, Hq, Lk, D) f32 (the caller sums each
    GQA group): the ``_dkv_kernel`` kernel of ``_route`` on a
    CUDA tensor (counted on that kernel's counter), the plain version on a
    CPU one."""
    _check_bwd(q, k, v, do, lse, delta)
    _device(q, "flash_attention_dkv")
    return torch.ops.repro_torch.flash_dkv(q, k, v, do, lse, delta, scale,
                                           causal, window, softcap)


# -- the three passes as custom ops -------------------------------------------
# A CPU tensor takes the plain version, a CUDA tensor the kernel (or the
# launch raises); the fake implementations run only under FakeTensorMode or
# on meta tensors, where they give the outputs' shapes and dtypes.

@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, window: Optional[int],
                  softcap: Optional[float]) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal, window, softcap)
    return _launch(q, k, v, scale, causal, window, softcap)


@_flash_fwd_op.register_fake
def _(q, k, v, scale, causal, window, softcap):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=torch.float32)


def _dkv_shape(q, k) -> tuple:
    return (q.shape[0], q.shape[1], k.shape[2], q.shape[3])


@torch.library.custom_op("repro_torch::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 scale: float, causal: bool, window: Optional[int],
                 softcap: Optional[float]) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, do, lse, delta, scale,
                                      causal, window, softcap)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", (dq,), q, k, v, do, lse, delta, scale, causal, window,
                softcap)
    return dq


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal, window, softcap):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float, causal: bool, window: Optional[int],
                  softcap: Optional[float]) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, scale,
                                       causal, window, softcap)
    dk, dv = (torch.empty(_dkv_shape(q, k), dtype=torch.float32,
                          device=q.device) for _ in range(2))
    _launch_bwd("dkv", (dk, dv), q, k, v, do, lse, delta, scale, causal,
                window, softcap)
    return dk, dv


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal, window, softcap):
    return (q.new_empty(_dkv_shape(q, k), dtype=torch.float32),
            q.new_empty(_dkv_shape(q, k), dtype=torch.float32))


def live_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """(q, k) pairs the masks keep (causal; the one-sided window ``q - k <
    window``): the work the data needs."""
    qp = np.arange(Lq)
    lo = np.zeros(Lq, np.int64) if window is None else \
        np.maximum(qp - window + 1, 0)
    hi = np.minimum(qp + 1, Lk) if causal else np.full(Lq, Lk)
    return int(np.maximum(hi - lo, 0).sum())


def flash_flops(kind: str, q_shape, k_shape, causal, window) -> int:
    """Useful flops of one pass (``"fwd"``, ``"dq"`` or ``"dkv"``) over q
    (B, Hq, Lq, D) and k (B, Hkv, Lk, D): 4·D, 6·D or 8·D a live pair of
    every (batch, q-head)."""
    B, Hq, Lq, D = q_shape
    per = {"fwd": 4, "dq": 6, "dkv": 8}[kind]
    return per * D * B * Hq * live_pairs(Lq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _fwd_flops(q, k, v, scale, causal, window, softcap, *a, **kw) -> int:
    return flash_flops("fwd", q, k, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_dq)
def _dq_flops(q, k, v, do, lse, delta, scale, causal, window, softcap,
              *a, **kw) -> int:
    return flash_flops("dq", q, k, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_dkv)
def _dkv_flops(q, k, v, do, lse, delta, scale, causal, window, softcap,
               *a, **kw) -> int:
    return flash_flops("dkv", q, k, causal, window)


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it in place (D contiguous,
    16-byte aligned rows), else a contiguous copy."""
    elems = 16 // x.element_size()
    if (x.stride(3) == 1 and all(s % elems == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def _mask_args(causal, window, softcap) -> tuple:
    return (int(causal), int(window is not None),
            0 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap))


def _launch(q, k, v, scale, causal, window, softcap, route=None) -> tuple:
    """Launch a forward kernel on checked CUDA tensors, on the current
    stream: ``route`` names it (``"sm90"``, ``"f32tc"`` or ``"simt"``), by
    default ``_route``'s.  Counts the launch on the kernel's own counter
    (``_COUNTERS``)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    route = route or _route(q.dtype, D, "fwd")
    if route == "sm90" and _route(q.dtype, D, "fwd") != "sm90":
        raise ValueError(f"the sm90 forward takes bf16 with head_dim up to "
                         f"{_MAX_HEAD_DIM}; got {q.dtype}, {D}")
    if route == "f32tc" and q.dtype != torch.float32:
        raise ValueError(f"the f32tc forward takes f32; got {q.dtype}")
    wide = route == "sm90" and D > _SM90_NARROW_HEAD_DIM
    q, k, v = (_kernel_view(x) for x in (q, k, v))
    o = torch.empty((B, Hq, Lq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    name, entry = _FORWARD_SM90_D256 if wide else _FORWARD[route]
    lib = _build.load(name)
    # the tensor-core kernels take one dtype; the CUDA-core one is told it
    dtype_flag = (int(q.dtype == torch.bfloat16),) if route == "simt" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Lq, Lk, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *dtype_flag,
            *_mask_args(causal, window, softcap), float(scale), stream)
    _build.check(lib, code, f"flash_attention ({name})")
    _build.count(_COUNTERS[entry])
    return o, lse


def _launch_bwd(kernel, outs, q, k, v, do, lse, delta, scale, causal,
                window, softcap, route=None) -> None:
    """Launch the backward kernel ``kernel`` (``"dq"`` or ``"dkv"``) into
    ``outs`` on checked CUDA tensors, on the current stream: ``route``
    names its library (``"sm90"``, ``"f32tc"`` or ``"simt"``), by default
    ``_route``'s, on its head_dim-256 library above head_dim
    128.  Counts the launch on the kernel's own counter (``_COUNTERS``)."""
    D = q.shape[3]
    route = route or _route(q.dtype, D, "bwd")
    if route not in _BACKWARD:
        raise ValueError(f"no backward route {route!r}")
    if route == "sm90" and _route(q.dtype, D, "bwd") != "sm90":
        raise ValueError(f"the sm90 backward takes bf16 with head_dim up to "
                         f"{_MAX_HEAD_DIM}; got {q.dtype}, {D}")
    if route == "f32tc" and q.dtype != torch.float32:
        raise ValueError(f"the f32tc backward takes f32; got {q.dtype}")
    wide = route == "sm90" and D > _SM90_NARROW_HEAD_DIM
    if outs[0].numel() == 0:
        return
    q, k, v, do = (_kernel_view(x) for x in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    B, Hq, Lq, _ = q.shape
    name, entries = _BACKWARD_SM90_D256 if wide else _BACKWARD[route]
    lib = _build.load(name)
    # the tensor-core kernels take one dtype; the CUDA-core ones are told it
    dtype_flag = (int(q.dtype == torch.bfloat16),) if route == "simt" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entries[kernel])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            B, Hq, k.shape[1], Lq, k.shape[2], D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *dtype_flag,
            *_mask_args(causal, window, softcap), float(scale), stream)
    _build.check(lib, code, f"flash_attention_{kernel} ({name})")
    _build.count(_COUNTERS[entries[kernel]])


#: kernel launches since the last reset (CPU calls never count), one
#: counter per kernel, each added to by that kernel's launches alone: the
#: wrappers' own count the sm90 route's first kernels (head_dim up to 128),
#: the ``d256_*`` counters its head_dim-256 kernels, the ``f32tc_*`` ones
#: the 3xTF32 kernels, the ``simt_*`` ones the CUDA-core kernels
flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
d256_forward = SimpleNamespace(launches=0)
d256_dq = SimpleNamespace(launches=0)
d256_dkv = SimpleNamespace(launches=0)
f32tc_forward = SimpleNamespace(launches=0)
f32tc_dq = SimpleNamespace(launches=0)
f32tc_dkv = SimpleNamespace(launches=0)
simt_forward = SimpleNamespace(launches=0)
simt_dq = SimpleNamespace(launches=0)
simt_dkv = SimpleNamespace(launches=0)
#: C entry point -> its kernel's launch counter
_COUNTERS = {"repro_flash_fwd_sm90": flash_attention,
             "repro_flash_fwd_sm90_d256": d256_forward,
             "repro_flash_fwd_f32tc": f32tc_forward,
             "repro_flash_fwd": simt_forward,
             "repro_flash_dq_sm90": flash_attention_dq,
             "repro_flash_dq_sm90_d256": d256_dq,
             "repro_flash_dq_f32tc": f32tc_dq,
             "repro_flash_dq": simt_dq,
             "repro_flash_dkv_sm90": flash_attention_dkv,
             "repro_flash_dkv_sm90_d256": d256_dkv,
             "repro_flash_dkv_f32tc": f32tc_dkv,
             "repro_flash_dkv": simt_dkv}
