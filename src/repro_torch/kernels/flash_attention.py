"""Flash attention forward on the card: online-softmax tiled attention.

The CUDA kernel (``csrc/flash_fwd.cu``) replaces the JAX package's Pallas
``_fwd_kernel``: it keeps each score tile on chip with a running row max
and sum, so attention's device-memory traffic is Q, K, V and O only.
Causal and one-sided sliding-window masks, a logit softcap and GQA, as the
reference; any Lq and Lk (ragged edge tiles are masked) and head_dim a
multiple of 8 up to 256.  The backward kernels come with the training
slice.  A tensor on the CPU takes the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256


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
    read the same in both packages; the CUDA kernel tiles by 64 x 64 and
    takes any Lq, Lk.
    """
    _check(q, k, v)
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive: {block_q}, "
                         f"{block_k}")
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    elif q.device.type == "cuda":
        o, lse = _launch(q, k, v, scale, causal, window, softcap)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (o, lse) if return_lse else o


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it in place (D contiguous,
    16-byte aligned rows), else a contiguous copy."""
    elems = 16 // x.element_size()
    if (x.stride(3) == 1 and all(s % elems == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def _launch(q, k, v, scale, causal, window, softcap) -> tuple:
    """Launch the kernel on checked CUDA tensors, on the current stream.
    Counts the launch."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if B * Hq >= 65536:
        raise ValueError(f"B*Hq = {B * Hq}: the grid's y extent is 65535")
    q, k, v = (_kernel_view(x) for x in (q, k, v))
    o = torch.empty((B, Hq, Lq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Lq, Lk, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(q.dtype == torch.bfloat16),
            int(causal), int(window is not None),
            0 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap), float(scale), stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return o, lse


#: kernel launches since the last reset (CPU calls never count)
flash_attention.launches = 0
