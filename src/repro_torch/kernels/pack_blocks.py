"""``pack_rows`` on the card: the paper's block merge as a copy engine.

The merge (Alg. 1's final loop) and the read-side linearization are both
"move contiguous runs between two flat buffers" problems.  ``ops.py``
lowers a MergePlan to a *row table*: both buffers are viewed as
``(rows, W)`` with W the largest common contiguous width, and each table
entry copies one W-wide row ``dst[dst_rows[i]] = src[src_rows[i]]``.

The CUDA kernel (``csrc/pack_rows.cu``) replaces the JAX package's Pallas
``_pack_kernel``; its note says what bounds it and how it is laid out.  A
tensor on the CPU takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.  :func:`pack_rows` takes row tables on the
tensor's device and checks them there; the main path's tables are numpy
arrays, checked on the host before they cross (``ops.pack_tables``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import pack_rows_ref

__all__ = ["pack_rows"]


def _check_range(lo: int, hi: int, n: int, name: str) -> None:
    if lo < 0 or hi >= n:
        raise IndexError(f"{name} spans [{lo}, {hi}], outside the "
                         f"{n} rows it indexes")


def _check_table(rows: torch.Tensor, n: int, name: str,
                 device: torch.device) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                        f"{rows.dtype} of shape {tuple(rows.shape)}")
    if rows.device != device:
        raise ValueError(f"{name} is on {rows.device}, src on {device}")
    if not rows.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if rows.numel():
        _check_range(*(int(v) for v in torch.aminmax(rows)), n, name)


def _check_host_table(rows: np.ndarray, n: int, name: str) -> None:
    """:func:`_check_table` for a numpy table: the same errors, with no
    device in the way."""
    if rows.dtype != np.int32 or rows.ndim != 1:
        raise TypeError(f"{name} must be a 1-D int32 array, got "
                        f"{rows.dtype} of shape {rows.shape}")
    if rows.size:
        _check_range(*(int(v) for v in torch.aminmax(torch.from_numpy(rows))),
                     n, name)


def pack_rows(src: torch.Tensor, src_rows: torch.Tensor,
              dst_rows: torch.Tensor, *, n_dst_rows: int,
              width: int) -> torch.Tensor:
    """Copy rows of ``src`` (viewed as ``(-1, width)``) into a fresh
    zeroed ``(n_dst_rows, width)`` tensor at ``dst_rows``.

    ``src_rows``/``dst_rows``: int32 ``(R,)`` row tables on ``src``'s
    device; ``dst_rows`` are distinct.  Rows not named in ``dst_rows`` are
    zero.
    """
    _check_src(src, width, src_rows.shape, dst_rows.shape)
    _check_table(src_rows, src.numel() // width, "src_rows", src.device)
    _check_table(dst_rows, n_dst_rows, "dst_rows", src.device)
    if src.device.type == "cpu":
        return pack_rows_ref(src, src_rows, dst_rows, n_dst_rows=n_dst_rows,
                             width=width)
    out = torch.zeros((n_dst_rows, width), dtype=src.dtype,
                      device=src.device)
    launch(src, out, src_rows, dst_rows, width)
    return out


def _check_src(src: torch.Tensor, width: int, src_shape, dst_shape) -> None:
    if src.numel() % width:
        raise ValueError(f"{src.numel()} elements are not rows of {width}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if tuple(src_shape) != tuple(dst_shape):
        raise ValueError(f"row tables differ in length: "
                         f"{tuple(src_shape)} vs {tuple(dst_shape)}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_rows runs on cuda or cpu, not {src.device}")


def _pack_host_tables(src: torch.Tensor, src_rows: np.ndarray,
                      dst_rows: np.ndarray, *, n_dst_rows: int, width: int,
                      covered: bool) -> torch.Tensor:
    """:func:`pack_rows` for row tables held on the host as numpy arrays:
    checked there, so no device-to-host sync is left, then sent to the card
    in one asynchronous copy from pinned memory.  ``covered``: the caller
    has shown that ``dst_rows`` names every destination row exactly once,
    so the output is not zero-filled first."""
    _check_src(src, width, src_rows.shape, dst_rows.shape)
    _check_host_table(src_rows, src.numel() // width, "src_rows")
    _check_host_table(dst_rows, n_dst_rows, "dst_rows")
    if src.device.type == "cpu":
        return pack_rows_ref(src, torch.from_numpy(src_rows),
                             torch.from_numpy(dst_rows),
                             n_dst_rows=n_dst_rows, width=width)
    n = len(src_rows)
    host = torch.empty(2 * n, dtype=torch.int32, pin_memory=True)
    torch.cat((torch.from_numpy(src_rows), torch.from_numpy(dst_rows)),
              out=host)
    tables = host.to(src.device, non_blocking=True)
    shape = (n_dst_rows, width)
    out = torch.empty(shape, dtype=src.dtype, device=src.device) if covered \
        else torch.zeros(shape, dtype=src.dtype, device=src.device)
    launch(src, out, tables[:n], tables[n:], width)
    return out


def launch(src: torch.Tensor, out: torch.Tensor, src_rows: torch.Tensor,
           dst_rows: torch.Tensor, width: int) -> None:
    """Launch the kernel on checked CUDA tensors, on the current stream,
    into ``out`` as it is (no fill).  Counts the launch."""
    n = src_rows.numel()
    if n == 0:
        return
    lib = _build.load("pack_rows")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = lib.repro_pack_rows(src.data_ptr(), out.data_ptr(),
                                   src_rows.data_ptr(), dst_rows.data_ptr(),
                                   n, width * src.element_size(), stream)
    _build.check(lib, code, "pack_rows")
    _build.count(pack_rows)


#: kernel launches since the last reset (CPU calls never count)
pack_rows.launches = 0
