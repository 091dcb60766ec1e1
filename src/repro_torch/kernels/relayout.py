"""Chunk-grid relayout on the card (read-side linearization and write-side
re-tiling).

When the stored layout is a regular chunk grid (paper §2.2 / the
reorganized layout of §5), the map from stored chunk ``(i, j)`` to its
place in the row-major array is affine.  Both directions run the one CUDA
kernel of ``csrc/relayout.cu``, which replaces the JAX package's Pallas
``_unchunk_kernel`` / ``_chunk_kernel``.  2-D only, like the reference.  A
tensor on the CPU takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import chunked_to_rowmajor_ref, rowmajor_to_chunked_ref

__all__ = ["chunked_to_rowmajor", "rowmajor_to_chunked"]


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel, False for the plain version; raises otherwise."""
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def chunked_to_rowmajor(chunks: torch.Tensor, *, chunk) -> torch.Tensor:
    """``chunks``: ``(n_i, n_j, ch, cw)`` stored-chunk tensor ->
    ``(n_i*ch, n_j*cw)`` row-major array."""
    if chunks.dim() != 4:
        raise ValueError(f"expected (n_i, n_j, ch, cw), got "
                         f"{tuple(chunks.shape)}")
    n_i, n_j, ch, cw = chunks.shape
    if (ch, cw) != tuple(chunk):
        raise ValueError(f"chunk {tuple(chunk)} != tensor tiles {(ch, cw)}")
    if not _route(chunks, "chunked_to_rowmajor"):
        return chunked_to_rowmajor_ref(chunks)
    out = torch.empty((n_i * ch, n_j * cw), dtype=chunks.dtype,
                      device=chunks.device)
    launch(chunks, out, n_i, n_j, ch, cw, to_rowmajor=True)
    return out


def rowmajor_to_chunked(arr: torch.Tensor, *, chunk) -> torch.Tensor:
    """Inverse: ``(H, W)`` row-major -> ``(H/ch, W/cw, ch, cw)`` chunk
    tensor (the write-side re-tiling a producer runs before emitting the
    reorganized layout)."""
    if arr.dim() != 2:
        raise ValueError(f"expected a 2-D array, got {tuple(arr.shape)}")
    H, W = arr.shape
    ch, cw = chunk
    if H % ch or W % cw:
        raise ValueError(f"chunk {(ch, cw)} does not divide {(H, W)}")
    if not _route(arr, "rowmajor_to_chunked"):
        return rowmajor_to_chunked_ref(arr, (ch, cw))
    n_i, n_j = H // ch, W // cw
    out = torch.empty((n_i, n_j, ch, cw), dtype=arr.dtype, device=arr.device)
    launch(arr, out, n_i, n_j, ch, cw, to_rowmajor=False)
    return out


def launch(src: torch.Tensor, out: torch.Tensor, n_i: int, n_j: int,
           ch: int, cw: int, *, to_rowmajor: bool) -> None:
    """Launch the kernel on checked CUDA tensors, on the current stream.
    Counts the launch on the wrapper of its direction."""
    if src.numel() == 0:
        return
    lib = _build.load("relayout")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = lib.repro_relayout(src.data_ptr(), out.data_ptr(), n_i, n_j,
                                  ch, cw * src.element_size(),
                                  int(to_rowmajor), stream)
    what = "chunked_to_rowmajor" if to_rowmajor else "rowmajor_to_chunked"
    _build.check(lib, code, what)
    if to_rowmajor:
        _build.count(chunked_to_rowmajor)
    else:
        _build.count(rowmajor_to_chunked)


#: kernel launches since the last reset (CPU calls never count)
chunked_to_rowmajor.launches = 0
rowmajor_to_chunked.launches = 0
