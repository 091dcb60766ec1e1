"""Plain PyTorch versions of the kernels (the three copies, the flash
attention forward and its two backward kernels), and the lowerings to the
row tables ``pack_rows`` takes: of a :class:`~repro_torch.core.merge.
MergePlan` (the merge, the whole-variable read), of a region read's
plans (the region read, the elastic restore) and of a layout's chunks
filled from their sources (the write).

The plain versions are the oracles: the CPU tests run them against the JAX
package's Pallas kernels (interpret mode), and ``chip_smoke.py`` holds each
CUDA kernel to them on the card.  The kernel wrappers run them only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.merge import MergePlan

__all__ = ["pack_rows_ref", "chunked_to_rowmajor_ref",
           "rowmajor_to_chunked_ref", "flash_attention_ref",
           "flash_attention_dq_ref", "flash_attention_dkv_ref",
           "flash_attention_bwd_ref",
           "plan_row_tables", "region_row_tables", "chunk_row_tables"]


def pack_rows_ref(src: torch.Tensor, src_rows: torch.Tensor,
                  dst_rows: torch.Tensor, *, n_dst_rows: int,
                  width: int) -> torch.Tensor:
    """``dst[dst_rows[i]] = src.view(-1, width)[src_rows[i]]`` into a fresh
    zeroed ``(n_dst_rows, width)`` tensor (``dst_rows`` are distinct)."""
    src2 = src.reshape(-1, width)
    out = torch.zeros((n_dst_rows, width), dtype=src.dtype,
                      device=src.device)
    out[dst_rows.long()] = src2[src_rows.long()]
    return out


def chunked_to_rowmajor_ref(chunks: torch.Tensor) -> torch.Tensor:
    """``(n_i, n_j, ch, cw)`` stored chunks -> ``(n_i*ch, n_j*cw)``, one
    ``(ch, cw)`` tile copy per chunk as the Pallas grid walks them."""
    n_i, n_j, ch, cw = chunks.shape
    out = torch.empty((n_i * ch, n_j * cw), dtype=chunks.dtype,
                      device=chunks.device)
    for i in range(n_i):
        for j in range(n_j):
            out[i * ch:(i + 1) * ch, j * cw:(j + 1) * cw] = chunks[i, j]
    return out


def rowmajor_to_chunked_ref(arr: torch.Tensor, chunk) -> torch.Tensor:
    """Inverse: ``(H, W)`` -> ``(H/ch, W/cw, ch, cw)``, one tile per chunk."""
    H, W = arr.shape
    ch, cw = chunk
    n_i, n_j = H // ch, W // cw
    out = torch.empty((n_i, n_j, ch, cw), dtype=arr.dtype,
                      device=arr.device)
    for i in range(n_i):
        for j in range(n_j):
            out[i, j] = arr[i * ch:(i + 1) * ch, j * cw:(j + 1) * cw]
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None) -> tuple:
    """Attention over whole rows in f32: ``(O, LSE)`` with O in ``q``'s
    dtype and LSE ``(B, Hq, Lq)`` f32.  ``q``: ``(B, Hq, Lq, D)``;
    ``k``/``v``: ``(B, Hkv, Lk, D)``, q-head h reading kv-head
    ``h // (Hq // Hkv)``.  Scale, then softcap, then the mask (``qpos >=
    kpos`` when causal, ``qpos - kpos < window`` whenever a window is set);
    masked scores are -1e30, as in the Pallas kernel."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    g = H // k.shape[1]
    scale = scale or 1.0 / math.sqrt(D)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(_mask(Lq, Lk, causal, window, q.device), s, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype), lse


def _mask(Lq: int, Lk: int, causal: bool, window, device) -> torch.Tensor:
    qp = torch.arange(Lq, device=device)[:, None]
    kp = torch.arange(Lk, device=device)[None, :]
    m = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= (qp - kp) < window
    return m


def _p_ds(q, k, v, do, lse, delta, scale, causal, window, softcap) -> tuple:
    """The reference's ``_p_ds`` on whole (Lq, Lk) matrices in f32: P
    recomputed from the forward's LSE, and dS = P * (dP - delta) * the
    softcap's derivative * scale, zero where masked.  Returns ``(p, ds,
    kk)`` with ``kk`` the f32 keys repeated per q-head."""
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    sraw = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap is not None:
        t = torch.tanh(sraw / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    else:
        s, dcap = sraw, 1.0
    m = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.where(m, s, -1e30)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vv)
    ds = p * (dp - delta[..., None]) * dcap * scale
    return p, torch.where(m, ds, 0.0), kk


def flash_attention_dq_ref(q, k, v, do, lse, delta, scale: float,
                           causal: bool = True, window: int | None = None,
                           softcap: float | None = None) -> torch.Tensor:
    """What ``_dq_kernel`` computes: dQ = dS.K in ``q``'s dtype.  ``do``
    like ``q``; ``lse``, ``delta``: (B, Hq, Lq) f32."""
    _, ds, kk = _p_ds(q, k, v, do, lse, delta, scale, causal, window,
                      softcap)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kk).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, scale: float,
                            causal: bool = True, window: int | None = None,
                            softcap: float | None = None) -> tuple:
    """What ``_dkv_kernel`` computes: per-q-head dK = dS^T.Q and dV =
    P^T.dO, each (B, Hq, Lk, D) f32, before the GQA group sum."""
    p, ds, _ = _p_ds(q, k, v, do, lse, delta, scale, causal, window,
                     softcap)
    return (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.float()))


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale: float | None = None,
                            causal: bool = True, window: int | None = None,
                            softcap: float | None = None) -> tuple:
    """The reference's ``_bwd`` in f32 on whole matrices: ``(dq, dk, dv)``
    in the dtypes of ``q``, ``k``, ``v``, from the forward's stored O (in
    its own dtype) and f32 LSE.  delta = rowsum(dO * O) in f32; dK and dV
    are summed over each GQA group in f32 and cast once."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    dq = flash_attention_dq_ref(*args)
    dkh, dvh = flash_attention_dkv_ref(*args)
    B, Hkv, Lk, D = k.shape
    g = q.shape[1] // Hkv
    return (dq, dkh.view(B, Hkv, g, Lk, D).sum(2).to(k.dtype),
            dvh.view(B, Hkv, g, Lk, D).sum(2).to(v.dtype))


# -- plan lowering -------------------------------------------------------------

def _row_major_strides(shape) -> list:
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    return strides


def plan_row_tables(plan: MergePlan, block_order=None,
                    max_width: int = 4096) -> tuple:
    """Lower a MergePlan to ``(width, src_rows, dst_rows, dst_elems,
    src_layout)`` for :func:`repro_torch.kernels.pack_blocks.pack_rows`.

    Source layout: the blocks' data concatenated flat in ``block_order``
    (default: ascending block_id).  Destination: the merged buffers
    concatenated in cluster order.  Every contiguous run on both sides —
    one per leading index of each block — is decomposed into
    ``width``-wide rows with width = gcd of all run offsets/lengths (capped
    at ``max_width``).  The runs of one block are generated with numpy, so
    the cost is one vectorized pass per block, not a Python step per run;
    the output equals the JAX package's reference lowering exactly.
    """
    blocks = {}
    for op in plan.copies:
        blocks[op.block_id] = op.src_block
    order = block_order or sorted(blocks)
    src_off = {}
    pos = 0
    for bid in order:
        src_off[bid] = pos
        pos += blocks[bid].volume
    total_src = pos

    dst_off = []
    pos = 0
    for cl in plan.clusters:
        dst_off.append(pos)
        pos += cl.cuboid.volume
    total_dst = pos

    # contiguous runs in copy order; within a copy, leading indices in
    # row-major order: src start, dst start, length (the block's last axis)
    starts_s, starts_d, lengths = [], [], []
    for op in plan.copies:
        b = op.src_block
        cu = plan.clusters[op.dst_index].cuboid
        inner = b.shape[-1]
        dstr = _row_major_strides(cu.shape)
        base = dst_off[op.dst_index] + sum(
            (bl - cl) * s for bl, cl, s in zip(b.lo, cu.lo, dstr))
        lead_off = np.zeros(1, dtype=np.int64)
        for n, s in zip(b.shape[:-1], dstr[:-1]):
            lead_off = (lead_off[:, None]
                        + np.arange(n, dtype=np.int64)[None, :] * s
                        ).reshape(-1)
        n_lead = lead_off.size
        starts_s.append(src_off[op.block_id]
                        + np.arange(n_lead, dtype=np.int64) * inner)
        starts_d.append(base + lead_off)
        lengths.append(np.full(n_lead, inner, dtype=np.int64))
    s = np.concatenate(starts_s) if starts_s else np.empty(0, np.int64)
    d = np.concatenate(starts_d) if starts_d else np.empty(0, np.int64)
    ln = np.concatenate(lengths) if lengths else np.empty(0, np.int64)
    width, src_rows, dst_rows = _tables_from_runs(s, d, ln, total_src,
                                                  total_dst, max_width)
    return width, src_rows, dst_rows, total_dst, src_off


def _tables_from_runs(s: np.ndarray, d: np.ndarray, ln: np.ndarray,
                      total_src: int, total_dst: int,
                      max_width: int) -> tuple:
    """``(width, src_rows, dst_rows)`` for the contiguous runs ``s[i] ->
    d[i]`` of ``ln[i]`` elements: width is the gcd of every start, length
    and both totals, capped at ``max_width``."""
    g = math.gcd(total_src, total_dst)
    for arr in (s, d, ln):
        if arr.size:
            g = math.gcd(g, int(np.gcd.reduce(arr)))
    g = max(g, 1)
    # width: the largest divisor of g not exceeding max_width
    width = g
    while width > max_width:
        # halve while possible, else fall back to the largest divisor
        width = width // 2 if width % 2 == 0 else 1
    if width == 1 and g > 1:
        width = min(g, max_width)
        while g % width:
            width -= 1
    if max(total_src, total_dst) // width > np.iinfo(np.int32).max:
        raise OverflowError(f"{max(total_src, total_dst) // width} rows of "
                            f"width {width} overflow the int32 row tables")
    per_run = ln // width
    if (per_run == 1).all():                 # each run is one row
        return width, (s // width).astype(np.int32), \
            (d // width).astype(np.int32)
    first = np.cumsum(per_run) - per_run
    k = np.arange(int(per_run.sum()), dtype=np.int64) \
        - np.repeat(first, per_run)
    src_rows = (np.repeat(s // width, per_run) + k).astype(np.int32)
    dst_rows = (np.repeat(d // width, per_run) + k).astype(np.int32)
    return width, src_rows, dst_rows


def region_row_tables(plans, max_width: int = 4096) -> tuple:
    """Lower the read plans of target regions of one variable of raw
    chunks (:class:`~repro_torch.io.planner.ReadPlan`, one a region) to
    ``(width, src_rows, dst_rows, dst_elems, spans)`` for one ``pack_rows``
    launch.

    Source: each touched stored extent's needed bytes — the hull of its
    ``[file_lo, file_hi)`` over every plan that touches it — back to back
    in ``(subfile, offset)`` order, each extent once however many targets
    intersect it; ``spans`` is ``(subfiles, file_lo, file_hi)`` of those
    byte spans, in that order, for the engine to read.  Destination: the
    target regions row-major, concatenated in plan order.  Each run is one
    intersection row along the last axis; width is the gcd of every run's
    start and length and of both totals, capped at ``max_width``, as
    :func:`plan_row_tables` takes it.  An intersection one element wide
    gives width 1: correct, but one element a row, so slow.  Rows of a
    target that no stored chunk covers are named by no table entry.
    """
    if any(p.codecs is not None for p in plans):
        raise ValueError("compressed chunks cannot be gathered from their "
                         "stored bytes")
    itemsize = plans[0].dtype.itemsize

    def cat(field):
        return np.concatenate([getattr(p, field) for p in plans])

    rec = cat("rec_ids")
    uniq, first, inv = np.unique(rec, return_index=True, return_inverse=True)
    lo = np.full(len(uniq), np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.zeros(len(uniq), dtype=np.int64)
    np.minimum.at(lo, inv, cat("file_lo"))
    np.maximum.at(hi, inv, cat("file_hi"))
    sub = cat("subfiles")[first]
    order = np.lexsort((lo, sub))
    size = hi - lo
    base = np.empty(len(uniq), dtype=np.int64)
    base[order] = np.cumsum(size[order]) - size[order]
    # element index, in the source, of each extent's first stored element
    # (before the span when the span starts inside the extent)
    origin = (base - (lo - cat("extent_offsets")[first])) // itemsize
    total_src = int(size.sum()) // itemsize

    starts_s, starts_d, lengths = [], [], []
    dst_base = 0
    k = 0
    for p in plans:
        rlo = np.asarray(p.region.lo, dtype=np.int64)
        rstr = np.asarray(_row_major_strides(p.region.shape), dtype=np.int64)
        for r in range(p.num_chunks):
            ilo = p.inter_los[r]
            ish = p.inter_his[r] - ilo
            cst = p.strides[r]
            lead_s = np.zeros(1, dtype=np.int64)
            lead_d = np.zeros(1, dtype=np.int64)
            for n, ss, ds in zip(ish[:-1], cst[:-1], rstr[:-1]):
                a = np.arange(n, dtype=np.int64)
                lead_s = (lead_s[:, None] + a[None, :] * ss).reshape(-1)
                lead_d = (lead_d[:, None] + a[None, :] * ds).reshape(-1)
            starts_s.append(origin[inv[k]]
                            + int(((ilo - p.chunk_los[r]) * cst).sum())
                            + lead_s)
            starts_d.append(dst_base + int(((ilo - rlo) * rstr).sum())
                            + lead_d)
            lengths.append(np.full(lead_s.size, ish[-1], dtype=np.int64))
            k += 1
        dst_base += p.region.volume
    s = np.concatenate(starts_s) if starts_s else np.empty(0, np.int64)
    d = np.concatenate(starts_d) if starts_d else np.empty(0, np.int64)
    ln = np.concatenate(lengths) if lengths else np.empty(0, np.int64)
    width, src_rows, dst_rows = _tables_from_runs(s, d, ln, total_src,
                                                  dst_base, max_width)
    return width, src_rows, dst_rows, dst_base, (sub[order], lo[order],
                                                  hi[order])


def chunk_row_tables(layout, max_width: int = 4096) -> tuple:
    """Lower the chunks of a :class:`~repro_torch.core.layouts.LayoutPlan`,
    each filled from its sources' intersections as the JAX package's
    ``assemble_chunk`` fills it, to ``(width, src_rows, dst_rows,
    dst_elems, order)`` for one ``pack_rows`` launch — the write-side
    counterpart of :func:`region_row_tables`.

    Source: the distinct source blocks flat, back to back in ascending
    ``block_id`` (``order``).  Destination: the chunks row-major,
    concatenated in ``layout.chunks`` order.  Each run is one row of a
    chunk-source intersection along the last axis; width is the gcd of
    every run's start and length and of both totals, capped at
    ``max_width``.  Rows of a chunk that no source covers are named by no
    table entry; a row two sources cover is named twice.
    """
    sources = {}
    for cp in layout.chunks:
        for b in cp.sources:
            sources[b.block_id] = b
    order = sorted(sources)
    src_off, pos = {}, 0
    for bid in order:
        src_off[bid] = pos
        pos += sources[bid].volume
    total_src = pos

    starts_s, starts_d, lengths = [], [], []
    dst_base = 0
    for cp in layout.chunks:
        clo = np.asarray(cp.chunk.lo, dtype=np.int64)
        cstr = np.asarray(_row_major_strides(cp.chunk.shape), dtype=np.int64)
        for b in cp.sources:
            inter = cp.chunk.intersect(b)
            if inter is None:
                continue
            ilo = np.asarray(inter.lo, dtype=np.int64)
            ish = np.asarray(inter.shape, dtype=np.int64)
            sstr = np.asarray(_row_major_strides(b.shape), dtype=np.int64)
            lead_s = np.zeros(1, dtype=np.int64)
            lead_d = np.zeros(1, dtype=np.int64)
            for n, ss, ds in zip(ish[:-1], sstr[:-1], cstr[:-1]):
                a = np.arange(n, dtype=np.int64)
                lead_s = (lead_s[:, None] + a[None, :] * ss).reshape(-1)
                lead_d = (lead_d[:, None] + a[None, :] * ds).reshape(-1)
            blo = np.asarray(b.lo, dtype=np.int64)
            starts_s.append(src_off[b.block_id]
                            + int(((ilo - blo) * sstr).sum()) + lead_s)
            starts_d.append(dst_base + int(((ilo - clo) * cstr).sum())
                            + lead_d)
            lengths.append(np.full(lead_s.size, ish[-1], dtype=np.int64))
        dst_base += cp.chunk.volume
    s = np.concatenate(starts_s) if starts_s else np.empty(0, np.int64)
    d = np.concatenate(starts_d) if starts_d else np.empty(0, np.int64)
    ln = np.concatenate(lengths) if lengths else np.empty(0, np.int64)
    width, src_rows, dst_rows = _tables_from_runs(s, d, ln, total_src,
                                                  dst_base, max_width)
    return width, src_rows, dst_rows, dst_base, order
