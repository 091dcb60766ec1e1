"""Cross-request coalescing: fold N region queries into one super-plan — a
copy of the JAX package's module (pure numpy: the same index and regions
give the same plans, spans and scatter programs).

The multi-tenant read service batches concurrent region queries and merges
them here: every member request is planned once against a *shared* index
probe, the members' byte extents are folded into a union of disjoint spans
(vectorized interval union — no per-request Python loop), and the result
is a :class:`SuperPlan`: ONE ordinary :class:`~repro_torch.io.planner.
ReadPlan` over the merged spans (built by :func:`~repro_torch.io.planner.
build_span_plan`, so any engine executes it unchanged and
``engine="auto"`` prices it from its real shape) plus the scatter metadata
that routes slices of the flat fetch buffer back to each member.

Overlapping requests are fetched once; byte-adjacent requests merge into
one contiguous transfer.  The construction is pure metadata — execution
lives in :meth:`~repro_torch.io.reader.Dataset.read_super_planned`, which
gathers every raw member on the card in one ``pack_rows`` launch — which
is what lets the service cache super-plans across batches and drop them on
an index-generation change without holding any I/O state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from ..core.blocks import Block
from ..io.format import DatasetIndex
from ..io.planner import ReadPlan, build_read_plan, build_span_plan

__all__ = ["Request", "SuperPlan", "build_super_plan", "union_spans",
           "union_spans_naive"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One tenant's region query, as the service's front doors accept it."""

    tenant: str
    var: str
    region: Block


def union_spans(subfiles: np.ndarray, lo: np.ndarray,
                hi: np.ndarray) -> tuple:
    """Disjoint union of half-open byte spans ``[lo, hi)`` per subfile.

    Fully vectorized: spans are packed into a single
    integer key space — ``subfile * BIG + offset`` with ``BIG`` past the
    largest end offset — lexsorted once, and merged with a running-maximum
    scan.  Overlapping *and byte-adjacent* spans (``lo == previous hi``)
    fold together; the result is sorted by ``(subfile, lo)`` and pairwise
    disjoint with gaps.  Returns ``(subfiles, lo, hi)`` arrays.
    """
    subfiles = np.asarray(subfiles, dtype=np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    n = len(subfiles)
    if n == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    # one packed key space: offsets never reach BIG, so subfile boundaries
    # can never merge (end of subfile s tops out at s*BIG + BIG - 1, while
    # subfile s+1 starts at (s+1)*BIG or later)
    big = int(hi.max()) + 1
    order = np.lexsort((lo, subfiles))
    s, l, h = subfiles[order], lo[order], hi[order]
    lo_key = s * big + l
    hi_key = s * big + h
    cummax = np.maximum.accumulate(hi_key)
    new_span = np.empty(n, dtype=bool)
    new_span[0] = True
    # strict >: lo == running hi is adjacency and merges
    new_span[1:] = lo_key[1:] > cummax[:-1]
    starts = np.flatnonzero(new_span)
    ends = np.concatenate((starts[1:], [n]))
    u_subf = s[starts]
    u_lo = l[starts]
    # within a span the running max at its last row IS the span's max end:
    # every row's hi_key exceeds the previous spans' cummax by construction
    u_hi = cummax[ends - 1] - u_subf * big
    return u_subf, u_lo, u_hi


def union_spans_naive(subfiles, lo, hi) -> tuple:
    """Reference merger: plain sorted sweep, one span at a time.  The
    property-test oracle :func:`union_spans` must match bit-for-bit."""
    triples = sorted(zip([int(v) for v in subfiles],
                         [int(v) for v in lo],
                         [int(v) for v in hi]))
    out: list = []
    for s, l, h in triples:
        if out and out[-1][0] == s and l <= out[-1][2]:
            out[-1][2] = max(out[-1][2], h)
        else:
            out.append([s, l, h])
    if not out:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    arr = np.asarray(out, dtype=np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2]


@dataclasses.dataclass
class SuperPlan:
    """One shared gather serving N member reads (plan-construction half).

    ``members[i]`` is the ordinary per-request :class:`ReadPlan` (same
    construction as an independent read — the scatter geometry is reused
    verbatim, which is why coalesced results are byte-identical).
    ``member_span[i]`` maps each of member ``i``'s plan rows to the merged
    span containing it; ``span_out`` holds each span's offset inside the
    flat fetch buffer.  :meth:`fetch_plan` materializes the gather as a
    1-D ``uint8`` :class:`ReadPlan` over the merged spans — the execution
    half is :meth:`repro_torch.io.reader.Dataset.read_super_planned`.
    """

    var: str
    members: tuple
    member_span: tuple             # per member: (m_i,) span row per plan row
    span_subfiles: np.ndarray      # (S,) merged, disjoint, sorted spans
    span_lo: np.ndarray
    span_hi: np.ndarray
    span_out: np.ndarray           # (S,) flat-buffer offset of each span
    fetch_bytes: int               # bytes one shared gather transfers
    payload_bytes: int             # sum of members' payload bytes
    generation: int                # index generation the plan was built from
    probe_seconds: float = 0.0
    plan_seconds: float = 0.0

    _programs: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def num_members(self) -> int:
        return len(self.members)

    @property
    def num_spans(self) -> int:
        return len(self.span_lo)

    def fetch_plan(self) -> ReadPlan:
        return build_span_plan(self.var, self.span_subfiles, self.span_lo,
                               self.span_hi)

    def scatter_programs(self) -> tuple:
        """Per-member scatter programs, computed once and cached with the
        plan (the service's plan cache amortizes this too).

        A member row whose needed bytes are contiguous in the stored
        extent AND whose destination slice is contiguous in the member's
        output array (trailing dims fully covered) is a single flat byte
        copy ``out[o:o+n] = flat[f:f+n]``; consecutive such rows that abut
        on *both* sides fold into one segment, so a slab read over many
        chunk layers scatters as ONE memcpy.  The fast path engages only
        when EVERY row of the member qualifies and the destinations are
        pairwise disjoint — the folded copies run sorted by destination,
        and reordering is only sound when writes cannot land on the same
        bytes (overlapping same-var chunks must replay in plan-row order,
        exactly like an independent read).  Otherwise the whole member
        falls back to per-row :func:`~repro_torch.io.engine.scatter_row`.
        Returns one ``(flat_lo, out_lo, nbytes, fallback_rows)`` tuple per
        member.
        """
        if self._programs is not None:
            return self._programs
        programs = []
        for plan, span_of in zip(self.members, self.member_span):
            m = plan.num_chunks
            if m == 0:
                z = np.empty(0, dtype=np.int64)
                programs.append((z, z, z, z))
                continue
            isz = plan.dtype.itemsize
            ishape = plan.inter_his - plan.inter_los
            payload = ishape.prod(axis=1) * isz
            src_ok = (plan.chunk_runs == 1) & \
                     (plan.file_hi - plan.file_lo == payload)
            if plan.codecs is not None:
                # compressed extents are stored bytes, not payload bytes:
                # they must go through scatter_row's decode, never the
                # flat-copy fast path (a compressed extent whose stored
                # size happens to equal the payload would satisfy the
                # geometric test above)
                src_ok &= plan.codecs == 0
            rlo = np.asarray(plan.region.lo, dtype=np.int64)
            rhi = np.asarray(plan.region.hi, dtype=np.int64)
            dst_ok = np.ones(m, dtype=bool)
            if plan.region.ndim > 1:
                dst_ok = ((plan.inter_los[:, 1:] == rlo[1:]) &
                          (plan.inter_his[:, 1:] == rhi[1:])).all(axis=1)
            ok = src_ok & dst_ok
            trail = int(np.prod(plan.region.shape[1:], dtype=np.int64)) \
                if plan.region.ndim > 1 else 1
            out_lo = (plan.inter_los[:, 0] - rlo[0]) * trail * isz
            flat_lo = plan.file_lo + \
                (self.span_out[span_of] - self.span_lo[span_of])
            order = np.argsort(out_lo, kind="stable")
            ol, fl, pb = out_lo[order], flat_lo[order], payload[order]
            disjoint = m == 1 or bool((ol[1:] >= ol[:-1] + pb[:-1]).all())
            if ok.all() and disjoint:
                # fold rows that abut in BOTH the flat buffer and the
                # output into one segment (sorted by destination)
                new_seg = np.empty(m, dtype=bool)
                new_seg[0] = True
                new_seg[1:] = (ol[1:] != ol[:-1] + pb[:-1]) | \
                              (fl[1:] != fl[:-1] + pb[:-1])
                starts = np.flatnonzero(new_seg)
                ends = np.concatenate((starts[1:], [m]))
                seg_nb = (ol[ends - 1] + pb[ends - 1]) - ol[starts]
                programs.append((fl[starts], ol[starts], seg_nb,
                                 np.empty(0, dtype=np.int64)))
            else:
                z = np.empty(0, dtype=np.int64)
                programs.append((z, z, z, np.arange(m, dtype=np.int64)))
        self._programs = tuple(programs)
        return self._programs


def build_super_plan(index: DatasetIndex, var: str,
                     regions: Sequence[Block]) -> SuperPlan:
    """Plan one shared gather for ``regions`` of ``var``.

    ONE spatial-index probe (over the bounding box of all regions) serves
    every member plan; the members' per-extent byte needs are merged with
    :func:`union_spans`; each member row is mapped to its covering span
    with a single batched ``searchsorted``.  Pure metadata — no I/O.
    """
    t0 = time.perf_counter()
    blo = tuple(min(int(r.lo[d]) for r in regions)
                for d in range(regions[0].ndim))
    bhi = tuple(max(int(r.hi[d]) for r in regions)
                for d in range(regions[0].ndim))
    candidates = index.spatial_index(var).query(blo, bhi)
    probe_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    members = tuple(build_read_plan(index, var, r, candidates=candidates)
                    for r in regions)
    counts = [p.num_chunks for p in members]
    if sum(counts):
        subf = np.concatenate([p.subfiles for p in members])
        lo = np.concatenate([p.file_lo for p in members])
        hi = np.concatenate([p.file_hi for p in members])
    else:
        subf = lo = hi = np.empty(0, dtype=np.int64)
    u_subf, u_lo, u_hi = union_spans(subf, lo, hi)
    sizes = u_hi - u_lo
    span_out = np.cumsum(sizes) - sizes
    # map every member row to its covering span in ONE batched search:
    # spans are disjoint and sorted in the same packed key space, so the
    # covering span is the last one starting at or before the row
    big = int(hi.max()) + 1 if len(hi) else 1
    u_key = u_subf * big + u_lo
    span_of_all = np.searchsorted(u_key, subf * big + lo, side="right") - 1
    bounds = np.cumsum([0] + counts)
    member_span = tuple(span_of_all[bounds[i]:bounds[i + 1]]
                        for i in range(len(members)))
    return SuperPlan(
        var=var, members=members, member_span=member_span,
        span_subfiles=u_subf, span_lo=u_lo, span_hi=u_hi, span_out=span_out,
        fetch_bytes=int(sizes.sum()),
        payload_bytes=int(sum(p.bytes_needed for p in members)),
        generation=index.generation,
        probe_seconds=probe_seconds,
        plan_seconds=time.perf_counter() - t1)
