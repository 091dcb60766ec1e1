"""Execute merge plans with the ``pack_rows`` kernel.

``merge_blocks_device`` is the device path of the paper's §4 merge: block
data already on the card in log order (the chunked layout), output merged
cuboid buffers — one ``pack_rows`` launch.  The tensors' device decides
where it runs: CUDA tensors go through the kernel, CPU tensors through its
plain version.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..core.merge import MergePlan
from .pack_blocks import _pack_host_tables
from .ref import plan_row_tables

__all__ = ["merge_blocks_device", "split_merged", "pack_tables"]


def pack_tables(flat_src: torch.Tensor, tables: tuple, *,
                _covered: bool = False) -> torch.Tensor:
    """Run the row tables of :func:`~repro_torch.kernels.ref.
    plan_row_tables` over ``flat_src`` (the blocks concatenated in the
    tables' source order) in one ``pack_rows`` launch; returns the
    destination buffers concatenated flat.  The tables are checked on the
    host, where they are made.  ``_covered``: the caller has shown
    (``io.device._lower``) that they name every destination row exactly
    once, so the output is not zero-filled first."""
    width, src_rows, dst_rows, total_dst, _ = tables
    return _pack_host_tables(flat_src, src_rows, dst_rows,
                             n_dst_rows=total_dst // width, width=width,
                             covered=_covered).reshape(-1)


def merge_blocks_device(plan: MergePlan,
                        data: Mapping[int, torch.Tensor]) -> list:
    """Execute ``plan`` on the tensors' device.  ``data``: block_id ->
    tensor (block shape).  Returns the merged buffers (cluster order)."""
    tables = plan_row_tables(plan)
    src_off = tables[4]
    flat_src = torch.cat([data[bid].reshape(-1)
                          for bid in sorted(src_off, key=src_off.get)])
    return split_merged(plan, pack_tables(flat_src, tables))


def split_merged(plan: MergePlan, flat_dst: torch.Tensor) -> list:
    out = []
    pos = 0
    for cl in plan.clusters:
        v = cl.cuboid.volume
        out.append(flat_dst[pos:pos + v].reshape(cl.cuboid.shape))
        pos += v
    return out
