"""Intra-node aggregation (paper §2.3 / §4.3), with the blocks on the card.

On Summit this is an MPI gather of all blocks owned by a node's processes
to one leader process (~0.25 s for a 256 GB variable at 6 ranks/node).
Here every block is a tensor: a leader's block passes through as it is,
and every other block is copied into a leader-owned tensor on the same
device (the gather transfer); the seconds end once the copies finished.
"""

from __future__ import annotations

import time
from typing import Mapping, Sequence

import torch

from ..core.blocks import Block
from ..core.layouts import node_of

__all__ = ["gather_to_nodes"]


def gather_to_nodes(blocks: Sequence[Block],
                    data: Mapping[int, torch.Tensor],
                    procs_per_node: int) -> tuple:
    """Relocate each block's data to its node leader.

    Returns (node_blocks, node_data, gather_seconds) where ``node_blocks``
    re-owns each block by node id and ``node_data`` holds leader-side copies
    (leader-local blocks are passed through without copy, like a same-rank
    MPI gather contribution).  The seconds end in a synchronize of every
    card the copies ran on.
    """
    t0 = time.perf_counter()
    node_blocks = []
    node_data = {}
    cards = set()
    for b in blocks:
        node = node_of(b.owner, procs_per_node)
        node_blocks.append(b.with_owner(node))
        t = data[b.block_id]
        if b.owner % procs_per_node == 0:
            node_data[b.block_id] = t
        else:
            node_data[b.block_id] = t.clone()         # the gather transfer
            if t.device.type == "cuda":
                cards.add(t.device)
    for dev in cards:
        torch.cuda.synchronize(dev)
    return node_blocks, node_data, time.perf_counter() - t0
