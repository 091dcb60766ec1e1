"""The port's intra-node aggregation against the JAX package's, on the
CPU: the same blocks and data through both give the same re-owned blocks
and the same bytes; a leader's block passes through as the same tensor,
every other block is a copy on its own device."""

import numpy as np
import pytest
import torch

import repro.core as jc
from repro.io import gather_to_nodes as jgather

from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.io import gather_to_nodes


@pytest.mark.parametrize("procs,ppn", [(6, 2), (8, 4), (5, 1), (3, 3)])
def test_gather_to_nodes_matches_the_reference(procs, ppn):
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks((64, 48), (16, 16)),
                                  num_procs=procs, seed=procs)
    rng = np.random.default_rng(procs)
    data = {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
            for b in jb}
    tb = blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                              for b in jb])
    tdata = tensors_from_numpy(data, "cpu")
    jblocks, jdata, _ = jgather(jb, data, ppn)
    blocks, out, seconds = gather_to_nodes(tb, tdata, ppn)
    assert seconds >= 0.0
    assert [(b.lo, b.hi, b.owner, b.block_id) for b in blocks] == \
        [(b.lo, b.hi, b.owner, b.block_id) for b in jblocks]
    assert sorted(out) == sorted(jdata)
    for b in tb:
        t = out[b.block_id]
        np.testing.assert_array_equal(t.numpy(), jdata[b.block_id])
        leader = b.owner % ppn == 0
        assert (t is tdata[b.block_id]) == leader
        assert leader or t.data_ptr() != tdata[b.block_id].data_ptr()
        assert t.device == tdata[b.block_id].device


def test_gather_to_nodes_copies_bf16_views():
    """A non-leader block that is a strided view of a larger tensor comes
    back as a copy of its own bytes, in its dtype."""
    x = torch.randn(8, 8).to(torch.bfloat16)
    b = blocks_from_records([((0, 0), (8, 4), 1, 0), ((0, 4), (8, 8), 0, 1)])
    data = {0: x[:, :4], 1: x[:, 4:]}
    _, out, _ = gather_to_nodes(b, data, 2)
    assert out[1] is data[1]
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], x[:, :4])
    assert out[0].untyped_storage().data_ptr() != \
        x.untyped_storage().data_ptr()
