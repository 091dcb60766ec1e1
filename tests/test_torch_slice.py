"""The port's slice end to end on the CPU, in the phases ``chip_smoke.py``
runs on the card at full size: a 2-D field output step (six components,
256 x 256 in 32 x 32 blocks over 8 load-balanced processes) written under
``merged_process`` and ``reorganized`` and read back whole and in part.
The field read back equals its source and the JAX package's read of the
same directory, and the directory equals the one the JAX package writes."""

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.io as jio
from repro.core.blocks import Block as JBlock

import repro_torch.core as tc
import repro_torch.kernels as K
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, to_numpy
from repro_torch.io import Dataset

FIELD, BLOCK, NPROCS, PPN = (256, 256), (32, 32), 8, 4
COMPONENTS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
PART = ((32, 96), (160, 224))


@pytest.fixture(scope="module")
def step():
    """Blocks (both packages') and the six components, each block a
    tensor of its own, made from a seeded torch generator."""
    gen = torch.Generator().manual_seed(0)
    tb = tc.simulate_load_balance(tc.uniform_grid_blocks(FIELD, BLOCK),
                                  num_procs=NPROCS, seed=0)
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(FIELD, BLOCK),
                                  num_procs=NPROCS, seed=0)
    assert blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                                for b in jb]) == tb
    fields = {c: torch.randn(FIELD, generator=gen) for c in COMPONENTS}
    data = {c: {b.block_id: fields[c][b.slices()].contiguous() for b in tb}
            for c in COMPONENTS}
    return jb, tb, fields, data


@pytest.mark.parametrize("strategy", ["merged_process", "reorganized"])
def test_slice_round_trip_matches_jax(tmp_path, step, strategy):
    jb, tb, fields, data = step
    layout = tc.plan_layout(strategy, tb, num_procs=NPROCS,
                            procs_per_node=PPN)
    if strategy == "reorganized":
        assert len(layout.chunks) == 64         # the 2-D default, 8 x 8
    K.reset_launch_counts()
    ds = Dataset.create(str(tmp_path / "port"), device="cpu")
    for c in COMPONENTS:
        ws = ds.write_planned(ds.plan_write(c, layout, np.float32), data[c])
        assert ws.kernel_seconds > 0            # the device route ran
    ds.close()

    ds = Dataset.open(str(tmp_path / "port"), device="cpu")
    jd = jio.Dataset.open(str(tmp_path / "port"), telemetry=False)
    for c in COMPONENTS:
        got, st = ds.read(c, Block((0, 0), FIELD))
        assert st.linearize_seconds > 0
        assert torch.equal(got, fields[c])
        want, _ = jd.read(c, JBlock((0, 0), FIELD))
        np.testing.assert_array_equal(to_numpy(got), want)
    got, _ = ds.read("Ez", Block(*PART))
    assert torch.equal(got, fields["Ez"][PART[0][0]:PART[1][0],
                                         PART[0][1]:PART[1][1]])
    ds.close()
    jd.close()
    assert set(K.launch_counts().values()) == {0}

    # the JAX package writes the same directory for the same blocks
    jl = jc.plan_layout(strategy, jb, num_procs=NPROCS, procs_per_node=PPN)
    jd = jio.Dataset.create(str(tmp_path / "jax"), telemetry=False)
    for c in COMPONENTS:
        jd.write(c, jl, np.float32,
                 {k: to_numpy(v) for k, v in data[c].items()})
    jd.close()
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes(), \
            f.name
