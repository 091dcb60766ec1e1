"""Datasets cross between the packages: a directory the port writes (from
tensors, through its device routes with the plain kernels on the CPU)
opens and reads bit-exactly under the JAX package, the reverse holds, and
both packages write the same ``index.json`` for the same blocks and data
— for every engine and every layout strategy."""

import json

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.io as jio
from repro.core.blocks import Block as JBlock

import repro_torch.core as tc
import repro_torch.kernels as K
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.io import Dataset

ENGINES = ("memmap", "pread", "overlapped")
SHAPE, BLOCK, NPROCS, PPN = (128, 128), (16, 32), 6, 2
SUB = ((5, 17), (100, 90))


def _world(shape, block, procs, seed=3):
    rng = np.random.default_rng(seed)
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(shape, block),
                                  num_procs=procs, seed=seed)
    field = rng.standard_normal(shape).astype(np.float32)
    data = {b.block_id: np.ascontiguousarray(field[b.slices()]) for b in jb}
    tb = blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                              for b in jb])
    return jb, tb, field, data


@pytest.fixture(scope="module")
def world():
    return _world(SHAPE, BLOCK, NPROCS)


def _layouts(strategy, jb, tb, **kw):
    kw = dict(num_procs=NPROCS, procs_per_node=PPN, num_stagers=3, **kw)
    return (jc.plan_layout(strategy, jb, **kw),
            tc.plan_layout(strategy, tb, **kw))


def _index(d):
    with open(f"{d}/index.json") as f:
        return json.load(f)


def _table(d):
    return [(c["var"], c["lo"], c["hi"], c["subfile"], c["offset"],
             c["nbytes"], c.get("crc"), c.get("codec")) for c in
            _index(d)["chunks"]]


@pytest.mark.parametrize("strategy", tc.STRATEGIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_port_writes_jax_reads(tmp_path, world, engine, strategy):
    jb, tb, field, data = world
    _, tl = _layouts(strategy, jb, tb)
    ds = Dataset.create(str(tmp_path), engine=engine, device="cpu")
    ds.write("E", tl, np.float32, tensors_from_numpy(data, "cpu"))
    ds.close()
    jd = jio.Dataset.open(str(tmp_path), engine=engine, telemetry=False)
    got, _ = jd.read("E", JBlock((0, 0), SHAPE))
    np.testing.assert_array_equal(got, field)
    got, _ = jd.read("E", JBlock(*SUB))
    np.testing.assert_array_equal(got, field[SUB[0][0]:SUB[1][0],
                                             SUB[0][1]:SUB[1][1]])
    assert jd.verify_checksums() == (len(tl.chunks), [])
    jd.close()


@pytest.mark.parametrize("strategy", tc.STRATEGIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_jax_writes_port_reads(tmp_path, world, engine, strategy):
    jb, tb, field, data = world
    jl, _ = _layouts(strategy, jb, tb)
    jd = jio.Dataset.create(str(tmp_path), engine=engine, telemetry=False)
    jd.write("E", jl, np.float32, data)
    jd.close()
    ds = Dataset.open(str(tmp_path), engine=engine, device="cpu")
    got, st = ds.read("E", Block((0, 0), SHAPE))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), field)
    assert st.bytes_read == field.nbytes
    got, _ = ds.read("E", Block(*SUB))
    np.testing.assert_array_equal(got.numpy(), field[SUB[0][0]:SUB[1][0],
                                                     SUB[0][1]:SUB[1][1]])
    ds.close()


@pytest.mark.parametrize("align", [None, 4096])
@pytest.mark.parametrize("strategy", tc.STRATEGIES)
def test_index_json_equal(tmp_path, world, strategy, align):
    jb, tb, field, data = world
    jl, tl = _layouts(strategy, jb, tb)
    jd = jio.Dataset.create(str(tmp_path / "jax"), telemetry=False)
    jd.write("E", jl, np.float32, data, align=align)
    jd.write("B", jl, np.float32, {k: -v for k, v in data.items()},
             align=align)
    jd.close()
    ds = Dataset.create(str(tmp_path / "port"), device="cpu")
    ds.write("E", tl, np.float32, tensors_from_numpy(data, "cpu"),
             align=align)
    ds.write("B", tl, np.float32,
             {k: -v for k, v in tensors_from_numpy(data, "cpu").items()},
             align=align)
    ds.close()
    assert _table(tmp_path / "port") == _table(tmp_path / "jax")
    assert _index(tmp_path / "port") == _index(tmp_path / "jax")
    for name in ("data_0.bin",):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compressed_chunks_cross(tmp_path, world, writer):
    """zlib chunks (index v4) take the host route on read, both ways."""
    jb, tb, field, data = world
    jl, tl = _layouts("merged_process", jb, tb)
    if writer == "jax":
        jd = jio.Dataset.create(str(tmp_path), telemetry=False)
        jd.write("E", jl, np.float32, data, codec="zlib")
        jd.close()
    else:
        ds = Dataset.create(str(tmp_path), device="cpu")
        ds.write("E", tl, np.float32, tensors_from_numpy(data, "cpu"),
                 codec="zlib")
        ds.close()
    got, _ = Dataset.open(str(tmp_path), device="cpu").read(
        "E", Block((0, 0), SHAPE))
    np.testing.assert_array_equal(got.numpy(), field)
    got, _ = jio.Dataset.open(str(tmp_path), telemetry=False).read(
        "E", JBlock((0, 0), SHAPE))
    np.testing.assert_array_equal(got, field)
    assert all(c["codec"] == "zlib" for c in _index(tmp_path)["chunks"])


@pytest.mark.parametrize("case", ["uneven_grid", "three_d", "appended"])
def test_host_routes_and_nd_match_jax(tmp_path, case):
    """Layouts the device routes do not take (an uneven reorganized grid,
    a variable written twice) and a 3-D variable: bytes, index and reads
    still equal the JAX package's."""
    if case == "three_d":
        shape, block = (32, 32, 32), (8, 8, 16)
    else:
        shape, block = SHAPE, BLOCK
    jb, tb, field, data = _world(shape, block, NPROCS, seed=7)
    strategy = "merged_process" if case == "three_d" else "reorganized"
    kw = dict(num_procs=NPROCS, reorg_scheme=(3, 5)) \
        if case == "uneven_grid" else dict(num_procs=NPROCS)
    jl = jc.plan_layout(strategy, jb, **kw)
    tl = tc.plan_layout(strategy, tb, **kw)
    jd = jio.Dataset.create(str(tmp_path / "jax"), telemetry=False)
    ds = Dataset.create(str(tmp_path / "port"), device="cpu")
    tdata = tensors_from_numpy(data, "cpu")
    for _ in range(2 if case == "appended" else 1):
        jd.write("E", jl, np.float32, data)
        ds.write("E", tl, np.float32, tdata)
        data = {k: v + 1 for k, v in data.items()}
        tdata = {k: v + 1 for k, v in tdata.items()}
    jd.close()
    ds.close()
    assert _index(tmp_path / "port") == _index(tmp_path / "jax")
    whole = tuple(((0,) * len(shape), shape))
    want, _ = jio.Dataset.open(str(tmp_path / "jax"),
                               telemetry=False).read("E", JBlock(*whole))
    got, _ = Dataset.open(str(tmp_path / "jax"), device="cpu").read(
        "E", Block(*whole))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, field + (case == "appended"))


def test_device_routes_on_cpu_tensors(tmp_path, world):
    """The port's write, whole read and partial read go through the
    kernels' plain versions for CPU tensors and record their stages (the
    partial read on the region route, with the host plan's bytes and
    chunks); nothing launches."""
    jb, tb, field, data = world
    K.reset_launch_counts()
    for strategy in ("merged_process", "reorganized", "chunked"):
        _, tl = _layouts(strategy, jb, tb)
        d = str(tmp_path / strategy)
        ds = Dataset.create(d, device="cpu")
        ws = ds.write("E", tl, np.float32, tensors_from_numpy(data, "cpu"))
        assert ws.kernel_seconds > 0 and ws.d2h_seconds > 0
        got, rs = ds.read("E", Block((0, 0), SHAPE))
        assert rs.linearize_seconds > 0 and rs.bytes_read == field.nbytes
        assert torch.equal(got, torch.from_numpy(field))
        got, rs = ds.read("E", Block(*SUB))
        plan = ds.plan_read("E", Block(*SUB))
        assert rs.linearize_seconds > 0 and rs.h2d_seconds > 0
        assert (rs.bytes_read, rs.chunks_touched) == (plan.bytes_needed,
                                                      plan.num_chunks)
        assert torch.equal(got, torch.from_numpy(field[Block(*SUB).slices()]))
        ds.close()
    assert set(K.launch_counts().values()) == {0}


def test_mixed_devices_and_wrong_dtypes_refused(tmp_path, world):
    jb, tb, field, data = world
    _, tl = _layouts("merged_process", jb, tb)
    ds = Dataset.create(str(tmp_path), device="cpu")
    bad = tensors_from_numpy(data, "cpu")
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="block 0"):
        ds.write("E", tl, np.float32, bad)
    bad[0] = bad[0].float()[:1]
    with pytest.raises(ValueError, match="block 0"):
        ds.write("E", tl, np.float32, bad)
