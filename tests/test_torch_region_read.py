"""The device region route (``io.device.read_regions``, lowered by
``kernels.ref.region_row_tables``) against the JAX package's host
``read_planned``, on the CPU with ``pack_rows``' plain version: 1-D, 2-D
and 3-D variables, int32 and float64 beside float32 in one dataset,
regions that cut chunks, one-element-wide intersections, several targets
sharing a chunk, each touched extent read once, uncovered and overlapped
layouts, and compressed chunks, which stay on the host route.  Every
comparison is exact."""

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
from repro_torch.io.device import read_regions, read_route
from repro_torch.io.planner import build_read_plan
from repro_torch.kernels.ref import region_row_tables

#: name -> (shape, block, dtype, procs)
VARS = {"a1": ((100,), (5,), np.int32, 4),
        "f2": ((30, 40), (6, 8), np.float64, 5),
        "g3": ((6, 10, 14), (3, 5, 7), np.float32, 3)}
#: name -> target region sets, each read in one call
REGIONS = {
    "a1": [[((0,), (100,))], [((3,), (4,))], [((5,), (60,)), ((55,), (99,))],
           [((i * 25,), ((i + 1) * 25,)) for i in range(4)]],
    "f2": [[((0, 0), (30, 40))], [((3, 5), (29, 31))],
           [((0, 7), (30, 8))],                       # one column: width 1
           [((2, 2), (14, 20)), ((10, 15), (25, 39)), ((0, 0), (1, 1))],
           [((0, 0), (30, 13)), ((0, 13), (30, 27)), ((0, 27), (30, 40))]],
    "g3": [[((0, 0, 0), (6, 10, 14))], [((1, 2, 3), (5, 9, 11))],
           [((0, 0, 4), (6, 10, 5))],                 # width 1
           [((0, 0, 0), (3, 5, 7)), ((2, 4, 6), (6, 10, 14)),
            ((0, 3, 0), (6, 7, 14))]],
}


def _field(shape, dtype, rng):
    if np.dtype(dtype).kind == "i":
        return rng.integers(-1000, 1000, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _write(d, strategy, codec="none", drop=0, twice=False, seed=5):
    """One dataset of every VARS entry through the JAX package; returns the
    fields.  ``drop`` leaves out that many blocks of each variable (the
    layout then does not cover its domain)."""
    rng = np.random.default_rng(seed)
    jd = jio.Dataset.create(d, telemetry=False)
    fields = {}
    for name, (shape, block, dtype, procs) in VARS.items():
        blocks = jc.simulate_load_balance(
            jc.uniform_grid_blocks(shape, block), num_procs=procs,
            seed=seed)[drop:]
        field = _field(shape, dtype, rng)
        scheme = (2,) * len(shape) if strategy == "reorganized" else None
        layout = jc.plan_layout(strategy, blocks, num_procs=procs,
                                global_shape=shape, reorg_scheme=scheme)
        for k in range(2 if twice else 1):
            data = {b.block_id: np.ascontiguousarray(field[b.slices()] + k)
                    for b in blocks}
            jd.write(name, layout, dtype, data, codec=codec)
        fields[name] = field
    jd.close()
    return fields


def _cases():
    return [(name, i) for name in REGIONS for i in range(len(REGIONS[name]))]


@pytest.mark.parametrize("strategy", ["chunked", "merged_process",
                                      "reorganized"])
@pytest.mark.parametrize("name,i", _cases())
def test_region_read_matches_the_host_plan(tmp_path, strategy, name, i):
    _write(str(tmp_path), strategy)
    regions = [Block(lo, hi, block_id=k)
               for k, (lo, hi) in enumerate(REGIONS[name][i])]
    jd = jio.Dataset.open(str(tmp_path), telemetry=False)
    ds = Dataset.open(str(tmp_path), device="cpu")
    K.reset_launch_counts()
    got, stats = read_regions(ds, name, regions, torch.device("cpu"))
    assert set(K.launch_counts().values()) == {0}
    want_bytes = want_chunks = 0
    for r, t in zip(regions, got):
        want, js = jd.read(name, JBlock(r.lo, r.hi))
        assert t.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(t.numpy(), want)
        want_bytes += js.bytes_read
        want_chunks += js.chunks_touched
    assert (stats.bytes_read, stats.chunks_touched) == (want_bytes,
                                                        want_chunks)
    assert stats.linearize_seconds > 0 and stats.engine == "memmap"
    # Dataset.read of one part takes the same route
    got1, st1 = ds.read(name, regions[-1])
    assert torch.equal(got1, got[-1]) and st1.linearize_seconds > 0


def _plans(ds, name, regions):
    return [build_read_plan(ds.index, name, r) for r in regions]


def test_width_one_for_one_element_wide_intersections(tmp_path):
    _write(str(tmp_path), "chunked")
    ds = Dataset.open(str(tmp_path), device="cpu")
    col = [Block((0, 7), (30, 8))]
    assert region_row_tables(_plans(ds, "f2", col))[0] == 1
    slab = [Block((0, 8), (30, 16))]
    assert region_row_tables(_plans(ds, "f2", slab))[0] == 8


def test_each_touched_extent_is_read_once(tmp_path):
    _write(str(tmp_path), "merged_process")
    ds = Dataset.open(str(tmp_path), device="cpu")
    regions = [Block((2, 2), (14, 20)), Block((10, 15), (25, 39)),
               Block((0, 0), (30, 40))]
    plans = _plans(ds, "f2", regions)
    width, src_rows, dst_rows, total, (subf, lo, hi) = \
        region_row_tables(plans)
    touched = set(int(r) for p in plans for r in p.rec_ids)
    assert len(subf) == len(touched)
    assert len(set(zip(subf.tolist(), lo.tolist()))) == len(touched)
    # spans are disjoint, in (subfile, offset) order
    order = np.lexsort((lo, subf))
    assert (order == np.arange(len(order))).all()
    same = subf[1:] == subf[:-1]
    assert (lo[1:][same] >= hi[:-1][same]).all()
    # the whole-domain target needs every extent whole: nothing more is read
    rows = ds.index.var_rows("f2")
    assert int((hi - lo).sum()) == int(rows.nbytes.sum())
    assert total == sum(r.volume for r in regions)
    assert np.unique(dst_rows).size == len(dst_rows) == total // width


def test_uncovered_rows_are_zero_and_overlaps_take_the_host_route(tmp_path):
    fields = _write(str(tmp_path / "gaps"), "chunked", drop=2)
    ds = Dataset.open(str(tmp_path / "gaps"), device="cpu")
    jd = jio.Dataset.open(str(tmp_path / "gaps"), telemetry=False)
    region = Block((0, 0), (30, 40))
    assert read_route(ds.index, "f2", region) == ("region", None)
    got, _ = ds.read("f2", region)
    rows = ds.index.var_rows("f2")
    mask = np.zeros((30, 40), bool)
    for lo, hi in zip(rows.los, rows.his):
        mask[lo[0]:hi[0], lo[1]:hi[1]] = True
    assert not mask.all()
    want, _ = jd.read("f2", JBlock(region.lo, region.hi))
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])
    np.testing.assert_array_equal(got.numpy()[mask], fields["f2"][mask])
    assert (got.numpy()[~mask] == 0).all()

    _write(str(tmp_path / "twice"), "chunked", twice=True)
    ds = Dataset.open(str(tmp_path / "twice"), device="cpu")
    jd = jio.Dataset.open(str(tmp_path / "twice"), telemetry=False)
    part = Block((3, 5), (29, 31))
    assert read_regions(ds, "f2", [part], torch.device("cpu")) is None
    got, st = ds.read("f2", part)
    want, _ = jd.read("f2", JBlock(part.lo, part.hi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert st.linearize_seconds == 0.0


def test_compressed_chunks_stay_on_the_host_route(tmp_path):
    fields = _write(str(tmp_path), "merged_process", codec="zlib")
    ds = Dataset.open(str(tmp_path), device="cpu")
    for name, sets in REGIONS.items():
        r = Block(*sets[1][0])
        assert read_route(ds.index, name, r) is None
        got, st = ds.read(name, r)
        assert st.linearize_seconds == 0.0
        np.testing.assert_array_equal(got.numpy(), fields[name][r.slices()])
        with pytest.raises(ValueError, match="compressed"):
            region_row_tables(_plans(ds, name, [r]))


def test_port_written_dataset_reads_through_the_route(tmp_path):
    """A dataset the port writes from tensors reads back by region."""
    shape, block, dtype, procs = VARS["g3"]
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(shape, block),
                                  num_procs=procs, seed=1)
    tb = blocks_from_records([(b.lo, b.hi, b.owner, b.block_id) for b in jb])
    field = _field(shape, dtype, np.random.default_rng(1))
    data = {b.block_id: np.ascontiguousarray(field[b.slices()]) for b in tb}
    ds = Dataset.create(str(tmp_path), device="cpu")
    ds.write("g3", tc.plan_layout("merged_process", tb, num_procs=procs),
             dtype, tensors_from_numpy(data, "cpu"))
    regions = [Block(lo, hi) for lo, hi in REGIONS["g3"][3]]
    got, _ = read_regions(ds, "g3", regions, torch.device("cpu"))
    for r, t in zip(regions, got):
        np.testing.assert_array_equal(t.numpy(), field[r.slices()])
