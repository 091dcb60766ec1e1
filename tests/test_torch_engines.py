"""The kernel-bypass engines of the port (``repro_torch.io.engine``'s
``UringEngine`` and ``ODirectEngine``, ``io/uring.py``, ``io/direct.py``)
against the JAX package's, on the CPU: every engine writes the same plans
as the reference's engine on the same data (the port's from tensors,
through its device route) with subfiles and ``index.json`` byte-equal, and
reads the reference's values back — aligned and ragged extents, groups
larger than a fixed slot, O_DIRECT's buffered edges; the copied modules
give the reference's answers; ``engine="auto"`` with an injected kernel
calibration chooses what the reference chooses.  Every comparison is
exact."""

import dataclasses
import os

import numpy as np
import pytest

import repro.core.cost_model as jcm
import repro.io.direct as jdirect
import repro.io.engine as jeng
import repro.io.uring as juring
from repro.core import plan_layout as jplan_layout
from repro.core import simulate_load_balance, uniform_grid_blocks
from repro.core.blocks import Block as JBlock
from repro.io import Dataset as JDataset

import repro_torch.core.cost_model as tcm
import repro_torch.io.direct as tdirect
import repro_torch.io.engine as teng
import repro_torch.io.uring as turing
from repro_torch.core import plan_layout as tplan_layout
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.io import Dataset

#: blocks of 5,120 bytes: no extent is a multiple of the 4 KiB O_DIRECT
#: alignment unless the plan pads it (``align=4096``)
SHAPE, BOX, PROCS = (24, 32, 20), (8, 16, 10), 4
#: (spec, constructor kwargs): the default ring (groups fit its 256 KiB
#: fixed slots), a shallow one, slots of one page (groups larger than a
#: slot take plain SQEs on their own buffers), direct reads, O_DIRECT
ENGINES = {"uring": ("uring", {}), "uring:4": ("uring:4", {}),
           "uring_small_slots": ("uring", {"buf_bytes": 4096}),
           "uring_direct": ("uring", {"direct": True}),
           "odirect": ("odirect", {})}
REGIONS = [((0, 0, 0), SHAPE), ((3, 5, 1), (21, 30, 17)),
           ((7, 0, 9), (8, 32, 10)), ((0, 16, 0), (24, 17, 20))]
COLD = dict(seek_latency_s=1e-3, preadv_group_overhead_s=5e-6,
            seq_read_bps=2e9, seq_write_bps=1e9, memmap_bps=8e9,
            page_miss_s=1e-3, parallel_scaling=8.0, created_at=0.0)
#: COLD as a probe sees it on a kernel with io_uring and O_DIRECT
COLD_KERNEL = dict(COLD, uring_sqe_s=5e-6, uring_reg_s=2e-4,
                   odirect_seq_read_bps=2e9, odirect_seq_write_bps=1e9,
                   odirect_align_s=1e-5)


@pytest.fixture(scope="module")
def world():
    blocks = simulate_load_balance(uniform_grid_blocks(SHAPE, BOX),
                                   num_procs=PROCS, seed=5)
    rng = np.random.default_rng(5)
    field = rng.standard_normal(SHAPE).astype(np.float32)
    data = {b.block_id: np.ascontiguousarray(field[b.slices()])
            for b in blocks}
    return blocks, data, field


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.startswith("data_") or f == "index.json"}


def _engines(name):
    spec, kw = ENGINES[name]
    return jeng.get_engine(spec, **kw), teng.get_engine(spec, **kw)


# -- writes and reads against the reference -----------------------------------

@pytest.mark.parametrize("align", [None, 4096], ids=["ragged", "aligned"])
@pytest.mark.parametrize("strategy", ["merged_process", "subfiled_fpp"])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_writes_and_reads_as_the_reference(tmp_path, world, name,
                                                  strategy, align):
    """The same plan written by each package's engine: byte-equal subfiles
    and ``index.json`` (the port's chunks assembled from tensors on its
    device route); then every region read back through the engine, both
    packages' arrays equal to the source, and the port's ``Dataset.read``
    (its device routes) too."""
    blocks, data, field = world
    jinst, tinst = _engines(name)
    assert type(tinst).__name__ == type(jinst).__name__
    assert (tinst.name, getattr(tinst, "depth", None)) == \
        (jinst.name, getattr(jinst, "depth", None))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jds = JDataset.create(jd, engine=jinst, telemetry=False)
    tds = Dataset.create(td, engine=tinst, device="cpu")
    jl = jplan_layout(strategy, blocks, num_procs=PROCS, procs_per_node=2,
                      global_shape=SHAPE)
    tl = tplan_layout(strategy, blocks_from_records(
        [(b.lo, b.hi, b.owner, b.block_id) for b in blocks]),
        num_procs=PROCS, procs_per_node=2, global_shape=SHAPE)
    jws = jds.write("E", jl, np.float32, data, align=align)
    tws = tds.write("E", tl, np.float32, tensors_from_numpy(data, "cpu"),
                    align=align)
    assert (tws.engine, tws.engine_reason, tws.groups) == \
        (jws.engine, jws.engine_reason, jws.groups)
    assert _files(jd) == _files(td)
    if align is None:
        # ragged extents: O_DIRECT writes their edges buffered
        assert any(r.offset % 4096 or r.nbytes % 4096
                   for r in tds.index.chunks)
    for lo, hi in REGIONS:
        want = field[tuple(slice(a, b) for a, b in zip(lo, hi))]
        jarr, jst = jds.read_planned(jds.plan_read("E", JBlock(lo, hi)))
        tarr, tst = tds.read_planned(tds.plan_read("E", Block(lo, hi)))
        np.testing.assert_array_equal(jarr, want)
        np.testing.assert_array_equal(tarr, want)
        assert (tst.engine, tst.engine_reason, tst.groups, tst.bytes_read) \
            == (jst.engine, jst.engine_reason, jst.groups, jst.bytes_read)
        got, st = tds.read("E", Block(lo, hi))
        assert np.array_equal(got.numpy(), want)
        assert st.engine == tinst.name
    for s in (jds, tds):
        s.close()


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_takes_the_reference_path_through_the_ring(tmp_path, world,
                                                          name):
    """The port's ring is the reference's: the same groups go through
    fixed slots (or plain SQEs when larger than a slot), and the pool is
    registered exactly when the reference's is."""
    blocks, data, field = world
    jinst, tinst = _engines(name)
    if name == "odirect":
        assert (tinst.align, type(tinst).__mro__[1].__name__) == \
            (jinst.align, "PreadEngine")
        return
    d = str(tmp_path / "d")
    jds = JDataset.create(d, engine="pread", telemetry=False)
    jds.write("E", jplan_layout("merged_process", blocks, num_procs=PROCS,
                                global_shape=SHAPE), np.float32, data)
    plan = jds.plan_read("E", JBlock((0, 0, 0), SHAPE))
    jds.close()
    tds = Dataset.open(d, device="cpu")
    tplan = tds.plan_read("E", Block((0, 0, 0), SHAPE))
    big = [int(plan.file_hi[int(plan.group_bounds[g + 1]) - 1]
               - plan.file_lo[int(plan.group_bounds[g])])
           for g in range(plan.num_groups)]
    if name == "uring_small_slots":
        assert max(big) > tinst.buf_bytes == jinst.buf_bytes == 4096
    out = np.empty(SHAPE, np.float32)
    tinst.read_plan(tplan, tds._store, out)
    np.testing.assert_array_equal(out, field)
    if juring.uring_available()[0]:
        jout = np.empty(SHAPE, np.float32)
        jinst.read_plan(plan, jeng.SubfileStore(d), jout)
        assert tinst._ring is not None and jinst._ring is not None
        assert tinst._fixed == jinst._fixed
        assert (tinst.depth, tinst.buf_bytes, tinst.direct) == \
            (jinst.depth, jinst.buf_bytes, jinst.direct)
    tds.close()


def test_odirect_edges_never_touch_a_neighbours_bytes(tmp_path):
    """Two disjoint ragged extents, each with an aligned middle written
    direct, written by two O_DIRECT writers unaware of each other and
    sharing one page: both survive, as the reference's do (the edges go
    buffered, no read-modify-write of the shared page)."""
    from repro_torch.io.planner import WritePlan
    outs = {}
    for pkg, mod in (("jax", jeng), ("port", teng)):
        d = tmp_path / pkg
        d.mkdir()
        store = mod.SubfileStore(str(d))
        store.ensure_size(0, 5 * 4096)
        for lo, hi, byte in ((100, 2 * 4096 + 700, 0x11),
                             (2 * 4096 + 700, 5 * 4096 - 5, 0x22)):
            buf = np.full(hi - lo, byte, np.uint8)
            plan = WritePlan(
                var="v", layout=None, dtype=np.dtype(np.uint8),
                chunk_ids=np.zeros(1, np.int64),
                chunk_los=np.zeros((1, 1), np.int64),
                chunk_his=np.full((1, 1), hi - lo, np.int64),
                writers=np.zeros(1, np.int64), subfiles=np.zeros(1, np.int64),
                file_lo=np.array([lo]), file_hi=np.array([hi]),
                nbytes=np.array([hi - lo]), group_bounds=np.array([0, 1]),
                file_sizes={0: 5 * 4096}, align=None, bytes_total=hi - lo,
                span_bytes=hi - lo)
            mod.get_engine("odirect").write_plan(plan, [buf], store)
        store.close()
        outs[pkg] = (d / "data_0.bin").read_bytes()
    assert outs["jax"] == outs["port"]
    raw = np.frombuffer(outs["port"], np.uint8)
    assert (raw[100:2 * 4096 + 700] == 0x11).all()
    assert (raw[2 * 4096 + 700:5 * 4096 - 5] == 0x22).all()
    assert (raw[:100] == 0).all() and (raw[-5:] == 0).all()


# -- the copied modules -------------------------------------------------------

def test_direct_and_uring_copies_give_the_reference_answers(tmp_path):
    assert tdirect.DIRECT_ALIGN == jdirect.DIRECT_ALIGN
    assert tdirect.__all__ == jdirect.__all__
    assert turing.__all__ == juring.__all__
    for name in ("OP_READ", "OP_WRITE", "OP_READ_FIXED", "OP_WRITE_FIXED",
                 "_SQE_FMT", "_CQE_FMT", "_NR_SETUP", "_NR_ENTER",
                 "_NR_REGISTER"):
        assert getattr(turing, name) == getattr(juring, name), name
    for n in (1, 4096, 5000):
        buf = tdirect.aligned_empty(n)
        assert buf.nbytes == n and buf.ctypes.data % 4096 == 0
    assert tdirect.odirect_available(str(tmp_path)) == \
        jdirect.odirect_available(str(tmp_path))
    assert turing.uring_available() == juring.uring_available()
    missing = str(tmp_path / "missing")
    assert tdirect.odirect_available(missing)[0] is False
    assert jdirect.odirect_available(missing)[0] is False
    # a direct round trip through each package's helpers, read by the other
    if tdirect.odirect_available(str(tmp_path))[0]:
        path = str(tmp_path / "f")
        payload = tdirect.aligned_empty(2 * 4096)
        payload[:] = np.arange(payload.size) % 251
        fd = tdirect.open_direct(path, writable=True)
        tdirect.pwrite_direct(fd, payload, 0)
        os.close(fd)
        back = jdirect.aligned_empty(3 * 4096)
        fd = jdirect.open_direct(path)
        assert jdirect.pread_into_direct(fd, back, 0) == 2 * 4096
        os.close(fd)
        assert np.array_equal(back[:2 * 4096], payload)
    if turing.uring_available()[0]:
        path = tmp_path / "g"
        path.write_bytes(bytes(range(256)) * 64)
        fd = os.open(path, os.O_RDONLY)
        try:
            ring = turing.IoUring(entries=4)
            buf = np.zeros(4096, np.uint8)
            ring.prep(turing.OP_READ, fd, buf.ctypes.data, 4096, 4096,
                      user_data=3)
            assert ring.submit(1, wait_for=1) == 1
            assert ring.reap() == [(3, 4096)]
            ring.close()
        finally:
            os.close(fd)
        assert bytes(buf) == path.read_bytes()[4096:8192]


def test_odirect_probe_on_shared_memory_agrees():
    """``/dev/shm`` is tmpfs, which refuses ``O_DIRECT`` on older kernels
    and accepts it on newer ones: the two probes must agree either way."""
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm on this host")
    assert tdirect.odirect_available("/dev/shm") == \
        jdirect.odirect_available("/dev/shm")


# -- engine="auto" with kernel terms ------------------------------------------

@pytest.mark.parametrize("shape", [
    dict(groups=44, runs=4096, bytes_moved=64 << 20, span_bytes=64 << 20),
    dict(groups=1, runs=1, bytes_moved=1 << 20, span_bytes=1 << 20),
    dict(groups=512, runs=512, bytes_moved=512 * 4096,
         span_bytes=512 * 4096),
    dict(groups=2, runs=2, bytes_moved=256 << 20, span_bytes=256 << 20)],
    ids=["many_groups", "one_group", "ragged", "sequential"])
def test_kernel_terms_price_and_choose_as_the_reference(shape):
    """The reference's cold-kernel cases (a many-group plan flips to
    ``uring``; one group never overlaps; ragged groups pay the aligned
    window; a long sweep keeps ``odirect`` competitive): the same
    predictions and choices in both directions."""
    for extra in ({}, {"odirect_align_s": 5e-4, "odirect_seq_read_bps": 4e9}):
        jc = jcm.EngineCalibration(**dict(COLD_KERNEL, **extra))
        tc = tcm.EngineCalibration(**dict(COLD_KERNEL, **extra))
        for direction in ("read", "write"):
            for spec in ("pread", "overlapped:8", "uring:16", "odirect"):
                assert tcm.predict_seconds(tc, spec, direction=direction,
                                           **shape) == \
                    jcm.predict_seconds(jc, spec, direction=direction,
                                        **shape)
            j = jcm.choose_engine(jc, direction=direction, **shape)
            t = tcm.choose_engine(tc, direction=direction, **shape)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_auto_session_chooses_uring_as_the_reference(tmp_path, world):
    """A cold kernel-capable calibration injected into both sessions: a
    many-group ``engine="auto"`` read runs on the real uring engine in
    both, with the same decision record, and the data stay right; the
    port's device route resolves auto on the span plan it executes."""
    blocks, data, field = world
    d = str(tmp_path / "d")
    jds = JDataset.create(d, engine="pread", telemetry=False)
    jds.write("E", jplan_layout("subfiled_fpp", blocks, num_procs=PROCS,
                                global_shape=SHAPE), np.float32, data)
    jds.close()
    jk = JDataset.open(d, engine="auto", telemetry=False,
                       calibration=jcm.EngineCalibration(**COLD_KERNEL))
    tk = Dataset.open(d, engine="auto", device="cpu",
                      calibration=tcm.EngineCalibration(**COLD_KERNEL))
    jplan = jk.plan_read("E", JBlock((0, 0, 0), SHAPE))
    assert jplan.num_groups > 1
    jarr, jst = jk.read_planned(jplan)
    tarr, tst = tk.read_planned(tk.plan_read("E", Block((0, 0, 0), SHAPE)))
    np.testing.assert_array_equal(tarr, field)
    np.testing.assert_array_equal(jarr, field)
    assert jst.engine.startswith("uring")
    assert (tst.engine, tst.engine_reason, tst.predicted_seconds) == \
        (jst.engine, jst.engine_reason, jst.predicted_seconds)
    got, rst = tk.read("E", Block((0, 0, 0), SHAPE))
    assert np.array_equal(got.numpy(), field)
    assert "predicted" in rst.engine_reason
    jk.close()
    tk.close()


def test_probe_fills_the_kernel_terms_as_feature_detection_says(tmp_path):
    """The port's probe measures the kernel-bypass terms exactly where its
    probes say the host supports them, as the reference's does, and
    leaves no scratch file behind."""
    d = str(tmp_path)
    cal = tcm.probe_storage(d, probe_bytes=1 << 20)
    assert cal.version == tcm.CALIBRATION_VERSION
    assert (cal.uring_sqe_s >= 0) == turing.uring_available()[0] \
        == (jcm.probe_storage(d, probe_bytes=1 << 20).uring_sqe_s >= 0)
    assert (cal.uring_reg_s >= 0) == turing.uring_available()[0]
    direct = tdirect.odirect_available(d)[0]
    assert (cal.odirect_seq_read_bps > 0) == direct
    assert (cal.odirect_seq_write_bps > 0) == direct
    assert cal.odirect_align_s >= 0
    assert os.listdir(d) == []
