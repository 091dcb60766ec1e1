"""The port's journal layer (``repro_torch.io.journal``), worker loop and
fault-tolerance primitives against the JAX package's, single-process and
on the CPU: the serialized write plan and unit partition equal, the lease
protocol driven through the same operations under one injected clock
leaving equal journals, ``validate_journal`` flagging the same units,
``with_retry``'s backoff, and ``fault_tolerance``'s outputs equal.  The
multi-process kill matrix is in ``test_torch_kill_matrix*.py``."""

import json
import os

import numpy as np
import pytest

import repro.core as jc
import repro.distributed.fault_tolerance as jft
import repro.distributed.reorg as jreorg
import repro.io as jio
import repro.io.journal as jjournal
from repro.io.format import subfile_name

import repro_torch.distributed as tdist
import repro_torch.distributed.fault_tolerance as tft
import repro_torch.distributed.reorg as treorg
import repro_torch.io.journal as tjournal
from repro_torch.core import plan_layout as tplan_layout
from repro_torch.interop import blocks_from_records
from repro_torch.io import build_write_plan as tbuild_write_plan
from repro_torch.io import subset_write_plan as tsubset_write_plan

GLOBAL = (16, 16, 16)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def world():
    blocks = jc.simulate_load_balance(
        jc.uniform_grid_blocks(GLOBAL, (8, 8, 8)), num_procs=2, seed=11)
    rng = np.random.default_rng(11)
    data = {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
            for b in blocks}
    return blocks, data


def _plans(blocks, strategy="chunked", align=4096):
    """The same destination plan from each package (``align=4096`` pads
    between extents, so nothing coalesces: one group a chunk)."""
    jl = jc.plan_layout(strategy, blocks, num_procs=2, global_shape=GLOBAL)
    tl = tplan_layout(strategy, blocks_from_records(
        [(b.lo, b.hi, b.owner, b.block_id) for b in blocks]), num_procs=2,
        global_shape=GLOBAL)
    return (jio.build_write_plan(jl, "B", np.float32, align=align),
            tbuild_write_plan(tl, "B", np.float32, align=align))


def _src(tmp_path, blocks, data):
    src = str(tmp_path / "src")
    ds = jio.Dataset.create(src)
    ds.write("B", jc.plan_layout("subfiled_fpp", blocks, num_procs=2,
                                 global_shape=GLOBAL), np.float32, data)
    ds.close()
    return src


def _journals(tmp_path, blocks, data, clock, num_units=3,
              lease_timeout_s=10.0):
    src = _src(tmp_path, blocks, data)
    jp, tp = _plans(blocks)
    jd, td = str(tmp_path / "jdst"), str(tmp_path / "tdst")
    j = jjournal.ReorgJournal.create(jd, jp, src, num_units=num_units,
                                     lease_timeout_s=lease_timeout_s,
                                     clock=clock)
    t = tjournal.ReorgJournal.create(td, tp, src, num_units=num_units,
                                     lease_timeout_s=lease_timeout_s,
                                     clock=clock)
    return j, t, jp, tp, src


def _same_file_bytes(a, b):
    names = sorted(f for f in os.listdir(a) if f.startswith("data_"))
    assert names == sorted(f for f in os.listdir(b) if f.startswith("data_"))
    for f in names:
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


# -- the write plan and its units ---------------------------------------------

@pytest.mark.parametrize("strategy,align", [("chunked", 4096),
                                            ("merged_process", None),
                                            ("reorganized", None)])
def test_plan_serialization_matches_the_reference(world, strategy, align):
    blocks, _ = world
    jp, tp = _plans(blocks, strategy, align)
    jd = jjournal.serialize_write_plan(jp)
    td = tjournal.serialize_write_plan(tp)
    assert json.dumps(td) == json.dumps(jd)
    # each package reads the other's table back into the same plan
    for d in (json.loads(json.dumps(jd)), json.loads(json.dumps(td))):
        back = tjournal.deserialize_write_plan(d)
        ref = jjournal.deserialize_write_plan(d)
        for f in ("chunk_ids", "chunk_los", "chunk_his", "writers",
                  "subfiles", "file_lo", "file_hi", "nbytes",
                  "group_bounds"):
            np.testing.assert_array_equal(getattr(back, f), getattr(ref, f))
        assert (back.file_sizes, back.align, back.span_bytes,
                back.bytes_total) == (ref.file_sizes, ref.align,
                                      ref.span_bytes, ref.bytes_total)
        for row in range(back.num_chunks):
            cid = int(back.chunk_ids[row])
            assert back.layout.chunks[cid].chunk.block_id == cid
        rows = np.arange(back.num_chunks // 2)
        a = tsubset_write_plan(back, rows)
        b = jio.subset_write_plan(ref, rows)
        np.testing.assert_array_equal(a.group_bounds, b.group_bounds)
        assert a.file_sizes == b.file_sizes


def test_unit_partition_matches_the_reference(world):
    blocks, _ = world
    for strategy, align in (("chunked", 4096), ("merged_process", None)):
        jp, tp = _plans(blocks, strategy, align)
        for n in (1, 2, 3, 5, jp.num_groups, jp.num_groups + 5):
            assert tjournal.partition_unit_rows(tp, n) == \
                jjournal.partition_unit_rows(jp, n)
        empty = tsubset_write_plan(tp, np.array([], dtype=np.int64))
        assert tjournal.partition_unit_rows(empty, 4) == []
    u = tjournal.WorkUnit(unit_id=3, rows=[4, 5], state="done", worker="w1",
                          lease_expires=12.5, attempt=2,
                          checksums={4: 9, 5: 8})
    assert u.to_json() == jjournal.WorkUnit(**vars(u)).to_json()
    assert tjournal.WorkUnit.from_json(json.loads(json.dumps(
        u.to_json()))) == u
    assert (tjournal.REORG_JOURNAL_NAME, tjournal.REORG_JOURNAL_VERSION,
            tjournal.DEFAULT_LEASE_TIMEOUT_S) == \
        (jjournal.REORG_JOURNAL_NAME, jjournal.REORG_JOURNAL_VERSION,
         jjournal.DEFAULT_LEASE_TIMEOUT_S)


# -- the lease protocol under one clock ---------------------------------------

def test_lease_protocol_matches_the_reference(tmp_path, world):
    """The same operations on both journals under one injected clock:
    the same answers at every step, and equal journal documents."""
    blocks, data = world
    clk = FakeClock()
    j, t, _, _, _ = _journals(tmp_path, blocks, data, clk, num_units=3)

    def both(op, *args):
        a, b = getattr(j, op)(*args), getattr(t, op)(*args)
        if hasattr(a, "to_json"):
            assert b.to_json() == a.to_json()
        else:
            assert b == a
        return a

    with pytest.raises(FileExistsError):
        tjournal.ReorgJournal.create(t.dirpath, tjournal.ReorgJournal(
            t.dirpath).plan(), t.spec()["src_dir"], num_units=3)
    assert t.spec() == j.spec()
    u0 = both("claim", "w0")
    clk.advance(4.0)
    u1 = both("claim", "w1")
    both("renew", "w0", u0.unit_id)
    clk.advance(8.0)                      # w1 silent 8 s, w0 renewed 8 s ago
    assert both("claim", "w2") is not None
    clk.advance(3.0)                      # w1's lease expired, w0's too
    stolen = both("claim", "w2")          # both reclaimed; u0 first
    assert (stolen.unit_id, stolen.attempt) == (u0.unit_id, 2)
    assert both("renew", "w1", u1.unit_id) is False
    assert both("complete", "w0", u0.unit_id,
                {int(r): 1 for r in u0.rows}) is False
    assert both("complete", "w2", stolen.unit_id,
                {int(r): 7 for r in stolen.rows}) is True
    both("reset_units", [stolen.unit_id], "validation")
    both("record_event", {"event": "worker_dead", "worker": "w1"})
    both("done")
    assert t.monitor().dead_hosts() == j.monitor().dead_hosts()
    assert t.monitor(5.0).alive_hosts() == j.monitor(5.0).alive_hosts()
    jdoc, tdoc = j.load(), t.load()
    assert tdoc == jdoc
    assert [u.to_json() for u in t.units()] == \
        [u.to_json() for u in j.units()]
    t.delete()
    assert not t.exists()


# -- the worker loop and validation, in process -------------------------------

def test_worker_drains_and_validates_as_the_reference(tmp_path, world):
    """One in-process worker of each package (the port's on the CPU,
    through its gather route) drains its journal: the same stats, the same
    destination bytes, both journals validating; a flipped byte is
    flagged in the same unit, and a fresh worker heals it."""
    blocks, data = world
    clk = FakeClock()
    j, t, jp, tp, _ = _journals(tmp_path, blocks, data, clk)
    js = jreorg.worker_main(j.dirpath, "w0")
    ts = treorg.worker_main(t.dirpath, "w0", device="cpu")
    assert ts == js and isinstance(ts, tdist.ReorgWorkerStats)
    assert ts["chunks_gathered"] == tp.num_chunks and ts["units_done"] == 3
    _same_file_bytes(j.dirpath, t.dirpath)
    assert treorg.validate_journal(t.dirpath, tp, t) == [] == \
        jreorg.validate_journal(j.dirpath, jp, j)
    victim = t.units()[1]
    row = int(victim.rows[0])
    for d, plan in ((j.dirpath, jp), (t.dirpath, tp)):
        path = os.path.join(d, subfile_name(int(plan.subfiles[row])))
        with open(path, "r+b") as f:
            f.seek(int(plan.file_lo[row]))
            b = f.read(1)
            f.seek(int(plan.file_lo[row]))
            f.write(bytes([b[0] ^ 0xFF]))
    assert treorg.validate_journal(t.dirpath, tp, t) == [victim.unit_id] \
        == jreorg.validate_journal(j.dirpath, jp, j)
    t.reset_units([victim.unit_id])
    assert treorg.worker_main(t.dirpath, "w1", device="cpu")[
        "units_done"] == 1
    assert treorg.validate_journal(t.dirpath, tp, t) == []
    # a done unit with no CRCs recorded is flagged, as the reference does
    u = tjournal.ReorgJournal(str(tmp_path / "tdst"))
    u.reset_units([0])
    claimed = u.claim("w2")
    u.complete("w2", claimed.unit_id, {})
    assert treorg.validate_journal(t.dirpath, tp, t) == [claimed.unit_id]


def test_worker_gathers_in_batches(tmp_path, world, monkeypatch):
    """With a small gather budget a unit's chunks are gathered in several
    batches (one ``gather_regions`` call each); the bytes do not change."""
    import repro_torch.io.device as tdevice
    blocks, data = world
    clk = FakeClock()
    j, t, _, _, _ = _journals(tmp_path, blocks, data, clk, num_units=1)
    calls = []
    real = tdevice.gather_regions

    def counting(*a, **k):
        calls.append(len(a[2]))
        return real(*a, **k)

    monkeypatch.setattr(tdevice, "GATHER_BATCH_BYTES", 3 * 8 ** 3 * 4)
    monkeypatch.setattr("repro_torch.io.reader.gather_regions", counting)
    jreorg.worker_main(j.dirpath, "w0")
    treorg.worker_main(t.dirpath, "w0", device="cpu")
    assert calls == [3, 3, 2]
    _same_file_bytes(j.dirpath, t.dirpath)


# -- with_retry ---------------------------------------------------------------

@pytest.mark.parametrize("fails,attempts,exc", [(2, 4, OSError),
                                                (5, 3, OSError),
                                                (1, 5, ValueError)])
def test_with_retry_matches_the_reference(fails, attempts, exc):
    out = []
    for mod in (jreorg, treorg):
        calls, naps = [], []

        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise exc("blip")
            return "ok"

        try:
            got = mod.with_retry(flaky, attempts=attempts, backoff_s=0.1,
                                 sleep=naps.append)
        except (OSError, ValueError) as e:
            got = type(e).__name__
        out.append((got, len(calls), naps))
    assert out[0] == out[1]
    assert treorg.BARRIERS == jreorg.BARRIERS


# -- fault_tolerance ----------------------------------------------------------

def test_fault_tolerance_matches_the_reference():
    for mod_j, mod_t in ((jft, tft),):
        clk = FakeClock(0.0)
        mj = mod_j.HeartbeatMonitor([0, 1, 2], timeout_s=10.0, clock=clk)
        mt = mod_t.HeartbeatMonitor([0, 1, 2], timeout_s=10.0, clock=clk)
        for step, beat in enumerate([0, 1, None, 7, 1, None, 2, 0]):
            clk.advance(3.0 + step)
            if beat is not None:
                mj.beat(beat)
                mt.beat(beat)
            assert mt.dead_hosts() == mj.dead_hosts()
            assert mt.alive_hosts() == mj.alive_hosts()
        for old, alive, fixed in (((8, 4), 24, True), ((4, 2), 6, True),
                                  ((2, 1), 1, True), ((4, 8), 6, False),
                                  ((3, 1), 2, True)):
            a = mod_j.plan_rescale(old, alive, list(range(alive)),
                                   model_axis_fixed=fixed)
            b = mod_t.plan_rescale(old, alive, list(range(alive)),
                                   model_axis_fixed=fixed)
            assert vars(b) == vars(a) and b.describe() == a.describe()
        for mod in (mod_j, mod_t):
            with pytest.raises(ValueError):
                mod.plan_rescale((4, 8), 4, [0])
        sj = mod_j.StragglerTracker([0, 1, 2, 3], alpha=0.3, factor=1.4)
        st = mod_t.StragglerTracker([0, 1, 2, 3], alpha=0.3, factor=1.4)
        rng = np.random.default_rng(3)
        for _ in range(20):
            for h in range(4):
                s = float(rng.uniform(1.0, 1.2) * (2.5 if h == 2 else 1.0))
                sj.record(h, s)
                st.record(h, s)
            assert st.stragglers() == sj.stragglers()
            assert st.reassignment({0: 2, 1: 1, 2: 3, 3: 0}) == \
                sj.reassignment({0: 2, 1: 1, 2: 3, 3: 0})
        assert st.ema == sj.ema


def test_distributed_package_is_lazy_and_names_the_sharding_wait():
    """The package's names are the JAX package's (the sharding rules'
    since the distributed slice, which they no longer wait for), each
    loaded on first access."""
    import repro.distributed as jdist
    import repro_torch.distributed.sharding as tshd
    assert set(tdist.__all__) == set(jdist.__all__)
    assert set(tdist.__all__) >= set(jft.__all__) | {
        "ReorgWorkerStats", "distributed_reorganize", "worker_main",
        "with_retry"}
    assert tdist.plan_rescale is tft.plan_rescale
    assert tdist.worker_main is treorg.worker_main
    assert tdist.shard is tshd.shard
    assert tdist.DEFAULT_RULES == jdist.DEFAULT_RULES
    with pytest.raises(AttributeError, match="no attribute"):
        tdist.no_such_name
