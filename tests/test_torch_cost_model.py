"""The port's cost model (``repro_torch.core.cost_model``) and its engine
names against the JAX package's, on injected calibrations: the staging
model, every prediction and ``EngineChoice``, ``calibration.json`` and
``reorg_stats.json`` byte for byte, version 1/2/3 loads, drift, the
``choose_engine`` doctests, engine specs and the kernel-bypass degrade
(whose engines are not ported yet: S6), and ``engine="auto"`` through
both packages' ``Dataset`` sessions.  Every comparison is exact."""

import dataclasses
import doctest
import json
import os

import numpy as np
import pytest

import repro.core.cost_model as jcm
import repro.io.engine as jeng
from repro.core import plan_layout as jplan_layout
from repro.core import simulate_load_balance, uniform_grid_blocks
from repro.core.blocks import Block as JBlock
from repro.io import Dataset as JDataset

import repro_torch.core.cost_model as tcm
import repro_torch.io.engine as teng
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.io import Dataset

#: the reference's fixtures for the two storage regimes, and COLD as a
#: probe would see it on a kernel with io_uring and O_DIRECT
CALS = {
    "cold": dict(seek_latency_s=1e-3, preadv_group_overhead_s=5e-6,
                 seq_read_bps=2e9, seq_write_bps=1e9, memmap_bps=8e9,
                 page_miss_s=1e-3, parallel_scaling=8.0, created_at=0.0),
    "hot": dict(seek_latency_s=3e-6, preadv_group_overhead_s=2e-6,
                seq_read_bps=4e9, seq_write_bps=3e9, memmap_bps=6e9,
                page_miss_s=3e-7, parallel_scaling=2.0, created_at=0.0),
}
CALS["cold_kernel"] = dict(CALS["cold"], uring_sqe_s=5e-6, uring_reg_s=2e-4,
                           odirect_seq_read_bps=2e9,
                           odirect_seq_write_bps=1e9, odirect_align_s=1e-5)
#: the hot regime with measured codec bandwidths (v3 terms)
CALS["hot_codecs"] = dict(CALS["hot"], zlib_comp_bps=5e7,
                          zlib_decomp_bps=2e8)
#: plan shapes: (groups, runs, bytes_moved, span_bytes)
SHAPES = [(44, 4096, 64 << 20, 64 << 20), (1, 1, 4096, 4096),
          (3, 700, 1 << 20, 5 << 20), (0, 0, 0, 0), (500, 500, 8 << 20,
                                                      8 << 20)]
ENGINE_SPECS = ["memmap", "pread", "overlapped", "overlapped:2",
                "overlapped:32", "uring", "uring:4", "odirect"]
#: the reference's good and bad engine spellings
GOOD_SPECS = ("memmap", "pread", "overlapped", "overlapped:4", "auto",
              "uring", "uring:8", "odirect")
BAD_SPECS = ("io_uring", "memmap:3", "overlapped:x", "overlapped:0",
             "overlapped:", "", "odirect:4", "uring:0", "uring:x")


def _cals(name):
    return (jcm.EngineCalibration(**CALS[name]),
            tcm.EngineCalibration(**CALS[name]))


def _same(a, b):
    """Two dataclass instances of the two packages hold equal fields."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# -- the staging model (paper §5.2) --------------------------------------------

@pytest.mark.parametrize("t_c", [5.0, 20.0, 31.0, 32.0, 40.0, 150.0])
@pytest.mark.parametrize("N", [1, 10, 26, 50, 1000])
def test_staging_model_matches(t_c, N):
    for jt, tt in ((jcm.PAPER_TIMINGS, tcm.PAPER_TIMINGS),
                   (jcm.StagingTimings(1.0, 2.0, 0.5, 3.0, 16, 4),
                    tcm.StagingTimings(1.0, 2.0, 0.5, 3.0, 16, 4))):
        _same(jt, tt)
        for fn in ("posthoc_utilization", "onthefly_utilization"):
            assert getattr(jcm, fn)(jt, t_c, N) == \
                getattr(tcm, fn)(tt, t_c, N)
        assert jcm.is_blocking(jt, t_c) == tcm.is_blocking(tt, t_c)
        assert jcm.breakeven_outputs(jt, t_c) == \
            tcm.breakeven_outputs(tt, t_c)
        assert jcm.tc_lower_bound_blocking(jt) == \
            tcm.tc_lower_bound_blocking(tt)
        assert jcm.tc_upper_bound_nonblocking(jt, N) == \
            tcm.tc_upper_bound_nonblocking(tt, N)
        assert jcm.recommend(jt, t_c, N) == tcm.recommend(tt, t_c, N)


def test_public_names_match():
    assert set(tcm.__all__) == set(jcm.__all__)
    for name in ("CALIBRATION_NAME", "CALIBRATION_TTL_S",
                 "CALIBRATION_VERSION", "SUPPORTED_CALIBRATION_VERSIONS",
                 "URING_REG_AMORT", "REORG_CHUNK_OVERHEAD_S",
                 "REORG_STATS_NAME", "DEPTH_CANDIDATES",
                 "DISPATCH_OVERHEAD_S", "DRIFT_RATIO", "DRIFT_MIN_SECONDS",
                 "DRIFT_TRIP_COUNT", "DRIFT_COOLDOWN", "PROBE_BYTES"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    _same(jcm.FALLBACK_CALIBRATION, tcm.FALLBACK_CALIBRATION)


# -- predictions and choices ---------------------------------------------------

@pytest.mark.parametrize("cal", sorted(CALS))
@pytest.mark.parametrize("direction", ["read", "write"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_predictions_and_choices_match(cal, direction, shape):
    jc, tc_ = _cals(cal)
    g, r, b, sp = shape
    kw = dict(groups=g, runs=r, bytes_moved=b, span_bytes=sp,
              direction=direction)
    codecs = [("none", 0)] + ([("zlib", b)] if cal == "hot_codecs" else [])
    for codec, cb in codecs:
        for spec in ENGINE_SPECS:
            assert jcm.predict_seconds(jc, spec, **kw, codec=codec,
                                       codec_bytes=cb) == \
                tcm.predict_seconds(tc_, spec, **kw, codec=codec,
                                    codec_bytes=cb), spec
        _same(jcm.choose_engine(jc, **kw, codec=codec, codec_bytes=cb),
              tcm.choose_engine(tc_, **kw, codec=codec, codec_bytes=cb))
        assert jcm.predict_best_seconds(jc, **kw, codec=codec,
                                        codec_bytes=cb) == \
            tcm.predict_best_seconds(tc_, **kw, codec=codec,
                                     codec_bytes=cb)
    write = dict(groups=g, runs=r, bytes_moved=b, span_bytes=sp)
    for extra in ({}, {"chunk_overhead_s": 1e-4}):
        assert jcm.predict_lifecycle_seconds(
            jc, write=write, reads=0.25, expected_reads=3.0,
            num_chunks=64, gather=0.5, **extra) == \
            tcm.predict_lifecycle_seconds(
                tc_, write=write, reads=0.25, expected_reads=3.0,
                num_chunks=64, gather=0.5, **extra)


@pytest.mark.parametrize("cal", sorted(CALS))
@pytest.mark.parametrize("direction", ["read", "write"])
def test_batch_predictions_match(cal, direction):
    jc, tc_ = _cals(cal)
    rng = np.random.default_rng(3)
    g = rng.integers(0, 400, 64)
    r = g * rng.integers(1, 9, 64)
    b = rng.integers(0, 64 << 20, 64)
    sp = b + rng.integers(0, 1 << 20, 64)
    codec = "zlib" if cal == "hot_codecs" else "none"
    kw = dict(groups=g, runs=r, bytes_moved=b, span_bytes=sp,
              direction=direction, codec=codec, codec_bytes=b)
    np.testing.assert_array_equal(jcm.predict_best_seconds_batch(jc, **kw),
                                  tcm.predict_best_seconds_batch(tc_, **kw))


def test_choose_engine_doctests_pass():
    res = doctest.testmod(tcm)
    assert res.attempted >= 4 and res.failed == 0


# -- calibration.json ----------------------------------------------------------

def test_calibration_files_equal_and_versions_load(tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    jc, tc_ = (dataclasses.replace(c, created_at=1.7e9)
               for c in _cals("cold_kernel"))
    jcm.save_calibration(jc, str(jd))
    tcm.save_calibration(tc_, str(td))
    name = tcm.CALIBRATION_NAME
    assert (jd / name).read_bytes() == (td / name).read_bytes()
    payload = json.loads((jd / name).read_text())
    now = 1.7e9 + 60.0
    # v3 as written; v2 without the codec terms; v1 without the kernel
    # terms; an unknown version is stale in both
    for version, drop in ((3, ()), (2, ("zlib_comp_bps", "zlib_decomp_bps",
                                        "lz4_comp_bps", "lz4_decomp_bps")),
                          (1, ("uring_sqe_s", "uring_reg_s",
                               "odirect_seq_read_bps",
                               "odirect_seq_write_bps", "odirect_align_s")),
                          (tcm.CALIBRATION_VERSION + 1, ())):
        for k in drop:
            payload.pop(k, None)
        payload["version"] = version
        for d in (jd, td):
            (d / name).write_text(json.dumps(payload))
        j = jcm.EngineCalibration.from_json(json.loads(
            (jd / name).read_text()))
        t = tcm.EngineCalibration.from_json(json.loads(
            (td / name).read_text()))
        _same(j, t)
        assert j.is_stale(now=now) == t.is_stale(now=now) == \
            (version not in (1, 2, 3))
        assert j.codec_bps("zlib") == t.codec_bps("zlib")
    tcm.invalidate_calibration(str(td))
    assert not (td / name).exists()


def test_probe_reports_the_unported_engines_unsupported(tmp_path):
    """The port's probe measures what the reference's does, and leaves the
    kernel-bypass terms at their "unsupported" sentinels (S6), so auto
    never picks an engine the port lacks from its own probe."""
    cal = tcm.probe_storage(str(tmp_path), probe_bytes=1 << 20)
    ref = jcm.FALLBACK_CALIBRATION
    assert set(dataclasses.asdict(cal)) == set(dataclasses.asdict(ref))
    assert cal.version == tcm.CALIBRATION_VERSION
    assert cal.uring_sqe_s < 0 and cal.odirect_seq_read_bps < 0
    assert cal.odirect_seq_write_bps < 0
    assert cal.seq_read_bps > 0 and cal.memmap_bps > 0
    assert os.listdir(tmp_path) == []
    got = tcm.storage_calibration(str(tmp_path), probe_bytes=1 << 20)
    assert (tmp_path / tcm.CALIBRATION_NAME).exists()
    assert tcm.load_calibration(str(tmp_path)) == got


# -- reorg_stats.json, drift ---------------------------------------------------

def test_reorg_stats_files_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(jcm.time, "time", lambda: 1.7e9)
    monkeypatch.setattr(tcm.time, "time", lambda: 1.7e9)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    name = tcm.REORG_STATS_NAME
    for overhead, n in ((2e-4, 64), (-1.0, 4), (5e-5, 8), (1e-3, 0),
                        (3e-4, 1)):
        j = jcm.observe_reorg_overhead(str(jd), overhead, num_chunks=n)
        t = tcm.observe_reorg_overhead(str(td), overhead, num_chunks=n)
        assert (j is None) == (t is None)
        if j is not None:
            _same(j, t)
        assert (jd / name).read_bytes() == (td / name).read_bytes()
        assert jcm.load_reorg_overhead(str(jd)) == \
            tcm.load_reorg_overhead(str(td))
    (td / name).write_text("{not json")
    assert tcm.load_reorg_stats(str(td)) is None


def test_drift_trips_after_the_same_sequence():
    rng = np.random.default_rng(7)
    pairs = [(float(p), float(p * m)) for p, m in
             zip(rng.uniform(1e-4, 0.1, 400),
                 rng.choice([0.3, 1.0, 1.5, 3.0, 10.0], 400))]
    for kw in ({}, {"trip_count": 2, "cooldown": 3, "ratio": 1.4}):
        j, t = jcm.CalibrationDrift(**kw), tcm.CalibrationDrift(**kw)
        assert [j.note(*p) for p in pairs] == [t.note(*p) for p in pairs]
        assert j.trips == t.trips > 0


# -- engine specs --------------------------------------------------------------

def test_engine_specs_validate_as_the_reference():
    for spec in GOOD_SPECS:
        assert teng.validate_engine_spec(spec) == \
            jeng.validate_engine_spec(spec) == spec
    for spec in BAD_SPECS:
        with pytest.raises(ValueError):
            jeng.validate_engine_spec(spec)
        with pytest.raises(ValueError):
            teng.validate_engine_spec(spec)
    assert teng.validate_engine_spec(teng.get_engine("pread")) == "pread"
    with pytest.raises(ValueError, match="resolved per plan"):
        teng.get_engine("auto")


@pytest.mark.parametrize("spec,ran,depth", [("uring", "overlapped", 8),
                                            ("uring:8", "overlapped", 8),
                                            ("uring:2", "overlapped", 2),
                                            ("odirect", "pread", None)])
def test_kernel_bypass_engines_degrade_naming_s6(spec, ran, depth,
                                                 monkeypatch, tmp_path):
    """``resolve_engine`` degrades as the reference does on a host without
    io_uring or O_DIRECT, with a reason that names S6; ``get_engine``
    refuses the engine outright."""
    monkeypatch.setattr(jeng, "uring_available", lambda: (False, "none"))
    monkeypatch.setattr(jeng, "odirect_available",
                        lambda p: (False, "none"))
    jeng_, jwhy = jeng.resolve_engine(spec, dirpath=str(tmp_path))
    teng_, twhy = teng.resolve_engine(spec, dirpath=str(tmp_path))
    assert jeng_.name == teng_.name == ran
    assert getattr(jeng_, "depth", None) == getattr(teng_, "depth", None) \
        == depth
    assert twhy.split(":")[0] == jwhy.split(":")[0]
    assert "not ported yet (S6)" in twhy
    with pytest.raises(NotImplementedError, match="S6"):
        teng.get_engine(spec)
    assert teng.resolve_engine("pread") == (teng.get_engine("pread"), "")


# -- engine="auto" through the sessions ----------------------------------------

@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One 3-D variable written by the JAX package under subfiled_fpp."""
    d = tmp_path_factory.mktemp("auto")
    shape = (24, 24, 16)
    blocks = simulate_load_balance(uniform_grid_blocks(shape, (8, 8, 8)),
                                   num_procs=4, seed=21)
    rng = np.random.default_rng(21)
    field = rng.standard_normal(shape).astype(np.float32)
    data = {b.block_id: np.ascontiguousarray(field[b.slices()])
            for b in blocks}
    layout = jplan_layout("subfiled_fpp", blocks, num_procs=4,
                          global_shape=shape)
    jd = JDataset.create(str(d / "src"), engine="pread", telemetry=False)
    jd.write("B", layout, np.float32, data)
    jd.close()
    return d, shape, field, blocks, data


@pytest.mark.parametrize("cal", sorted(CALS))
def test_auto_reads_and_writes_record_the_reference_decision(written, cal,
                                                             monkeypatch):
    """The same plans under the same injected calibration: equal engine,
    reason and prediction, the data equal; where the reference's choice is
    a kernel-bypass engine, the port records the degrade naming S6."""
    monkeypatch.setattr(jeng, "uring_available", lambda: (False, "none"))
    d, shape, field, blocks, data = written
    jc, tc_ = _cals(cal)
    jd = JDataset.open(str(d / "src"), engine="auto", calibration=jc,
                       telemetry=False)
    td = Dataset.open(str(d / "src"), engine="auto", calibration=tc_,
                      device="cpu")
    assert td.engine == "auto"
    region = Block((3, 0, 5), (20, 24, 13))
    jarr, js = jd.read_planned(jd.plan_read("B", JBlock(region.lo,
                                                        region.hi)))
    tarr, ts = td.read_planned(td.plan_read("B", region))
    np.testing.assert_array_equal(tarr, jarr)
    choice = tcm.choose_engine(tc_, groups=ts.groups, runs=ts.runs,
                               bytes_moved=ts.bytes_read,
                               span_bytes=td.plan_read("B",
                                                       region).span_bytes)
    assert ts.engine_reason.startswith(choice.reason)
    assert ts.predicted_seconds == js.predicted_seconds
    if choice.engine.startswith("uring"):
        assert ts.engine.startswith("overlapped")
        assert "uring -> overlapped: io_uring engine not ported yet (S6)" \
            in ts.engine_reason
    else:
        assert (ts.engine, ts.engine_reason) == (js.engine,
                                                 js.engine_reason)
    # the device routes resolve auto on the span plan they execute
    got, rs = td.read("B", region)
    assert np.array_equal(got.numpy(), field[region.slices()])
    assert "predicted" in rs.engine_reason and rs.predicted_seconds > 0
    jd.close()
    # writes: the same plan priced the same way
    jblocks = blocks
    tblocks = blocks_from_records(
        [(b.lo, b.hi, b.owner, b.block_id) for b in jblocks])
    jw = JDataset.create(str(d / f"jw_{cal}"), engine="auto",
                         calibration=jc, telemetry=False)
    tw = Dataset.create(str(d / f"tw_{cal}"), engine="auto",
                        calibration=tc_, device="cpu")
    layout_j = jplan_layout("merged_process", jblocks, num_procs=4,
                            global_shape=shape)
    from repro_torch.core import plan_layout as tplan_layout
    layout_t = tplan_layout("merged_process", tblocks, num_procs=4,
                            global_shape=shape)
    jws = jw.write("B", layout_j, np.float32, data)
    tws = tw.write("B", layout_t, np.float32,
                   tensors_from_numpy(data, "cpu"))
    assert tws.predicted_seconds == jws.predicted_seconds
    assert tws.engine_reason.startswith(jws.engine_reason.split("; ")[0])
    assert (d / f"jw_{cal}" / "index.json").read_bytes() == \
        (d / f"tw_{cal}" / "index.json").read_bytes()
    for s in (jw, tw, td):
        s.close()


def test_pinned_kernel_engines_degrade_in_the_session(written):
    d, shape, field, blocks, data = written
    for spec in ("uring:4", "odirect"):
        td = Dataset.open(str(d / "src"), engine=spec, device="cpu")
        got, st = td.read("B", Block((0, 0, 0), shape))
        assert np.array_equal(got.numpy(), field)
        assert st.engine == ("overlapped" if spec == "uring:4"
                             else "pread")
        assert "not ported yet (S6)" in st.engine_reason
        _, st = td.read("B", Block((0, 0, 0), shape), engine="pread")
        assert (st.engine, st.engine_reason) == ("pread", "pinned")
        td.close()
