"""The layout policy of the port against the JAX package's, on the CPU:
``choose_layout`` decisions (scheme, codec, reason, every score) on the
same history, calibration and ``now``; ``AccessLog`` round trips, the
corrupt or absent log and concurrent appends; ``access_log.json`` after the
same reads under the same clock; ``reorganize(layout="auto")`` — a skewed
pattern mix, a compressible variable on which the policy picks ``zlib``,
a cross-run prior seeding a cold dataset — with subfiles and ``index.json``
(``attrs["policy"]`` included) byte-equal; ``CheckpointManager(strategy=
"auto")`` manifests, ``index.json`` and restore records.

Policy scores are compared as floats for equality: both packages run the
same numpy code.  An access record's measured seconds are the run's own,
so records are compared on every other key; ``runs``/``groups`` are the
executed route's own (the port gathers on the card) except where a
record describes one target's read plan."""

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.core.policy as jpol
import repro.io as jio
from repro.checkpoint import CheckpointManager as JManager
from repro.core.blocks import Block as JBlock

import repro_torch.core as tc
import repro_torch.core.policy as tpol
import repro_torch.io as tio
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records

GLOBAL = (32, 32, 32)
#: the clock both packages' sessions stamp records with, and the policy's
#: recency reference: a fixed time just past, so no record decays and the
#: logs' time-to-live check (on the real clock) keeps them all
T0 = float(int(time.time()) - 60)
#: record keys that are the run's own measurements
MEASURED = {"sec"}
ROUTE_OWN = {"sec", "runs", "groups"}


def _clock():
    return T0


def _jblocks(seed=3, nprocs=4, shape=GLOBAL, box=(8, 8, 8)):
    return jc.simulate_load_balance(jc.uniform_grid_blocks(shape, box),
                                    num_procs=nprocs, seed=seed)


def _tblocks(blocks):
    return blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                                for b in blocks])


def _field(seed=3, compressible=False):
    rng = np.random.default_rng(seed)
    if compressible:
        return (rng.integers(0, 4, GLOBAL) * 0.5).astype(np.float32)
    return rng.standard_normal(GLOBAL).astype(np.float32)


def _records(mod, var="B", shape=GLOBAL, n_slab=8, n_sub=2):
    slab = mod_region(mod, "plane_xy", shape, 4)
    sub = mod_region(mod, "sub_area", shape, None)
    out = []
    for region, count in ((slab, n_slab), (sub, n_sub)):
        for i in range(count):
            out.append(mod.AccessRecord(
                var=var, kind="read",
                shape_class=mod.classify_region(region, shape),
                lo=region.lo, hi=region.hi, runs=64, groups=8,
                nbytes=region.volume * 4, seconds=1e-3 * (i + 1), ts=T0))
    return out


def mod_region(mod, pattern, shape, thickness):
    pkg = jc if mod is jpol else tc
    return pkg.pattern_region(pattern, shape, slab_thickness=thickness)


def _cold(mod):
    cal = jc.EngineCalibration if mod is jpol else tc.EngineCalibration
    return cal(seek_latency_s=1e-3, preadv_group_overhead_s=5e-6,
               seq_read_bps=2e8, seq_write_bps=1e8, memmap_bps=2e8,
               page_miss_s=1e-3, parallel_scaling=8.0, created_at=0.0,
               zlib_comp_bps=20e9, zlib_decomp_bps=40e9)


def _decision_key(d):
    return (d.strategy, d.scheme, d.codec, d.to_json(),
            [(c.chunk.lo, c.chunk.hi, c.subfile, c.writer)
             for c in d.layout.chunks])


class _Extents:
    def __init__(self, blocks):
        self.los = np.asarray([b.lo for b in blocks], dtype=np.int64)
        self.his = np.asarray([b.hi for b in blocks], dtype=np.int64)
        self.subfiles = np.asarray([b.owner for b in blocks], dtype=np.int64)
        self.offsets = np.zeros(len(blocks), dtype=np.int64)


CASES = {
    "slab_mix": dict(),
    "empty": dict(records=False),
    "foreign_var": dict(var="other"),
    "outside_shape": dict(var="huge", shape=(256, 256, 256)),
    "read_only": dict(include_write_cost=False),
    "gather_term": dict(extents=True),
    "zlib": dict(codec={"zlib": 0.1}, cold=True),
    "zlib_incompressible": dict(codec={"zlib": 0.98}, cold=True),
    "zlib_unprobed": dict(codec={"zlib": 0.1}),
    "expected_reads": dict(expected_reads=40.0, cold=True),
    "align": dict(align=4096),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_choose_layout_matches_the_reference(case):
    """The same records, calibration and ``now`` give the same decision:
    strategy, scheme, codec, reason, mix and every score, and the same
    layout."""
    kw = CASES[case]
    jb = _jblocks()
    out = []
    for mod, blocks in ((jpol, jb), (tpol, _tblocks(jb))):
        recs = [] if kw.get("records") is False else _records(
            mod, var=kw.get("var", "B"), shape=kw.get("shape", GLOBAL))
        pol = mod.LayoutPolicy(
            records=recs, calibration=_cold(mod) if kw.get("cold") else None,
            include_write_cost=kw.get("include_write_cost", True))
        out.append(_decision_key(pol.choose_layout(
            "B", blocks, GLOBAL, num_stagers=2, align=kw.get("align"),
            current_extents=_Extents(blocks) if kw.get("extents") else None,
            expected_reads=kw.get("expected_reads"),
            codec_ratios=kw.get("codec"), now=T0)))
    assert out[0] == out[1]
    if case == "zlib":
        assert out[1][2] == "zlib"
    if case == "slab_mix":
        assert out[1][1] != (4, 4, 4)
        assert "slab(axis=2)" in out[1][3]["reason"]


@pytest.mark.parametrize("shape", [(40, 64), (16, 24, 20), (8, 6, 10, 12)],
                         ids=lambda s: f"{len(s)}d")
def test_estimators_and_candidates_match_the_reference(shape):
    """The plan-shape estimators and the candidate schemes are the
    reference's, rank by rank."""
    assert tpol.candidate_schemes(len(shape), shape, 64) == \
        jpol.candidate_schemes(len(shape), shape, 64)
    rng = np.random.default_rng(len(shape))
    scheme = jc.default_reorg_scheme(len(shape), 16, shape)
    targets = jc.regular_decomposition(shape, scheme)
    los = np.asarray([t.lo for t in targets], dtype=np.int64)
    his = np.asarray([t.hi for t in targets], dtype=np.int64)
    subf = np.arange(len(targets), dtype=np.int64) % 3
    for _ in range(5):
        lo = [int(rng.integers(0, s)) for s in shape]
        hi = [int(rng.integers(l + 1, s + 1)) for l, s in zip(lo, shape)]
        offs = jpol.append_extent_offsets((his - los).prod(axis=1) * 4, subf,
                                          align=512)
        assert np.array_equal(offs, tpol.append_extent_offsets(
            (his - los).prod(axis=1) * 4, subf, align=512))
        assert dataclasses.astuple(tpol.estimate_read_shape(
            los, his, Block(tuple(lo), tuple(hi)), 4, subfiles=subf,
            offsets=offs)) == dataclasses.astuple(jpol.estimate_read_shape(
                los, his, JBlock(tuple(lo), tuple(hi)), 4, subfiles=subf,
                offsets=offs))
        assert tpol.classify_region(Block(tuple(lo), tuple(hi)), shape) == \
            jpol.classify_region(JBlock(tuple(lo), tuple(hi)), shape)
    assert dataclasses.astuple(tpol.estimate_write_shape(
        los, his, 4, subfiles=subf, align=4096)) == dataclasses.astuple(
        jpol.estimate_write_shape(los, his, 4, subfiles=subf, align=4096))


# -- the access log --------------------------------------------------------------

def test_access_log_round_trip_and_bound(tmp_path):
    """The same appends give the same ``access_log.json`` in either package,
    each reads the other's, and the ring keeps the newest ``capacity``."""
    for mod, d in ((jpol, tmp_path / "j"), (tpol, tmp_path / "t")):
        d.mkdir()
        log = mod.AccessLog(str(d), capacity=5, clock=_clock)
        for r in _records(mod, n_slab=4, n_sub=3):
            log.append(r)
        assert len(log.records()) == 5
    jtext = (tmp_path / "j" / "access_log.json").read_text()
    assert jtext == (tmp_path / "t" / "access_log.json").read_text()
    got = tpol.AccessLog(str(tmp_path / "j"), clock=_clock).records()
    want = jpol.AccessLog(str(tmp_path / "t"), clock=_clock).records()
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    p_t = tpol.AccessLog(str(tmp_path / "t"), clock=_clock).export_prior()
    p_j = jpol.AccessLog(str(tmp_path / "j"), clock=_clock).export_prior()
    assert open(p_t).read() == open(p_j).read()
    pr = tpol.load_prior_records(str(tmp_path / "t"), now=T0)
    assert len(pr) == 5 and all(r.source == "prior" for r in pr)
    assert [r.to_json() for r in pr] == [
        r.to_json() for r in jpol.load_prior_records(p_j, now=T0)]


@pytest.mark.parametrize("content", [None, "]]] not json",
                                     '{"version": 99, "records": []}',
                                     '{"version": 1}'],
                         ids=["absent", "corrupt", "version", "no_records"])
def test_access_log_corrupt_or_absent_is_empty(tmp_path, content):
    if content is not None:
        (tmp_path / "access_log.json").write_text(content)
    assert tpol.AccessLog(str(tmp_path)).records() == []
    assert tpol.load_prior_records(str(tmp_path)) == []
    d = tpol.LayoutPolicy.for_dataset(str(tmp_path)).choose_layout(
        "B", _tblocks(_jblocks()), GLOBAL)
    assert "no usable access history" in d.reason and d.scheme == (4, 4, 4)


def test_access_log_concurrent_appends_stay_one_document(tmp_path):
    """Threads appending to one log (and a second log object on the same
    file) never leave a torn file."""
    log = tpol.AccessLog(str(tmp_path), flush_every=2)
    other = tpol.AccessLog(str(tmp_path))
    recs = _records(tpol, n_slab=6, n_sub=2)
    recs = [dataclasses.replace(r, ts=time.time()) for r in recs]

    def worker(lg):
        for r in recs:
            lg.append(r)

    threads = [threading.Thread(target=worker, args=(lg,))
               for lg in (log, log, other, other)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log.flush()
    payload = json.loads((tmp_path / "access_log.json").read_text())
    assert payload["version"] == 1
    assert 0 < len(payload["records"]) <= 4 * len(recs)
    assert len(tpol.AccessLog(str(tmp_path)).records()) > 0


def _source(tmp_path, name="src", compressible=False, layout="subfiled_fpp"):
    """A dataset the JAX package wrote (no telemetry of its own)."""
    blocks = _jblocks()
    field = _field(compressible=compressible)
    d = str(tmp_path / name)
    ds = jio.Dataset.create(d, telemetry=False)
    ds.write("B", jc.plan_layout(layout, blocks, num_procs=4,
                                 global_shape=GLOBAL), np.float32,
             {b.block_id: np.ascontiguousarray(field[b.slices()])
              for b in blocks})
    ds.close()
    return d, field


def _log_keys(path, skip):
    payload = json.loads(open(path).read())
    return [{k: v for k, v in r.items() if k not in skip}
            for r in payload["records"]]


def test_access_log_matches_after_the_same_reads(tmp_path):
    """The same reads under the same clock leave the same fingerprints:
    variable, kind, shape class, region, bytes, engine and time."""
    src, field = _source(tmp_path)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, jd)
    shutil.copytree(src, td)
    part = ((3, 5, 0), (20, 32, 9))
    for pkg, d, blk in ((jio, jd, JBlock), (tio, td, Block)):
        kw = {"device": "cpu"} if pkg is tio else {}
        ds = pkg.Dataset.open(d, clock=_clock, **kw)
        ds.read("B", blk((0, 0, 0), GLOBAL))
        ds.read("B", blk(*part))
        ds.read_decomposed("B", blk((0, 0, 0), (32, 32, 8)), (2, 2, 1))
        ds.read_decomposed("B", blk((0, 0, 0), GLOBAL), (1, 2, 2),
                           log_access=False)
        ds.read_pattern("B", "plane_xy", num_readers=4, slab_thickness=4)
        ds.read_pattern("B", "sub_area", num_readers=2)
        ds.close()
    want = _log_keys(os.path.join(jd, "access_log.json"), ROUTE_OWN)
    got = _log_keys(os.path.join(td, "access_log.json"), ROUTE_OWN)
    assert len(got) == 5 and got == want
    assert {r["cls"] for r in got} >= {"whole_domain", "slab(axis=2)"}
    # a session without telemetry writes no log
    quiet = str(tmp_path / "q")
    shutil.copytree(src, quiet)
    ds = tio.Dataset.open(quiet, telemetry=False, device="cpu")
    ds.read("B", Block((0, 0, 0), GLOBAL))
    ds.close()
    assert not os.path.exists(os.path.join(quiet, "access_log.json"))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.startswith("data_") or f == "index.json"}


def _drive_mix(d):
    """The skewed mix (80% z-slabs) read through the JAX package."""
    ds = jio.Dataset.open(d, clock=_clock)
    jio.drive_pattern_mix(ds, "B", [("plane_xy", 8), ("sub_area", 2)],
                          slab_thickness=4)
    ds.close()


AUTO = {"skewed_mix": dict(), "skewed_mix_in_place": dict(in_place=True),
        "zlib": dict(compressible=True, cold=True),
        "zlib_in_place": dict(compressible=True, cold=True, in_place=True),
        "cold_default": dict(mix=False),
        "expected_reads": dict(expected_reads=2.0)}


@pytest.mark.parametrize("case", sorted(AUTO))
def test_reorganize_auto_matches_the_reference(tmp_path, case):
    """``reorganize(layout="auto")`` on the same source and history writes
    byte-equal subfiles and ``index.json``, the decision persisted under
    ``attrs["policy"]``; with a codec the plan is built from the encoded
    sizes after the gather."""
    kw = AUTO[case]
    src, field = _source(tmp_path, compressible=kw.get("compressible",
                                                        False))
    if kw.get("mix", True):
        _drive_mix(src)
    jsrc, tsrc = str(tmp_path / "jsrc"), str(tmp_path / "tsrc")
    shutil.copytree(src, jsrc)
    shutil.copytree(src, tsrc)
    in_place = kw.get("in_place", False)
    jdst = jsrc if in_place else str(tmp_path / "jdst")
    tdst = tsrc if in_place else str(tmp_path / "tdst")
    common = dict(now=T0, expected_reads=kw.get("expected_reads"))
    jpolicy = tpolicy = None
    if kw.get("cold"):
        jpolicy = jpol.LayoutPolicy.for_dataset(jsrc, calibration=_cold(jpol))
        tpolicy = tpol.LayoutPolicy.for_dataset(tsrc, calibration=_cold(tpol))
    _, jds, _ = jio.reorganize(jsrc, jdst, "B", "auto", policy=jpolicy,
                               **common)
    jds.close()
    _, tds, tws = tio.reorganize(tsrc, tdst, "B", "auto", policy=tpolicy,
                                 device="cpu", **common)
    assert _files(jdst) == _files(tdst)
    info = tds.index.attrs["policy"]["B"]
    if kw.get("compressible"):
        assert info["codec"] == "zlib"
        assert all(r.codec == "zlib" for r in tds.index.chunks_of("B"))
    else:
        assert info["codec"] == "none"
    if kw.get("mix", True) and not kw.get("compressible"):
        assert tuple(info["scheme"]) != (4, 4, 4)
        assert info["num_records"] == 10
    if not kw.get("mix", True):
        assert "no usable access history" in info["reason"]
    got, _ = tds.read("B", Block((0, 0, 0), GLOBAL))
    assert np.array_equal(got.numpy(), field)
    assert tws.num_extents == len(tds.index.chunks_of("B"))
    tds.close()


def test_reorganize_prior_seeds_a_cold_dataset(tmp_path):
    """A previous run's exported history seeds the decision over a dataset
    with none: the same decision and bytes as the reference's."""
    warm, _ = _source(tmp_path, name="warm")
    _drive_mix(warm)
    prior = jpol.AccessLog(warm, clock=_clock).export_prior()
    cold, field = _source(tmp_path, name="cold")
    jsrc, tsrc = str(tmp_path / "jsrc"), str(tmp_path / "tsrc")
    shutil.copytree(cold, jsrc)
    shutil.copytree(cold, tsrc)
    _, jds, _ = jio.reorganize(jsrc, str(tmp_path / "jdst"), "B", "auto",
                               prior=prior, now=T0)
    jds.close()
    _, tds, _ = tio.reorganize(tsrc, str(tmp_path / "tdst"), "B", "auto",
                               prior=prior, now=T0, device="cpu")
    info = tds.index.attrs["policy"]["B"]
    assert info["num_prior_records"] == 10 and "prior" in info["reason"]
    assert _files(str(tmp_path / "jdst")) == _files(str(tmp_path / "tdst"))
    got, _ = tds.read("B", Block((0, 0, 0), GLOBAL))
    assert np.array_equal(got.numpy(), field)
    tds.close()


# -- the checkpoint manager ---------------------------------------------------------

def _tree():
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal((16, 16, 16)).astype(np.float32),
            "e": rng.standard_normal((24, 40)).astype(np.float32),
            "count": np.asarray(7, np.int32)}


def _ckpt_files(d):
    out = _files(d)
    out["manifest.json"] = open(os.path.join(d, "manifest.json"), "rb").read()
    return out


def test_checkpoint_auto_matches_the_reference(tmp_path):
    """``strategy="auto"``: the cold save's default decisions, the restore
    records appended to the root's ``access_log.json`` (whole variables
    and an elastic restore's targets), and the next save's history-driven
    decisions give the same manifest, ``index.json`` and bytes."""
    tree = _tree()
    ttree = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    # count-weighted scoring: measured restore seconds differ run to run
    jm = JManager(jroot, strategy="auto", clock=_clock,
                  policy=jpol.LayoutPolicy(log=jpol.AccessLog(jroot),
                                           cost_weighting=False))
    tm = CheckpointManager(troot, strategy="auto", clock=_clock,
                           policy=tpol.LayoutPolicy(
                               log=tpol.AccessLog(troot),
                               cost_weighting=False), device="cpu")
    jm.save(1, tree)
    tm.save(1, ttree)
    assert _ckpt_files(jm.step_dir(1)) == _ckpt_files(tm.step_dir(1))
    man = json.loads(open(os.path.join(tm.step_dir(1),
                                       "manifest.json")).read())
    assert "no usable access history" in man["policy"]["w"]["reason"]
    assert set(man["policy"]) == {"w", "e"}

    targets = {"e": [JBlock((0, 0), (12, 40), owner=0, block_id=0),
                     JBlock((12, 0), (24, 40), owner=1, block_id=1)]}
    jm.restore(1)
    jm.restore(1, target_blocks=targets)
    got, _ = tm.restore(1)
    for k in ("w", "e"):
        assert np.array_equal(got[k].numpy(), tree[k])
    shards, _ = tm.restore(1, target_blocks={"e": _tblocks(targets["e"])})
    for b in targets["e"]:
        assert np.array_equal(shards["e"][b.block_id].numpy(),
                              tree["e"][b.slices()])
    jrec = _log_keys(os.path.join(jroot, "access_log.json"), MEASURED)
    trec = _log_keys(os.path.join(troot, "access_log.json"), MEASURED)
    assert len(trec) == len(jrec) == 5
    whole = [k for k, r in enumerate(trec) if r["cls"] == "whole_domain"]
    for k, (a, b) in enumerate(zip(jrec, trec)):
        if k in whole:                        # the route's own runs/groups
            a = {x: y for x, y in a.items() if x not in ROUTE_OWN}
            b = {x: y for x, y in b.items() if x not in ROUTE_OWN}
        assert a == b
    assert not os.path.exists(os.path.join(tm.step_dir(1),
                                           "access_log.json"))

    jm.save(2, tree)
    tm.save(2, ttree)
    assert _ckpt_files(jm.step_dir(2)) == _ckpt_files(tm.step_dir(2))
    man2 = json.loads(open(os.path.join(tm.step_dir(2),
                                        "manifest.json")).read())
    assert man2["policy"]["e"]["num_records"] >= 1
    assert "no usable access history" not in man2["policy"]["e"]["reason"]


def test_checkpoint_prior_export_and_discovery(tmp_path):
    """``export_prior`` writes the reference's snapshot; a fresh root seeds
    its first auto save from it, given as ``prior=``, per call, or found
    beside it by ``discover_prior``."""
    tree = {"w": torch.arange(16 ** 3, dtype=torch.float32).reshape(16, 16,
                                                                    16)}
    runs = tmp_path / "runs"
    prev = CheckpointManager(str(runs / "run_001"), strategy="auto",
                             clock=_clock, device="cpu")
    prev.save(1, tree)
    prev.restore(1)
    prior = prev.export_prior()
    assert os.path.basename(prior) == tpol.ACCESS_PRIOR_NAME
    jprev = JManager(str(tmp_path / "jprev"), strategy="auto", clock=_clock)
    jprev.save(1, {"w": tree["w"].numpy()})
    jprev.restore(1)
    jp = jprev.export_prior()
    assert _log_keys(jp, ROUTE_OWN) == _log_keys(prior, ROUTE_OWN)

    for kind in ("prior", "per_call", "discovered"):
        root = str(runs / f"run_{kind}")
        mgr = CheckpointManager(root, strategy="auto", device="cpu",
                                prior=prior if kind == "prior" else None)
        mgr.save(1, tree, prior=prior if kind == "per_call" else None)
        man = json.loads(open(os.path.join(mgr.step_dir(1),
                                           "manifest.json")).read())
        assert man["policy"]["w"]["num_prior_records"] >= 1, kind
        got, _ = mgr.restore(1)
        assert torch.equal(got["w"], tree["w"])
    assert CheckpointManager(str(runs / "run_x"), device="cpu") \
        .discover_prior() == prior
