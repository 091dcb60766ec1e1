"""The multi-tenant read service on the port: ``serve/coalesce.py`` held
equal to the JAX package's (the span union, the super-plans), and
``Dataset.read_super_planned`` and ``ReadService`` on the CPU — the plain
version of the card's route — giving the JAX package's bytes and
statistics on raw, compressed, overlapping and misaligned-span datasets;
the plan cache dropped on an index republish, no torn read while in-place
reorganizations commit under the service, and the tenant-tagged access
log equal to the reference's but for the measured seconds.

Every dataset is written by the JAX package and read by both.  No test
sleeps: the service's front door is ``read_batch`` or ``submit`` with a
bounded ``Future.result``, and every wait has a deadline."""

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import plan_layout as jplan_layout
from repro.core import uniform_grid_blocks as juniform
from repro.core.blocks import Block as JBlock
from repro.io import Dataset as JDataset
from repro.io.replay import _identity_layout
from repro.serve import coalesce as jco
from repro.serve.read_service import ReadService as JService

import repro_torch.io as tio
from repro_torch.core import plan_layout, uniform_grid_blocks
from repro_torch.core.blocks import Block
from repro_torch.serve import (ReadService, Request, build_super_plan,
                               union_spans, union_spans_naive)

GLOBAL = (48, 48)
#: a fixed time just past: both packages' sessions stamp their records
#: with it, so the logs' time-to-live check (on the real clock) keeps them
T0 = float(int(time.time()) - 60)


def _clock():
    return T0


def _field(seed, shape=GLOBAL):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _write(ds, var, chunks, arr, codec="none"):
    layout = _identity_layout(chunks, arr.shape)
    ds.write(var, layout, arr.dtype,
             {cp.chunk.block_id: arr[cp.chunk.slices()]
              for cp in layout.chunks}, codec=codec)


def _build(d):
    """Raw, compressed, overlapping and mixed-codec variables, written by
    the JAX package.  ``M``'s compressed extent has an odd size and a
    raw variable's extent lies between it and ``M``'s raw extents (in a
    served batch's fetch buffer the raw span after it starts off an
    element); ``N``'s raw extent follows its odd-sized compressed one
    byte for byte (one merged span, its raw bytes off an element)."""
    ds = JDataset.create(d, engine="pread")
    want = {}
    blocks = juniform(GLOBAL, (8, 8))
    want["T"] = _field(7)
    ds.write_planned(ds.plan_write("T", jplan_layout(
        "chunked", blocks, num_procs=4, global_shape=GLOBAL), np.float32),
        {b.block_id: want["T"][b.slices()] for b in blocks})
    want["Z"] = np.round(_field(8), 1)
    _write(ds, "Z", [[[0, 0], [24, 48], 0], [[24, 0], [48, 48], 1]],
           want["Z"], codec="zlib")
    # overlapping stored chunks: a second write of O over part of the first
    want["O"] = _field(9)
    _write(ds, "O", [[[0, 0], [24, 48], 0], [[24, 0], [48, 48], 1]],
           want["O"])
    second = _field(10)
    _write(ds, "O", [[[10, 10], [30, 30], 1]], second)
    want["O"][10:30, 10:30] = second[10:30, 10:30]
    want["M"] = _field(13)
    _write(ds, "M", [[[0, 0], [24, 48], 2]], want["M"], codec="zlib")
    _write(ds, "X", [[[0], [5], 2]], np.arange(5, dtype=np.float32))
    _write(ds, "M", [[[24, 0], [36, 48], 2], [[36, 0], [48, 48], 2]],
           want["M"])
    want["N"] = _field(12)
    _write(ds, "N", [[[0, 0], [24, 48], 3]], want["N"], codec="zlib")
    _write(ds, "N", [[[24, 0], [48, 48], 3]], want["N"])
    odd = [r.nbytes % 4 for r in ds.index.chunks
           if r.var in ("M", "N") and r.codec != "none"]
    assert odd and all(odd), "the compressed extents must have odd sizes"
    ds.close()
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tsvc") / "data")
    return d, _build(d)


#: per variable: the regions of one super-plan
REGIONS = {
    "T": [((0, 0), (24, 48)), ((12, 0), (36, 48)), ((20, 8), (48, 40)),
          ((0, 0), (1, 1)), ((40, 0), (48, 48))],
    "Z": [((0, 0), (24, 48)), ((20, 5), (30, 40)), ((30, 0), (48, 48))],
    "O": [((0, 0), (8, 48)), ((5, 5), (35, 35)), ((32, 0), (48, 48))],
    "M": [((30, 0), (48, 48)), ((0, 0), (48, 48)), ((24, 3), (26, 45))],
    "N": [((30, 0), (48, 48)), ((0, 0), (48, 48))],
}

STRUCT = ("bytes_read", "chunks_touched", "runs", "groups", "engine",
          "engine_reason")


def _struct(st):
    return tuple(getattr(st, k) for k in STRUCT)


# -- span union -------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 255),
                          st.integers(1, 64)), max_size=40))
def test_union_spans_matches_naive_and_reference(spans):
    subf = np.asarray([s for s, _, _ in spans], dtype=np.int64)
    lo = np.asarray([l for _, l, _ in spans], dtype=np.int64)
    hi = lo + np.asarray([n for _, _, n in spans], dtype=np.int64)
    got = union_spans(subf, lo, hi)
    for want in (union_spans_naive(subf, lo, hi),
                 jco.union_spans(subf, lo, hi)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int64


def test_union_spans_adjacency_and_boundaries():
    s, l, h = union_spans([0, 0], [0, 10], [10, 20])
    assert list(l) == [0] and list(h) == [20]          # adjacent: merged
    s, l, h = union_spans([0, 0], [0, 11], [10, 20])
    assert len(l) == 2                                  # a gap: not
    s, l, h = union_spans([0, 1], [0, 0], [100, 100])
    assert list(s) == [0, 1]                            # subfiles never
    assert all(len(a) == 0 for a in union_spans([], [], []))


# -- super-plans --------------------------------------------------------------

@pytest.mark.parametrize("var", sorted(REGIONS))
def test_super_plan_equal_to_reference(world, var):
    d, _ = world
    jd = JDataset.open(d, telemetry=False)
    td = tio.Dataset.open(d, telemetry=False, device="cpu")
    regions = REGIONS[var]
    jsp = jco.build_super_plan(jd.index, var,
                               [JBlock(lo, hi) for lo, hi in regions])
    tsp = build_super_plan(td.index, var, [Block(lo, hi)
                                           for lo, hi in regions])
    for f in ("var", "fetch_bytes", "payload_bytes", "generation",
              "num_members", "num_spans"):
        assert getattr(tsp, f) == getattr(jsp, f), f
    for f in ("span_subfiles", "span_lo", "span_hi", "span_out"):
        np.testing.assert_array_equal(getattr(tsp, f), getattr(jsp, f))
    for a, b in zip(tsp.member_span, jsp.member_span):
        np.testing.assert_array_equal(a, b)
    for tp, jp in zip(tsp.members, jsp.members):
        for f in ("rec_ids", "inter_los", "inter_his", "file_lo", "file_hi",
                  "group_bounds"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        assert (tp.runs, tp.bytes_needed) == (jp.runs, jp.bytes_needed)
    for tf, jf in zip(tsp.fetch_plan().__dict__.items(),
                      jsp.fetch_plan().__dict__.items()):
        if isinstance(tf[1], np.ndarray):
            np.testing.assert_array_equal(tf[1], jf[1])
    for tprog, jprog in zip(tsp.scatter_programs(), jsp.scatter_programs()):
        for a, b in zip(tprog, jprog):
            np.testing.assert_array_equal(a, b)
    jd.close()
    td.close()


@pytest.mark.parametrize("engine", sorted(tio.ENGINES))
@pytest.mark.parametrize("var", sorted(REGIONS))
def test_read_super_planned_equal_to_reference(world, engine, var):
    """The same super-plan through both packages: each member's bytes
    (rows the stored chunks cover) and the structural statistics of the
    fetch and of every member equal; the raw members gathered by the
    plain ``pack_rows`` wherever their bytes start, the compressed and
    overlapping ones scattered on the host."""
    d, want = world
    regions = REGIONS[var]
    jd = JDataset.open(d, engine=engine, telemetry=False)
    td = tio.Dataset.open(d, engine=engine, telemetry=False, device="cpu")
    jsp = jco.build_super_plan(jd.index, var,
                               [JBlock(lo, hi) for lo, hi in regions])
    tsp = build_super_plan(td.index, var, [Block(lo, hi)
                                           for lo, hi in regions])
    jouts, jf, jm = jd.read_super_planned(jsp)
    touts, tf, tm = td.read_super_planned(tsp)
    assert _struct(tf) == _struct(jf)
    assert tf.bytes_read == tsp.fetch_bytes
    for (lo, hi), j, t, js, ts in zip(regions, jouts, touts, jm, tm):
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        assert t.shape == j.shape and t.dtype.itemsize == 4
        np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_array_equal(t.numpy(), want[var][sl])
        assert _struct(ts) == _struct(js)
    routes = [s.route for s in tm]
    expect = {"T": ["device"] * 5, "Z": ["host"] * 3,
              "O": ["device", "host", "device"],
              "M": ["device", "host", "device"],
              "N": ["device", "host"]}[var]
    assert routes == expect
    jd.close()
    td.close()


@pytest.mark.parametrize("var", ["M", "N"])
def test_misaligned_spans_are_gathered_in_bytes(world, var):
    """A raw member whose bytes follow an odd-sized compressed extent in
    the fetch buffer starts off an element: the port reads the spans back
    to back as the JAX package does (``fetch_bytes`` unchanged) and
    gathers the member on the device route with byte row tables."""
    from repro_torch.io.device import read_super
    from repro_torch.kernels.ref import super_row_tables
    d, want = world
    td = tio.Dataset.open(d, telemetry=False, device="cpu")
    sp = build_super_plan(td.index, var, [Block((30, 0), (48, 48)),
                                          Block((0, 0), (24, 48))])
    first = sp.span_out[sp.member_span[0]] + sp.members[0].extent_offsets \
        - sp.span_lo[sp.member_span[0]]
    assert (first % 4).all(), "the raw member must start off an element"
    width = super_row_tables(sp, [0])[0]
    assert width % 4, "the rows must be byte-granular"
    outs, fstats, host = read_super(td, sp, td.device)
    assert fstats.bytes_read == sp.fetch_bytes
    assert list(host) == [False, True]
    np.testing.assert_array_equal(outs[0].numpy(), want[var][30:])
    np.testing.assert_array_equal(outs[1].numpy(), want[var][:24])
    td.close()


def test_read_super_planned_into_outs_and_empty_members(world):
    d, want = world
    td = tio.Dataset.open(d, telemetry=False, device="cpu")
    import torch
    sp = build_super_plan(td.index, "T", [Block((0, 0), (8, 8)),
                                          Block((4, 4), (20, 20))])
    outs = [torch.full((8, 8), -1.0), torch.full((16, 16), -1.0)]
    got, _, _ = td.read_super_planned(sp, outs=outs)
    assert got is outs
    assert np.array_equal(outs[0].numpy(), want["T"][:8, :8])
    assert np.array_equal(outs[1].numpy(), want["T"][4:20, 4:20])
    td.close()


# -- the service against the reference's ----------------------------------------

def _stats(svc):
    s = dataclasses.asdict(svc.stats)
    t = {k: dict(dataclasses.asdict(v), seconds=0.0)
         for k, v in svc.tenants.items()}
    return s, t


def _serve_both(d, requests, **kw):
    """``requests`` (tenant, var, (lo, hi)) through one ``read_batch`` of
    each package's service on sessions over ``d``; the results and each
    service's statistics (seconds aside).  The window is long: the batch's
    flush, not the window, starts the first cycle, so both services cut
    the same batches."""
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            ds = JDataset.open(d, engine="pread", telemetry=False)
            svc = JService(ds, window_s=0.25, **kw)
            reqs = [jco.Request(t, v, JBlock(lo, hi))
                    for t, v, (lo, hi) in requests]
        else:
            ds = tio.Dataset.open(d, engine="pread", telemetry=False,
                                  device="cpu")
            svc = ReadService(ds, window_s=0.25, **kw)
            reqs = [Request(t, v, Block(lo, hi))
                    for t, v, (lo, hi) in requests]
        with svc:
            res = svc.read_batch(reqs)
        out.append((res, _stats(svc)))
        ds.close()
    return out


@pytest.mark.parametrize("case", ["mixed", "deferred", "fairness"])
def test_service_stats_equal_to_reference(world, case):
    d, want = world
    kw = {}
    if case == "mixed":
        requests = [(f"t{i % 3}", var, r) for var in ("T", "Z", "O", "M")
                    for i, r in enumerate(REGIONS[var])]
    elif case == "deferred":
        # disjoint 3072-byte slabs under a 4000-byte limit: one a batch,
        # while five copies of one slab are fetched, and charged, once
        requests = [("t", "T", ((16 * i, 0), (16 * i + 16, 48)))
                    for i in range(3)]
        requests += [("u", "T", ((0, 0), (16, 48)))] * 5
        kw = {"max_inflight_bytes": 4000}
    else:
        requests = [("chatty", "T", ((0, 0), (8, 48)))] * 6 + \
            [("quiet", "T", ((8, 0), (16, 48)))]
        kw = {"max_batch": 2}
    (jres, jstats), (tres, tstats) = _serve_both(d, requests, **kw)
    assert tstats == jstats
    for (_, var, (lo, hi)), (ja, js), (ta, ts) in zip(requests, jres, tres):
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        np.testing.assert_array_equal(ta.numpy(), want[var][sl])
        np.testing.assert_array_equal(ta.numpy(), ja)
        assert _struct(ts) == _struct(js)
    if case == "deferred":
        assert tstats[0]["deferred"] > 0 and tstats[0]["batches"] >= 3
    if case == "fairness":
        # the quiet tenant's one request rode in the first batch
        assert tstats[0]["batches"] == 4
        assert tstats[1]["quiet"]["coalesced"] == 1


def test_submit_coalesces_and_resolves_tensors(world):
    d, want = world
    ds = tio.Dataset.open(d, engine="pread", device="cpu")
    regions = [Block(lo, hi) for lo, hi in REGIONS["T"][:3]]
    with ReadService(ds, window_s=0.25) as svc:
        futs = [svc.submit(f"t{i}", "T", r) for i, r in enumerate(regions)]
        for r, f in zip(regions, futs):
            t, st = f.result(timeout=30)
            assert t.device.type == "cpu" and st.route == "device"
            np.testing.assert_array_equal(t.numpy(), want["T"][r.slices()])
        with pytest.raises(KeyError):
            svc.read_batch([Request("t", "missing", regions[0])])
    with pytest.raises(RuntimeError):
        svc.submit("t", "T", regions[0])
    ds.close()


# -- staleness: generation invalidation, torn reads -----------------------------

def _reorg_layout(scheme):
    return plan_layout("reorganized", uniform_grid_blocks(GLOBAL, (8, 8)),
                       num_procs=4, global_shape=GLOBAL, reorg_scheme=scheme)


def _copy(world, tmp_path):
    d = str(tmp_path / "data")
    shutil.copytree(world[0], d)
    return d


def test_generation_invalidates_cached_plans(world, tmp_path):
    d = _copy(world, tmp_path)
    want = world[1]["T"]
    region = Block((4, 4), (40, 40))
    ds = tio.Dataset.open(d, engine="pread", device="cpu")
    with ReadService(ds, window_s=0.0) as svc:
        svc.read_batch([Request("t", "T", region)])
        svc.read_batch([Request("t", "T", region)])
        assert svc.stats.cache_hits == 1
        gen0 = ds.generation
        _, dst, _ = tio.reorganize(d, d, "T", _reorg_layout((4, 4)),
                                   engine="pread", device="cpu")
        dst.close()
        got, _ = svc.read_batch([Request("t", "T", region)])[0]
        np.testing.assert_array_equal(got.numpy(), want[region.slices()])
        assert ds.generation == gen0 + 1
        assert svc.stats.refreshes >= 1 and svc.stats.invalidations >= 1
        svc.read_batch([Request("t", "T", region)])
        assert svc.stats.cache_hits == 2
    ds.close()


def test_zero_torn_reads_racing_inplace_reorg(world, tmp_path):
    """Readers hammer the service while three in-place reorganizations
    commit under it: every result equals the reference bytes.  The main
    thread waits, with a deadline, until the reader has been served after
    the last commit."""
    d = _copy(world, tmp_path)
    want = world[1]["T"]
    regions = [Block((0, 0), (24, 48)), Block((12, 12), (44, 44)),
               Block((30, 0), (48, 48))]
    ds = tio.Dataset.open(d, engine="pread", device="cpu")
    stop = threading.Event()
    failures, served = [], [0]
    caught_up = threading.Event()
    mark = [None]

    def hammer():
        i = 0
        while not stop.is_set():
            r = regions[i % len(regions)]
            got, _ = svc.read_batch([Request("t", "T", r)])[0]
            if not np.array_equal(got.numpy(), want[r.slices()]):
                failures.append(i)
            served[0] += 1
            if mark[0] is not None and served[0] >= mark[0]:
                caught_up.set()
            i += 1

    with ReadService(ds, window_s=0.0) as svc:
        t = threading.Thread(target=hammer)
        t.start()
        try:
            for scheme in [(4, 4), (2, 8), (8, 2)]:
                _, dst, _ = tio.reorganize(d, d, "T", _reorg_layout(scheme),
                                           engine="pread", device="cpu")
                dst.close()
            mark[0] = served[0] + 3
            assert caught_up.wait(timeout=60)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()
        assert not failures, f"torn reads at iterations {failures}"
        assert svc.stats.invalidations >= 1
    ds.refresh()
    assert ds.generation == 3
    ds.close()


def test_service_racing_distributed_reorganize(world, tmp_path):
    """Serving the source while a crash-safe fleet of two spawned workers
    reorganizes it: reads stay byte-identical, and a service over the
    committed destination (its generation bumped) serves it."""
    from repro_torch.distributed.reorg import distributed_reorganize
    src = _copy(world, tmp_path)
    dst = str(tmp_path / "dst")
    want = world[1]["T"]
    region = Block((6, 6), (42, 42))
    ds = tio.Dataset.open(src, engine="pread", device="cpu")
    stop = threading.Event()
    failures = []

    def hammer():
        while not stop.is_set():
            got, _ = svc.read_batch([Request("t", "T", region)])[0]
            if not np.array_equal(got.numpy(), want[region.slices()]):
                failures.append(1)

    with ReadService(ds, window_s=0.0) as svc:
        t = threading.Thread(target=hammer)
        t.start()
        try:
            dst_ds, _ = distributed_reorganize(
                src, dst, "T", _reorg_layout((4, 4)), engine="pread",
                num_workers=2, device="cpu")
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()
        assert not failures, "reads torn while the fleet ran"
        assert svc.stats.requests > 0
    assert dst_ds.index.generation == ds.generation + 1
    with ReadService(dst_ds, window_s=0.0) as svc2:
        got, _ = svc2.read_batch([Request("t", "T", region)])[0]
        np.testing.assert_array_equal(got.numpy(), want[region.slices()])
    dst_ds.close()
    ds.close()


# -- tenant-tagged telemetry ----------------------------------------------------

def test_tenant_tagged_access_log_equal_to_reference(world, tmp_path):
    """Both services serve the same batches over copies of one dataset,
    their sessions stamping records with one fixed clock: the two
    ``access_log.json`` files hold the same records, tenant tags
    included, but for the measured seconds."""
    logs = []
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        shutil.copytree(world[0], d)
        slab, column = ((0, 0), (8, 48)), ((0, 0), (48, 8))
        if pkg == "jax":
            ds = JDataset.open(d, engine="pread", clock=_clock)
            svc, B, R = JService(ds, window_s=0.0), JBlock, jco.Request
        else:
            ds = tio.Dataset.open(d, engine="pread", clock=_clock,
                                  device="cpu")
            svc, B, R = ReadService(ds, window_s=0.0), Block, Request
        with svc:
            for _ in range(4):
                svc.read_batch([R("A", "T", B(*slab))])
                svc.read_batch([R("B", "T", B(*column)),
                                R("A", "M", B((30, 0), (48, 48)))])
        ds.close()
        with open(os.path.join(d, "access_log.json")) as f:
            recs = json.load(f)["records"]
        logs.append([{k: v for k, v in r.items() if k != "sec"}
                     for r in recs])
    assert logs[0] == logs[1]
    assert len(logs[1]) == 12
    assert {r.get("tn") for r in logs[1]} == {"A", "B"}
