"""Post-hoc reorganization and the Fig.-6 pattern reads of the port
against the JAX package's, on the CPU with ``pack_rows``' plain version:
``reorganize`` out of place and in place to 3-D, 2-D and uneven
``reorganized`` targets (one gather batch and several) with subfiles and
``index.json`` byte-equal, ``reorg_stats.json``, ``refresh`` after an
in-place commit, ``read_decomposed`` / ``read_pattern`` over every
pattern, ``verify_checksums``, ``merge_blocks``, the modules they use
(read patterns, pattern mixes, ``plan_reorganization``/``decide``, the
planner's ``linear_candidates``/``subset_write_plan``) and the refusal
that names S3.  Every comparison is exact."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import repro.core as jc
import repro.io as jio
from repro.core.blocks import Block as JBlock

import repro_torch.core as tc
import repro_torch.io as tio
import repro_torch.io.device as tdevice
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.io import Dataset

#: name -> (shape, block, procs); "F" rides along in every dataset so the
#: in-place republish has another variable's records to carry over
VARS = {"E": ((16, 24, 20), (4, 8, 5), 6), "P": ((64, 48), (8, 8), 6),
        "F": ((12, 10, 8), (4, 5, 4), 3)}
#: target -> (variable, scheme); None is the dimension-aware default
TARGETS = {"3d_default": ("E", None), "2d_8x8": ("P", (8, 8)),
           "3d_uneven": ("E", (3, 5, 3))}
SCHEMES = [(1, 1, 1), (2, 2, 2), (1, 2, 4), (4, 1, 1), (3, 1, 2)]


def _blocks(name):
    shape, block, procs = VARS[name]
    return jc.simulate_load_balance(jc.uniform_grid_blocks(shape, block),
                                    num_procs=procs, seed=11)


def _port_blocks(blocks):
    return blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                                for b in blocks])


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(11)
    return {n: rng.standard_normal(VARS[n][0]).astype(np.float32)
            for n in VARS}


@pytest.fixture(scope="module")
def source(tmp_path_factory, fields):
    """Every VARS entry written by the JAX package under merged_process."""
    d = tmp_path_factory.mktemp("reorg") / "src"
    jd = jio.Dataset.create(str(d), telemetry=False)
    for name, (shape, _, procs) in VARS.items():
        blocks = _blocks(name)
        layout = jc.plan_layout("merged_process", blocks, num_procs=procs,
                                procs_per_node=2, global_shape=shape)
        jd.write(name, layout, np.float32,
                 {b.block_id: np.ascontiguousarray(fields[name][b.slices()])
                  for b in blocks})
    jd.close()
    return str(d)


def _targets(var, scheme):
    shape, _, procs = VARS[var]
    blocks = _blocks(var)
    return (jc.plan_reorganization(blocks, shape, scheme, num_stagers=procs),
            tc.plan_reorganization(_port_blocks(blocks), shape, scheme,
                                   num_stagers=procs))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.startswith("data_") or f == "index.json"}


# -- reorganize -----------------------------------------------------------------

@pytest.mark.parametrize("budget", ["one_batch", "small_batches"])
@pytest.mark.parametrize("in_place", [False, True], ids=["out", "in_place"])
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_reorganize_matches_the_reference(tmp_path, source, fields,
                                          monkeypatch, target, in_place,
                                          budget):
    """The same source and ``LayoutPlan`` give byte-equal subfiles and
    ``index.json`` (generation bumped; in place, the other variables'
    records carried over), in one gather batch or several."""
    if budget == "small_batches":
        monkeypatch.setattr(tdevice, "GATHER_BATCH_BYTES", 4096)
    var, scheme = TARGETS[target]
    jl, tl = _targets(var, scheme)
    jsrc, tsrc = str(tmp_path / "jsrc"), str(tmp_path / "tsrc")
    shutil.copytree(source, jsrc)
    shutil.copytree(source, tsrc)
    jdst = jsrc if in_place else str(tmp_path / "jdst")
    tdst = tsrc if in_place else str(tmp_path / "tdst")
    before = json.loads(open(os.path.join(tsrc, "index.json")).read())
    _, jds, jws = jio.reorganize(jsrc, jdst, var, jl)
    rs, tds, tws = tio.reorganize(tsrc, tdst, var, tl, device="cpu")
    jds.close()
    assert _files(jdst) == _files(tdst)
    assert tds.generation == before["generation"] + 1
    assert (tws.bytes_written, tws.num_extents, tws.num_subfiles) == \
        (jws.bytes_written, jws.num_extents, jws.num_subfiles)
    assert tws.gather.bytes_read == sum(r.volume for r in
                                        (c.chunk for c in tl.chunks)) * 4
    assert rs > 0 and tws.gather.chunks_touched > 0
    if budget == "small_batches":
        assert len(tdevice.gather_batches(tl, 4)) > 1
    after = json.loads(open(os.path.join(tdst, "index.json")).read())
    if in_place:
        others = [c for c in before["chunks"] if c["var"] != var]
        assert [c for c in after["chunks"] if c["var"] != var] == others
        assert set(after["variables"]) == set(before["variables"])
    else:
        assert set(after["variables"]) == {var}
    got, _ = tds.read(var, Block((0,) * len(VARS[var][0]), VARS[var][0]))
    assert np.array_equal(got.numpy(), fields[var])
    assert tds.verify_checksums(var) == (len(tl.chunks), [])
    tds.close()
    # the learned overhead: the reference's structure, a timing as value
    jst = json.loads(open(os.path.join(jsrc, "reorg_stats.json")).read())
    tst = json.loads(open(os.path.join(tsrc, "reorg_stats.json")).read())
    assert set(tst) == set(jst)
    assert tst["num_observations"] == jst["num_observations"] == 1
    assert tst["chunk_overhead_s"] > 0


def test_in_place_commit_is_seen_after_refresh(tmp_path, source, fields):
    """A session opened before an in-place reorganization keeps reading
    the old extents until ``refresh``; then it reads the new layout."""
    d = str(tmp_path / "d")
    shutil.copytree(source, d)
    old = Dataset.open(d, device="cpu")
    g0, n0 = old.generation, len(old.index.chunks_of("E"))
    assert old.refresh() is False
    _, jl = _targets("E", None)
    _, dst, _ = tio.reorganize(d, d, "E", jl, device="cpu")
    dst.close()
    whole = Block((0, 0, 0), VARS["E"][0])
    got, _ = old.read("E", whole)           # old index, old extents
    assert np.array_equal(got.numpy(), fields["E"])
    assert len(old.index.chunks_of("E")) == n0
    assert old.refresh() is True and old.generation == g0 + 1
    assert len(old.index.chunks_of("E")) == len(jl.chunks)
    got, _ = old.read("E", whole)
    assert np.array_equal(got.numpy(), fields["E"])
    assert old.refresh() is False
    old.close()


def test_reorganize_refusals_name_their_items(tmp_path, source):
    _, tl = _targets("E", None)
    with pytest.raises(ValueError):
        tio.reorganize(source, str(tmp_path / "x"), "E", "merged",
                       device="cpu")
    with pytest.raises(NotImplementedError, match="S3"):
        tio.reorganize(source, str(tmp_path / "x"), "E", device="cpu",
                       trace=object())
    with pytest.raises(NotImplementedError, match="S3"):
        tio.reorganize(source, str(tmp_path / "x"), "E", tl, device="cpu",
                       trace=object())
    assert not (tmp_path / "x").exists()


# -- decomposed and pattern reads ---------------------------------------------

@pytest.fixture(scope="module")
def layouts(tmp_path_factory, source):
    """The source, and its "E" reorganized to 4 x 4 x 4 by the reference."""
    d = str(tmp_path_factory.mktemp("reorganized") / "d")
    jl, _ = _targets("E", None)
    _, ds, _ = jio.reorganize(source, d, "E", jl)
    ds.close()
    return {"merged_process": source, "reorganized": d}


def _stats(st):
    return st.bytes_read, st.chunks_touched


@pytest.mark.parametrize("slab", [None, 3])
@pytest.mark.parametrize("pattern", tc.PATTERNS)
@pytest.mark.parametrize("layout", ["merged_process", "reorganized"])
def test_decomposed_reads_match_the_reference(layouts, fields, layout,
                                              pattern, slab):
    """Every scheme's ``bytes_read`` and ``chunks_touched`` are the
    reference's; ``read_pattern`` reports one of the schemes with the
    reference's counts for it; ``Dataset.read`` of the region is the
    source's."""
    jd = jio.Dataset.open(layouts[layout], telemetry=False)
    td = Dataset.open(layouts[layout], device="cpu")
    shape = VARS["E"][0]
    region = tio.resolve_pattern(shape, pattern, slab)
    assert region == Block(*(jio.resolve_pattern(shape, pattern, slab).lo,
                             jio.resolve_pattern(shape, pattern, slab).hi))
    got, _ = td.read("E", region)
    assert np.array_equal(got.numpy(), fields["E"][region.slices()])
    jregion = JBlock(region.lo, region.hi)
    for scheme in SCHEMES:
        js = jd.read_decomposed("E", jregion, scheme, log_access=False)
        ts = td.read_decomposed("E", region, scheme)
        assert _stats(ts) == _stats(js), scheme
        assert ts.seconds > 0 and ts.engine == js.engine
    for readers in (1, 4, 8):
        scheme, ts = td.read_pattern("E", pattern, num_readers=readers,
                                     slab_thickness=slab)
        assert scheme in jc.best_decompositions(readers, 3)
        js = jd.read_decomposed("E", jregion, scheme, log_access=False)
        assert _stats(ts) == _stats(js)
    jd.close()
    td.close()


def test_decomposed_read_is_one_gather(layouts, monkeypatch):
    """All readers' sub-regions go through one ``gather_regions`` call:
    each touched extent is read once however many readers share it."""
    calls = []
    real = tdevice.gather_regions

    def spy(ds, var, regions, *a, **k):
        calls.append(len(regions))
        return real(ds, var, regions, *a, **k)

    import repro_torch.io.reader as reader
    monkeypatch.setattr(reader, "gather_regions", spy)
    td = Dataset.open(layouts["reorganized"], device="cpu")
    region = Block((0, 0, 0), VARS["E"][0])
    st = td.read_decomposed("E", region, (2, 2, 2))
    assert calls == [8]
    plan = td.plan_read("E", region)
    # the gather reads each of the 64 extents once: 64 span groups at most
    assert st.bytes_read == plan.bytes_needed and st.groups <= 64
    td.close()


def test_auto_decomposed_reads_record_the_engine(layouts):
    cal = tc.EngineCalibration(seek_latency_s=3e-6,
                               preadv_group_overhead_s=2e-6,
                               seq_read_bps=4e9, seq_write_bps=3e9,
                               memmap_bps=6e9, page_miss_s=3e-7,
                               parallel_scaling=2.0, created_at=0.0)
    td = Dataset.open(layouts["merged_process"], engine="auto",
                      calibration=cal, device="cpu")
    for pattern in tc.PATTERNS:
        scheme, st = td.read_pattern("E", pattern, num_readers=4,
                                     engine="auto")
        assert st.engine.split(":")[0] in tio.ENGINES
        assert "predicted" in st.engine_reason
        assert st.predicted_seconds > 0
    td.close()


def test_compressed_chunks_take_the_host_plans(tmp_path, fields):
    shape, _, procs = VARS["E"]
    blocks = _blocks("E")
    layout = jc.plan_layout("merged_process", blocks, num_procs=procs,
                            global_shape=shape)
    d = str(tmp_path / "z")
    jd = jio.Dataset.create(d, telemetry=False)
    jd.write("E", layout, np.float32,
             {b.block_id: np.ascontiguousarray(fields["E"][b.slices()])
              for b in blocks}, codec="zlib")
    jd.close()
    jd = jio.Dataset.open(d, telemetry=False)
    td = Dataset.open(d, device="cpu")
    region = tio.resolve_pattern(shape, "sub_area")
    for scheme in SCHEMES[:3]:
        assert _stats(td.read_decomposed("E", region, scheme)) == _stats(
            jd.read_decomposed("E", JBlock(region.lo, region.hi), scheme,
                               log_access=False))
    jl, tl = _targets("E", None)
    _, jds, _ = jio.reorganize(d, str(tmp_path / "jr"), "E", jl)
    _, tds, _ = tio.reorganize(d, str(tmp_path / "tr"), "E", tl,
                               device="cpu")
    jds.close()
    tds.close()
    assert _files(str(tmp_path / "jr")) == _files(str(tmp_path / "tr"))
    assert tio.reader.sample_codec_ratios(td, "E") == \
        jio.reader.sample_codec_ratios(jd, "E")
    jd.close()
    td.close()


def test_pattern_mixes_drive_the_port(layouts, fields):
    td = Dataset.open(layouts["reorganized"], device="cpu")
    mix = [("sub_area", 0.8), ("plane_xy", 0.2)]
    assert tio.normalize_mix(mix) == jio.normalize_mix(mix)
    from repro_torch.io.patterns import mix_counts
    from repro.io.patterns import mix_counts as jmix_counts
    for m in (mix, [("line_z", 3), ("whole_domain", 1)]):
        assert mix_counts(m) == jmix_counts(m)
    out = tio.drive_pattern_mix(td, "E", mix, rounds=2)
    assert set(out) == {"sub_area", "plane_xy"}
    region = tio.resolve_pattern(VARS["E"][0], "plane_xy")
    assert out["plane_xy"].bytes_read == 2 * region.volume * 4
    weighted, per = tio.measure_pattern_mix(td, "E", mix, repeats=2)
    assert weighted > 0 and set(per) == {"sub_area", "plane_xy"}
    td.close()


# -- integrity -------------------------------------------------------------------

def test_verify_checksums_matches_with_a_corrupted_extent(tmp_path, source):
    d = str(tmp_path / "d")
    shutil.copytree(source, d)
    jd = jio.Dataset.open(d, telemetry=False)
    td = Dataset.open(d, device="cpu")
    for var in (None, "E", "F"):
        assert td.verify_checksums(var) == jd.verify_checksums(var)
    rec = td.index.chunks[len(td.index.chunks) // 2]
    with open(os.path.join(d, f"data_{rec.subfile}.bin"), "r+b") as f:
        f.seek(rec.offset + 5)
        byte = f.read(1)
        f.seek(rec.offset + 5)
        f.write(bytes([byte[0] ^ 0xFF]))
    for var in (None, "E", "F", "P"):
        assert td.verify_checksums(var) == jd.verify_checksums(var)
    assert td.verify_checksums()[1] == [len(td.index.chunks) // 2]
    jd.close()
    td.close()


# -- merge_blocks ------------------------------------------------------------------

@pytest.mark.parametrize("as_tensors", [True, False], ids=["tensors", "numpy"])
@pytest.mark.parametrize("max_clusters", [None, 4])
def test_merge_blocks_matches_the_reference(fields, as_tensors,
                                            max_clusters):
    blocks = _blocks("E")
    rng = np.random.default_rng(5)
    data = {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
            for b in blocks}
    jm, jbufs, jst = jc.merge_blocks(blocks, data, max_clusters=max_clusters)
    tdata = tensors_from_numpy(data, "cpu") if as_tensors else data
    tm, tbufs, tst = tc.merge_blocks(_port_blocks(blocks), tdata,
                                     max_clusters=max_clusters,
                                     gather=lambda d: d)
    assert [(b.lo, b.hi) for b in tm] == [(b.lo, b.hi) for b in jm]
    assert len(tbufs) == len(jbufs)
    for t, j in zip(tbufs, jbufs):
        got = t.numpy() if as_tensors else t
        assert got.shape == j.shape and np.array_equal(got, j)
    assert (tst.n_original, tst.n_merged, tst.bytes_moved) == \
        (jst.n_original, jst.n_merged, jst.bytes_moved)
    assert tst.gather_seconds >= 0 and tst.merge_seconds > 0
    assert set(dataclasses.asdict(tst)) == set(dataclasses.asdict(jst))


# -- the modules reorganization uses ---------------------------------------------

@pytest.mark.parametrize("shape", [(16, 24, 20), (5, 3, 64), (2, 2, 2)])
def test_read_pattern_modules_match(shape):
    for pattern in tc.PATTERNS:
        for slab in (1, 2):
            j = jc.pattern_region(pattern, shape, slab)
            t = tc.pattern_region(pattern, shape, slab)
            assert (t.lo, t.hi) == (j.lo, j.hi)
            for scheme in SCHEMES:
                assert [(p.lo, p.hi, p.owner) for p in
                        tc.decompose_region(t, scheme)] == \
                    [(p.lo, p.hi, p.owner) for p in
                     jc.decompose_region(j, scheme)]
    with pytest.raises(ValueError):
        tc.pattern_region("diagonal", shape)
    for n in range(1, 13):
        for ndim in (2, 3):
            assert tc.best_decompositions(n, ndim) == \
                jc.best_decompositions(n, ndim)
    assert tc.PATTERNS == jc.PATTERNS


@pytest.mark.parametrize("t_c,N,frac", [(40.0, 30, 0.0), (20.0, 10, 0.0),
                                        (40.0, 30, 0.5), (32.5, 100, 0.1)])
def test_reorg_decisions_match(t_c, N, frac):
    j = jc.decide(jc.PAPER_TIMINGS, t_c, N, min_saving_frac=frac)
    t = tc.decide(tc.PAPER_TIMINGS, t_c, N, min_saving_frac=frac)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for var, scheme in TARGETS.values():
        jl, tl = _targets(var, scheme)
        assert [(c.chunk.lo, c.chunk.hi, c.writer, c.subfile)
                for c in tl.chunks] == \
            [(c.chunk.lo, c.chunk.hi, c.writer, c.subfile)
             for c in jl.chunks]


def test_planner_additions_match(source):
    from repro.io.planner import linear_candidates as jlin
    from repro.io.planner import subset_write_plan as jsub
    from repro_torch.io.planner import linear_candidates, subset_write_plan
    jd = jio.Dataset.open(source, telemetry=False)
    td = Dataset.open(source, device="cpu")
    rows_j, rows_t = jd.index.var_rows("E"), td.index.var_rows("E")
    for lo, hi in (((0, 0, 0), (16, 24, 20)), ((3, 5, 7), (9, 10, 8)),
                   ((15, 23, 19), (16, 24, 20))):
        np.testing.assert_array_equal(
            linear_candidates(rows_t, Block(lo, hi)),
            jlin(rows_j, JBlock(lo, hi)))
        np.testing.assert_array_equal(
            linear_candidates(rows_t, Block(lo, hi)),
            np.sort(td.index.spatial_index("E").query(lo, hi)))
    jl, tl = _targets("E", (3, 5, 3))
    jplan = jd.plan_write("E", jl, np.float32, align=4096)
    tplan = td.plan_write("E", tl, np.float32, align=4096)
    for rows in ([], [0], [3, 1, 2, 44], list(range(0, 45, 2))):
        j, t = jsub(jplan, rows), subset_write_plan(tplan, rows)
        for f in dataclasses.fields(j):
            if f.name in ("layout", "plan_seconds"):
                continue
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
    with pytest.raises(IndexError):
        subset_write_plan(tplan, [tplan.num_chunks])
    jd.close()
    td.close()
