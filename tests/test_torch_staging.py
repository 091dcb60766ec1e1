"""Staging and async checkpoints of the port against the JAX package's, on
the CPU with the copy kernels' plain versions: staged subfiles and
``index.json`` equal to the reference's ``StagingExecutor`` (one worker)
and to ``Dataset.write`` for 2-D and 3-D ``reorganized`` layouts across
``align`` values, every chunk assembled on the device route; a source
mutated in place after ``submit`` that does not reach the staged bytes;
the retryable failed step; ``AsyncCheckpointer`` as the ``Trainer``'s
checkpoint manager (every staged leaf equal to the params at its step) and
its §5.2 recommendation; the two example twins at their small sizes.
Everything here is data movement: every comparison is exact."""

import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.io as jio
from repro.checkpoint.async_ckpt import AsyncCheckpointer as JAsync
from repro.core.reorg import decide as jdecide

import repro_torch.core as tc
import repro_torch.io as tio
import repro_torch.io.device as tdevice
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.blocks import Block
from repro_torch.data.pipeline import PipelineConfig, make_pipeline
from repro_torch.examples import layout_reorg_demo, train_e2e
from repro_torch.interop import blocks_from_records, tensors_from_numpy
from repro_torch.models import LM
from repro_torch.train import OptimizerConfig, Trainer

#: name -> (shape, box, procs, scheme): even and uneven 2-D grids, 3-D
#: grids whose chunk edges cut through boxes, and a 4-D variable
LAYOUTS = {"2d_even": ((64, 48), (16, 16), 6, (4, 4)),
           "2d_uneven": ((64, 48), (16, 16), 6, (3, 5)),
           "3d": ((16, 24, 20), (4, 8, 5), 6, (4, 4, 4)),
           "3d_uneven": ((16, 24, 20), (4, 8, 5), 6, (3, 5, 3)),
           "4d": ((6, 8, 4, 10), (3, 4, 2, 5), 4, (2, 3, 2, 3))}


def _world(name, seed=7):
    shape, box, procs, scheme = LAYOUTS[name]
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(shape, box),
                                  num_procs=procs, seed=seed)
    tb = blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                              for b in jb])
    rng = np.random.default_rng(seed)
    data = {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
            for b in jb}
    jl = jc.plan_layout("reorganized", jb, num_procs=procs,
                        global_shape=shape, reorg_scheme=scheme,
                        num_stagers=2)
    tl = tc.plan_layout("reorganized", tb, num_procs=procs,
                        global_shape=shape, reorg_scheme=scheme,
                        num_stagers=2)
    field = np.zeros(shape, np.float32)
    for b in jb:
        field[b.slices()] = data[b.block_id]
    return jl, tl, data, field


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.startswith("data_") or f == "index.json"}


@pytest.fixture
def no_host_route(monkeypatch):
    """Every chunk must be assembled through ``pack_rows``' route: the host
    assembly raises."""
    def refuse(*a, **k):
        raise AssertionError("a chunk took the host route")
    monkeypatch.setattr(tdevice, "assemble_chunk", refuse)


@pytest.mark.parametrize("align", [None, 64, 4096],
                         ids=["unaligned", "a64", "a4096"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_staged_bytes_match_the_reference(tmp_path, no_host_route, name,
                                          align):
    """Two steps staged by one worker: the port's subfiles and
    ``index.json`` equal the reference executor's and the reference
    writer's for the same layout."""
    jl, tl, data, field = _world(name)
    jd, td, wd = (str(tmp_path / k) for k in ("j", "t", "w"))
    jex = jio.StagingExecutor(jd, num_workers=1, align=align,
                              engine="pread")
    tex = tio.StagingExecutor(td, num_workers=1, align=align,
                              engine="pread", device="cpu")
    tdata = tensors_from_numpy(data, "cpu")
    for step in range(2):
        assert jex.submit(step, "B", np.float32, jl, data) >= 0
        assert tex.submit(step, "B", np.float32, tl, tdata) >= 0
    jres, tres = jex.drain(), tex.drain()
    jex.close()
    tex.close()
    assert [r.error for r in tres] == [None, None]
    assert [(r.step, r.num_chunks, r.bytes_staged) for r in tres] == \
        [(r.step, r.num_chunks, r.bytes_staged) for r in jres]
    assert all(r.engine == "pread" and r.t_s > 0 for r in tres)
    jw = jio.Dataset.create(wd, engine="pread")
    for step in range(2):
        jw.write(f"B@{step}", jl, np.float32, data, align=align)
    jw.close()
    assert _files(td) == _files(jd) == _files(wd)
    ds = tio.Dataset.open(td, device="cpu")
    for step in range(2):
        got, _ = ds.read(f"B@{step}", Block((0,) * field.ndim, field.shape))
        assert np.array_equal(got.numpy(), field)
    ds.close()


def test_assembly_takes_the_intersection_route(no_host_route):
    """3-D chunks whose edges cut through boxes, chunks partly covered
    (zero elsewhere, as the reference's buffers), and a lone contiguous
    source passed uncopied: the device route's chunks equal the JAX
    package's ``assemble_chunk``."""
    from repro.io.engine import assemble_chunk as jassemble
    jl, tl, data, _ = _world("3d_uneven")
    tdata = tensors_from_numpy(data, "cpu")
    bufs, stages = tdevice.assemble_chunks(tl, tdata, np.float32)
    assert set(stages) == {"lower", "kernel", "d2h"}
    for cp, buf in zip(jl.chunks, bufs):
        assert np.array_equal(buf, jassemble(cp, data, np.float32))
    # a layout whose chunks only half cover the domain's blocks
    half = [b for b in tl.chunks[0].sources][:1]
    part = tc.LayoutPlan(
        strategy="reorganized", global_shape=tl.global_shape,
        chunks=(tc.ChunkPlan(chunk=tl.chunks[0].chunk, sources=tuple(half),
                             writer=0, subfile=0),),
        num_subfiles=1, inter_process_moved=0, intra_node_moved=0)
    got, _ = tdevice.assemble_chunks(part, tdata, np.float32)
    want = np.zeros(tl.chunks[0].chunk.shape, np.float32)
    inter = tl.chunks[0].chunk.intersect(half[0])
    want[inter.slices(origin=tl.chunks[0].chunk.lo)] = \
        data[half[0].block_id][inter.slices(origin=half[0].lo)]
    assert np.array_equal(got[0], want)
    # a lone contiguous source enters the kernel as it is
    leaf = torch.arange(4 * 6 * 10, dtype=torch.float32).reshape(4, 6, 10)
    whole = [tc.Block((0, 0, 0), (4, 6, 10), owner=0, block_id=0)]
    lay = tc.plan_layout("reorganized", whole, num_procs=0,
                         global_shape=(4, 6, 10), reorg_scheme=(2, 3, 1))
    seen = []
    real = tdevice.pack_tables
    tdevice.pack_tables = lambda src, *a, **k: seen.append(src) or \
        real(src, *a, **k)
    try:
        got, _ = tdevice.assemble_chunks(lay, {0: leaf}, np.float32)
    finally:
        tdevice.pack_tables = real
    assert seen[0].data_ptr() == leaf.data_ptr()
    for cp, buf in zip(lay.chunks, got):
        assert np.array_equal(buf, leaf[cp.chunk.slices()].numpy())


def test_a_source_mutated_after_submit_does_not_reach_the_stage(tmp_path):
    """The producer updates its tensors in place right after ``submit``
    (before the worker assembles): the staged bytes are the data as they
    were at ``submit``."""
    _, tl, data, field = _world("3d")
    tdata = tensors_from_numpy(data, "cpu")
    ex = tio.StagingExecutor(str(tmp_path / "s"), num_workers=1,
                             engine="pread", device="cpu")
    go = threading.Event()
    plan_write = ex.dataset.plan_write

    def held(*a, **k):
        assert go.wait(30)
        return plan_write(*a, **k)

    ex.dataset.plan_write = held
    ex.submit(0, "B", np.float32, tl, tdata)
    for t in tdata.values():
        t.mul_(-3.0).add_(1.0)                # the optimizer step
    go.set()
    ex.submit(1, "B", np.float32, tl, tdata)
    res = ex.drain()
    ex.close()
    assert [r.error for r in res] == [None, None]
    ds = tio.Dataset.open(str(tmp_path / "s"), device="cpu")
    whole = Block((0, 0, 0), field.shape)
    got0, _ = ds.read("B@0", whole)
    got1, _ = ds.read("B@1", whole)
    assert np.array_equal(got0.numpy(), field)
    assert np.array_equal(got1.numpy(), field * -3.0 + 1.0)
    ds.close()


def _flaky(engine_cls):
    class Flaky(engine_cls):
        name = "flaky-pread"

        def __init__(self):
            super().__init__()
            self.tripped = False

        def write_plan(self, plan, buffers, store):
            if not self.tripped:
                self.tripped = True
                raise OSError("injected crash in the engine write")
            super().write_plan(plan, buffers, store)
    return Flaky()


def test_a_failed_step_is_retryable(tmp_path):
    """A step whose engine write fails is reported in ``StageResult.error``
    with nothing committed for it; its re-submission lands, and the
    dataset equals the reference's after the same sequence."""
    jl, tl, data, field = _world("3d")
    out = {}
    for pkg, layout, d, kw, arrays in (
            (jio, jl, str(tmp_path / "j"), {}, data),
            (tio, tl, str(tmp_path / "t"), {"device": "cpu"},
             tensors_from_numpy(data, "cpu"))):
        ex = pkg.StagingExecutor(d, num_workers=1,
                                 engine=_flaky(pkg.PreadEngine), **kw)
        for step in (0, 0, 1):
            ex.submit(step, "B", np.float32, layout, arrays)
        out[pkg] = ex.drain()
        assert "B@0" not in ex.index.variables or \
            len(ex.index.chunks_of("B@0")) == len(layout.chunks)
        ex.close()
    failed = [r for r in out[tio] if r.error]
    assert len(failed) == 1 and "injected crash" in failed[0].error
    assert sorted(r.step for r in out[tio] if not r.error) == [0, 1]
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    ds = tio.Dataset.open(str(tmp_path / "t"), device="cpu")
    for step in (0, 1):
        got, _ = ds.read(f"B@{step}", Block((0, 0, 0), field.shape))
        assert np.array_equal(got.numpy(), field)
    ds.close()


def test_auto_plan_and_refusals(tmp_path):
    """``plan="auto"`` takes the policy's cached decision (a prior seeds
    it); ``"auto"`` without blocks, another string, and ``trace=`` are
    refused as the reference refuses them (``trace`` waits for S3)."""
    jl, tl, data, field = _world("3d")
    blocks = [s for cp in tl.chunks for s in cp.sources]
    blocks = list({b.block_id: b for b in blocks}.values())
    ex = tio.StagingExecutor(str(tmp_path / "a"), num_workers=2,
                             engine="pread", device="cpu")
    tdata = tensors_from_numpy(data, "cpu")
    for step in range(2):
        ex.submit(step, "B", np.float32, "auto", tdata, blocks=blocks,
                  global_shape=field.shape)
    with pytest.raises(ValueError, match="blocks"):
        ex.submit(2, "B", np.float32, "auto", tdata)
    with pytest.raises(ValueError, match="auto"):
        ex.submit(2, "B", np.float32, "fastest", tdata)
    res = ex.drain()
    ex.close()
    assert [r.error for r in res] == [None, None]
    d = ex.decision_for("B", blocks, field.shape)
    assert "no usable access history" in d.reason
    jd = jio.StagingExecutor(str(tmp_path / "j"), num_workers=2,
                             engine="pread")
    jlay = jd.layout_for("B", [s for cp in jl.chunks for s in cp.sources],
                         field.shape)
    jd.close()
    assert [(c.chunk.lo, c.chunk.hi, c.subfile) for c in jlay.chunks] == \
        [(c.chunk.lo, c.chunk.hi, c.subfile) for c in d.layout.chunks]
    ds = tio.Dataset.open(str(tmp_path / "a"), device="cpu")
    for step in range(2):
        got, _ = ds.read(f"B@{step}", Block((0, 0, 0), field.shape))
        assert np.array_equal(got.numpy(), field)
    ds.close()
    with pytest.raises(NotImplementedError, match="S3"):
        tio.StagingExecutor(str(tmp_path / "x"), trace=object(),
                            device="cpu")


def _train(tmp_path, ckpt, steps=3):
    cfg = get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cpu")
    _, data = make_pipeline(PipelineConfig(global_batch=2, seq_len=16,
                                           vocab=cfg.vocab, seed=3),
                            prefetch=0)
    tr = Trainer(model, OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                                        total_steps=10),
                 data, ckpt_manager=ckpt, ckpt_every=1)
    params, opt = tr.init(torch.Generator("cpu").manual_seed(0))
    return tr.run(params, opt, num_steps=steps, log_every=0)


class _Witness:
    """The checkpointer behind a ``Trainer``, keeping a host copy of every
    leaf at each save."""

    def __init__(self, inner):
        self.inner, self.seen = inner, {}

    def save(self, step, tree, **kw):
        from repro_torch.checkpoint import flatten_pytree
        self.seen[step] = {k: v.detach().numpy().copy()
                           for k, v in flatten_pytree(tree).items()}
        return self.inner.save(step, tree, **kw)


def test_async_checkpointer_behind_the_trainer(tmp_path):
    """Three steps with a staged save after each: every staged leaf equals
    the params at its step (AdamW updates them in place in the next
    step), and the §5.2 recommendation is the reference's ``decide`` on
    the same timings."""
    root = str(tmp_path / "ac")
    ac = AsyncCheckpointer(root, reorg_scheme=(4, 4), num_workers=2,
                           queue_depth=1, engine="pread", device="cpu")
    w = _Witness(ac)
    _train(tmp_path, w)
    results = ac.finish()
    assert results and all(r.error is None for r in results)
    assert len(ac.records) == 3
    ds = tio.Dataset.open(root, device="cpu")
    for step, leaves in w.seen.items():
        for name, want in leaves.items():
            got, _ = ds.read(f"{name}@{step}",
                             Block((0,) * want.ndim, want.shape))
            assert np.array_equal(got.numpy(), want), (name, step)
    ds.close()
    moved = [k for k in w.seen[1] if not np.array_equal(w.seen[1][k],
                                                        w.seen[3][k])]
    assert moved, "the params did not change between saves"
    t = ac.timings(results)
    for t_c, n in ((10.0, 100), (1e-3, 4)):
        got, want = ac.recommendation(t_c, n, t), jdecide(
            jc.StagingTimings(**{f: getattr(t, f) for f in
                                 ("t_s", "t_w_stage", "t_w_sim",
                                  "t_r_stage", "n", "m")}), t_c, n)
        assert (got.mode, got.blocking, got.breakeven_N,
                got.utilization_on_the_fly, got.utilization_post_hoc) == \
            (want.mode, want.blocking, want.breakeven_N,
             want.utilization_on_the_fly, want.utilization_post_hoc)


def test_async_checkpointer_matches_the_reference(tmp_path):
    """The same tree and block map, saved three times by one worker: the
    same subfiles and ``index.json`` as the JAX package's
    ``AsyncCheckpointer``; 0-d leaves are skipped."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "m": {"b": rng.standard_normal((6, 8, 10)).astype(np.float32)},
            "count": np.asarray(3, np.int32)}
    bm = {"w": jc.shard_grid_blocks((64, 48), (4, 1), lambda i: i[0])}
    tbm = {"w": blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                                     for b in bm["w"]])}
    ttree = {"w": torch.from_numpy(tree["w"].copy()),
             "m": {"b": torch.from_numpy(tree["m"]["b"].copy())},
             "count": torch.tensor(3, dtype=torch.int32)}
    ja = JAsync(str(tmp_path / "j"), reorg_scheme=(2, 2), num_workers=1,
                engine="pread")
    ta = AsyncCheckpointer(str(tmp_path / "t"), reorg_scheme=(2, 2),
                           num_workers=1, engine="pread", device="cpu")
    for step in range(3):
        ja.save(step, tree, block_map=bm)
        ta.save(step, ttree, block_map=tbm)
    jr, tr = ja.finish(), ta.finish()
    assert len(tr) == len(jr) == 6
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    index = json.loads(open(tmp_path / "t" / "index.json").read())
    assert not any(v.startswith("count") for v in index["variables"])


def test_train_e2e_twin_runs_on_the_cpu(tmp_path, capsys):
    train_e2e.main(["--steps", "2", "--tiny", "--device", "cpu",
                    "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "final checkpoint" in out and "loss:" in out
    assert sorted(os.listdir(tmp_path / "c")) == ["step_00000001",
                                                  "step_00000002"]


def test_layout_reorg_demo_twin_runs_on_the_cpu(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    layout_reorg_demo.main(["--tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decision for t_c" in out
    assert out.count("restore read") == 3
    assert os.listdir(tmp_path) == []
