"""Workload traces on the port: ``io/trace.py`` held equal to the JAX
package's (the committed corpus loaded, saved, scaled and exported as a
prior to the same bytes; the same schema errors; the same salvage of a
damaged file), and a capture through the port's hooks — reads,
decomposed and pattern reads, served requests, writes, staging submits,
a reorganization and checkpoint saves and restores — journaling the
events the JAX package's hooks journal for the same workload."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.blocks import Block as JBlock
from repro.core.blocks import uniform_grid_blocks as juniform
from repro.core.cost_model import FALLBACK_CALIBRATION as JCAL
from repro.core.layouts import plan_layout as jplan_layout
from repro.core.policy import AccessLog as JLog
from repro.core.policy import LayoutPolicy as JPolicy
from repro.io import Dataset as JDataset
from repro.io import StagingExecutor as JStaging
from repro.io import TraceRecorder as JRecorder
from repro.io import header_for_dataset as jheader
from repro.io import load_trace as jload
from repro.io import reorganize as jreorganize
from repro.io import trace as jtrace
from repro.serve.coalesce import Request as JRequest
from repro.serve.read_service import ReadService as JService

import repro_torch.io as tio
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.blocks import Block
from repro_torch.core.cost_model import FALLBACK_CALIBRATION
from repro_torch.core.layouts import plan_layout
from repro_torch.core.policy import AccessLog, LayoutPolicy
from repro_torch.interop import to_tensor
from repro_torch.io import trace as ttrace
from repro_torch.serve import ReadService, Request

TRACES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traces")
CORPUS = sorted(f[:-6] for f in os.listdir(TRACES_DIR)
                if f.endswith(".jsonl"))
SHAPE = (32, 32, 32)
T0 = float(int(time.time()) - 60)


def _clock():
    return T0


# -- the format ---------------------------------------------------------------

@pytest.mark.parametrize("name", CORPUS)
def test_corpus_loads_saves_scales_and_exports_as_reference(tmp_path, name):
    path = os.path.join(TRACES_DIR, f"{name}.jsonl")
    jt, tt = jload(path), tio.load_trace(path)
    assert json.dumps(tt.header.to_json()) == json.dumps(jt.header.to_json())
    assert [e.to_json() for e in tt.events] == \
        [e.to_json() for e in jt.events]
    for factor in (1, 2, 3):
        js, ts = jt.scaled(factor), tt.scaled(factor)
        assert ts.header.to_json() == js.header.to_json()
        assert [e.to_json() for e in ts.events] == \
            [e.to_json() for e in js.events]
    jp = jt.save(str(tmp_path / "j.jsonl"))
    tp = tt.save(str(tmp_path / "t.jsonl"))
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    assert tio.load_trace(tp).events == tt.events
    jt.export_prior(str(tmp_path / "jp.json"), now=T0)
    tt.export_prior(str(tmp_path / "tp.json"), now=T0)
    with open(tmp_path / "jp.json") as a, open(tmp_path / "tp.json") as b:
        assert json.load(a) == json.load(b)
    assert {str(k): v for k, v in tt.read_mix().items()} == \
        {str(k): v for k, v in jt.read_mix().items()}


BAD_EVENTS = [
    dict(kind="no_such_kind", seq=0, var="T", lo=(0,), hi=(1,)),
    dict(kind="read", seq=0, var="T"),
    dict(kind="read", seq=-1, var="T", lo=(0,), hi=(1,)),
    dict(kind="read", seq=0, lo=(0,), hi=(1,)),
    dict(kind="read", seq=0, var="T", lo=(4,), hi=(0,)),
    dict(kind="read", seq=0, var="T", lo=(0, 0), hi=(4,)),
    dict(kind="read_decomposed", seq=0, var="T", lo=(0,), hi=(4,)),
    dict(kind="ckpt_save", seq=0, params={"step": 0}),
]


@pytest.mark.parametrize("bad", BAD_EVENTS,
                         ids=[f"{i}-{e['kind']}" for i, e in
                              enumerate(BAD_EVENTS)])
def test_schema_errors_equal_to_reference(bad):
    with pytest.raises(jtrace.TraceSchemaError) as je:
        jtrace.validate_event(jtrace.TraceEvent(**bad))
    with pytest.raises(ttrace.TraceSchemaError) as te:
        ttrace.validate_event(ttrace.TraceEvent(**bad))
    assert str(te.value) == str(je.value)


def test_future_version_and_empty_file_refused(tmp_path):
    path = str(tmp_path / "future.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(ttrace.TraceHeader(
            version=ttrace.TRACE_VERSION + 1).to_json()) + "\n")
    for salvage in (False, True):
        with pytest.raises(ttrace.TraceError, match="newer than this"):
            tio.load_trace(path, salvage=salvage)
    open(path, "w").close()
    with pytest.raises(ttrace.TraceCorruptError):
        tio.load_trace(path)


@pytest.mark.parametrize("damage", ["truncated", "corrupt_middle",
                                    "non_monotonic"])
def test_damaged_trace_salvages_the_reference_prefix(tmp_path, damage):
    lines = open(os.path.join(TRACES_DIR, "dims_small.jsonl")) \
        .read().splitlines(True)
    if damage == "truncated":
        lines[-1] = lines[-1][:9]
    elif damage == "corrupt_middle":
        lines.insert(4, "{not json at all\n")
    else:
        lines.insert(6, lines[2])
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.writelines(lines)
    with pytest.raises(jtrace.TraceCorruptError) as je:
        jload(path)
    with pytest.raises(ttrace.TraceCorruptError) as te:
        tio.load_trace(path)
    assert str(te.value) == str(je.value)
    assert te.value.salvaged.events == tio.load_trace(path,
                                                      salvage=True).events
    assert [e.to_json() for e in te.value.salvaged.events] == \
        [e.to_json() for e in je.value.salvaged.events]


# -- capture through the hooks ----------------------------------------------------

def _write_source(d):
    """The capture workload's source, written by the JAX package."""
    ds = JDataset.create(d, engine="memmap")
    blocks = [b.with_owner(i % 8) for i, b in
              enumerate(juniform(SHAPE, (16, 16, 16)))]
    layout = jplan_layout("subfiled_fpp", blocks, num_procs=8,
                          global_shape=SHAPE)
    arr = np.random.default_rng(41).standard_normal(SHAPE) \
        .astype(np.float32)
    ds.write("T", layout, np.float32,
             {cp.chunk.block_id: arr[cp.chunk.slices()]
              for cp in layout.chunks})
    ds.close()
    return arr


def _capture(tmp_path, pkg: str) -> str:
    """The JAX package's replay-test workload (thin z-slabs, a box, a
    decomposed and a pattern read, an in-place ``layout="auto"``
    reorganization and a read after it), plus served batches, a write,
    two staging submits and checkpoint saves and restores, captured
    through ``pkg``'s hooks on a copy of one source.  The sessions stamp
    one fixed clock and the reorganization's policy is pinned
    (``FALLBACK_CALIBRATION``, ``cost_weighting=False``), so the decision
    depends on the workload alone."""
    src = str(tmp_path / f"src_{pkg}")
    shutil.copytree(str(tmp_path / "src"), src)
    jax = pkg == "jax"
    B = JBlock if jax else Block
    if jax:
        ds = JDataset.open(src, engine="memmap", clock=_clock)
    else:
        ds = tio.Dataset.open(src, engine="memmap", clock=_clock,
                              device="cpu")
    path = str(tmp_path / f"{pkg}.jsonl")
    rec = (JRecorder if jax else tio.TraceRecorder)(
        path, (jheader if jax else tio.header_for_dataset)(
            ds, name="cap", seed=41, attrs={"gate_var": "T"}))
    ds.attach_trace(rec)
    for _ in range(2):
        for z in range(0, 32, 4):
            ds.read("T", B((0, 0, z), (32, 32, z + 2)))
        ds.read("T", B((8, 8, 8), (24, 24, 24)))
    ds.read_decomposed("T", B((0, 0, 0), SHAPE), (2, 2, 1))
    ds.read_pattern("T", "plane_xy", num_readers=2, slab_thickness=4)
    svc = (JService if jax else ReadService)(ds, window_s=0.25)
    R = JRequest if jax else Request
    with svc:
        svc.read_batch([R("a", "T", B((0, 0, 0), (16, 32, 32))),
                        R("b", "T", B((8, 0, 0), (24, 32, 8)))])
    layout = (jplan_layout if jax else plan_layout)(
        "chunked", [B((0, 0), (8, 16), owner=0, block_id=0),
                    B((8, 0), (16, 16), owner=1, block_id=1)],
        num_procs=2, global_shape=(16, 16))
    w = np.arange(256, dtype=np.float32).reshape(16, 16)
    data = {cp.chunk.block_id: w[cp.chunk.slices()] for cp in layout.chunks}
    if not jax:
        data = {k: to_tensor(v, "cpu") for k, v in data.items()}
    ds.write("W", layout, np.float32, data)
    policy = (JPolicy if jax else LayoutPolicy)(
        log=(JLog if jax else AccessLog)(src, clock=_clock),
        calibration=JCAL if jax else FALLBACK_CALIBRATION,
        cost_weighting=False)
    if jax:
        jreorganize(src, src, "T", "auto", engine="memmap", policy=policy,
                    now=T0, clock=_clock, trace=rec)
    else:
        tio.reorganize(src, src, "T", "auto", engine="memmap",
                       policy=policy, now=T0, clock=_clock, trace=rec,
                       device="cpu")
    ds.refresh()
    ds.read("T", B((0, 0, 0), (32, 32, 4)))
    kw = {} if jax else {"device": "cpu"}
    stager = (JStaging if jax else tio.StagingExecutor)(
        str(tmp_path / f"stage_{pkg}"), num_workers=1, engine="memmap",
        trace=rec, clock=_clock, **kw)
    for step in range(2):
        stager.submit(step, "W", np.float32, layout, data)
    stager.close()
    mgr = (JManager if jax else CheckpointManager)(
        str(tmp_path / f"ckpt_{pkg}"), keep=0, engine="memmap", trace=rec,
        clock=_clock, **kw)
    kv = np.random.default_rng(5).standard_normal((8, 16, 4)) \
        .astype(np.float32)
    tree = {"kv": kv, "n": np.zeros((), np.int64)}
    if not jax:
        tree = {k: to_tensor(v, "cpu") for k, v in tree.items()}
    halves = [B((0, 0, 0), (4, 16, 4), owner=0, block_id=0),
              B((4, 0, 0), (8, 16, 4), owner=1, block_id=1)]
    mgr.save(0, tree, block_map={"kv": halves})
    mgr.restore(0)
    mgr.restore(0, target_blocks={"kv": [
        B((0, 0, 0), (8, 8, 4), owner=0, block_id=0),
        B((0, 8, 0), (8, 16, 4), owner=1, block_id=1)]})
    ds.detach_trace()
    ds.close()
    rec.close()
    return path


#: event keys the run measures (``seconds``, ``predicted_seconds``, the
#: stamps) or, for a pattern read, the best-of-schemes sweep's timing picks
MEASURED = {"seconds", "predicted_seconds", "ts"}


def test_capture_through_hooks_equal_to_reference(tmp_path):
    _write_source(str(tmp_path / "src"))
    jpath = _capture(tmp_path, "jax")
    tpath = _capture(tmp_path, "torch")
    jt, tt = jload(jpath), tio.load_trace(tpath)
    jh, th = jt.header.to_json(), tt.header.to_json()
    jh.pop("created"), th.pop("created")
    assert th == jh
    assert len(tt.events) == len(jt.events) == 30
    kinds = [e.kind for e in tt.events]
    assert set(kinds) == set(jtrace.EVENT_KINDS)
    for je, te in zip(jt.events, tt.events):
        a = {k: v for k, v in je.to_json().items() if k not in MEASURED}
        b = {k: v for k, v in te.to_json().items() if k not in MEASURED}
        if te.kind == "read_pattern":
            # the best scheme is the fastest of the sweep, so a run's own:
            # the port's runs and groups are the reference planner's for
            # the scheme it picked
            ds = tio.Dataset.open(str(tmp_path / "src"), device="cpu",
                                  telemetry=False)
            from repro_torch.core.read_patterns import decompose_region
            plans = [ds.plan_read("T", p) for p in decompose_region(
                te.region, tuple(te.params["best_scheme"]))]
            assert (te.runs, te.groups) == \
                (sum(p.runs for p in plans), sum(p.num_groups
                                                 for p in plans))
            ds.close()
            for d in (a, b):
                for k in ("runs", "groups"):
                    d.pop(k, None)
                d["params"] = {k: v for k, v in d["params"].items()
                               if k != "best_scheme"}
        assert b == a, te.kind
    dec = next(e for e in tt.events if e.kind == "reorganize")
    assert dec.params["decision"]["scheme"]
