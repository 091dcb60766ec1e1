"""Trace replay on the port: every committed trace, replayed through the
port's stack on the CPU (the plain versions of the card's kernels), gives
the JAX package's digest — read bytes, policy decision audits and final
index and manifest tables — with the same event counts, verified bytes
and decisions; replays are deterministic under every engine, at reduced
scale too; ``engine="auto"`` is refused and a divergence is caught; and a
captured trace exported as a prior warms a cold policy to the live
decision."""

import dataclasses
import os
import time

import numpy as np
import pytest

from repro.io import load_trace as jload
from repro.io import replay_trace as jreplay

import repro_torch.io as tio
from repro_torch.core.blocks import Block, uniform_grid_blocks
from repro_torch.core.cost_model import FALLBACK_CALIBRATION
from repro_torch.core.layouts import plan_layout
from repro_torch.core.policy import AccessLog, LayoutPolicy, \
    load_prior_records

TRACES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traces")
CORPUS = sorted(f[:-6] for f in os.listdir(TRACES_DIR)
                if f.endswith(".jsonl"))
#: the JAX package's replay digests of the committed corpus (prefixes)
DIGESTS = {"dims_large": "71b2aafd", "dims_small": "b5b20f28",
           "mixed_rw_small": "500c4066", "pic_slab_large": "eb1c643d",
           "pic_slab_small": "ca86ed22", "restore_storm_small": "be6a955e",
           "serve_paged_small": "7731084c"}
SHAPE = (32, 32, 32)


def _same(t, j):
    assert t.digest == j.digest
    assert t.counts == j.counts
    assert t.bytes_verified == j.bytes_verified > 0
    assert t.decisions == j.decisions
    assert t.clock_end == j.clock_end
    assert t.events == j.events


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_replays_to_the_reference_digest(tmp_path, name):
    path = os.path.join(TRACES_DIR, f"{name}.jsonl")
    j = jreplay(jload(path), str(tmp_path / "j"))
    t = tio.replay_trace(tio.load_trace(path), str(tmp_path / "t"),
                         device="cpu")
    _same(t, j)
    assert t.digest.startswith(DIGESTS[name])


def test_scaled_large_trace_replays_to_the_reference_digest(tmp_path):
    path = os.path.join(TRACES_DIR, "pic_slab_large.jsonl")
    j = jreplay(jload(path).scaled(2), str(tmp_path / "j"))
    half = tio.load_trace(path).scaled(2)
    t = tio.replay_trace(half, str(tmp_path / "t"), device="cpu")
    _same(t, j)
    assert t.counts["reorganize"] == 1
    assert tuple(half.header.variables["T"]["shape"]) == (48, 48, 48)


def _capture(tmp_path, *, with_reorg=True) -> str:
    """A slab-skewed workload captured through the port's hooks."""
    src = os.path.join(str(tmp_path), "capture_src")
    ds = tio.Dataset.create(src, engine="memmap", device="cpu")
    blocks = [b.with_owner(i % 8) for i, b in
              enumerate(uniform_grid_blocks(SHAPE, (16, 16, 16)))]
    layout = plan_layout("subfiled_fpp", blocks, num_procs=8,
                         global_shape=SHAPE)
    arr = np.random.default_rng(41).standard_normal(SHAPE) \
        .astype(np.float32)
    ds.write("T", layout, np.float32,
             {cp.chunk.block_id: arr[cp.chunk.slices()]
              for cp in layout.chunks})
    path = os.path.join(str(tmp_path), "capture.jsonl")
    rec = tio.TraceRecorder(path, tio.header_for_dataset(
        ds, name="cap", seed=41, attrs={"gate_var": "T"}))
    ds.attach_trace(rec)
    for _ in range(2):
        for z in range(0, 32, 4):
            ds.read("T", Block((0, 0, z), (32, 32, z + 2)))
        ds.read("T", Block((8, 8, 8), (24, 24, 24)))
    ds.read_decomposed("T", Block((0, 0, 0), SHAPE), (2, 2, 1))
    ds.read_pattern("T", "plane_xy", num_readers=2, slab_thickness=4)
    if with_reorg:
        tio.reorganize(src, src, "T", "auto", engine="memmap", trace=rec,
                       device="cpu")
        ds.refresh()
        ds.read("T", Block((0, 0, 0), (32, 32, 4)))
    ds.detach_trace()
    ds.close()
    rec.close()
    return path


@pytest.mark.parametrize("engine", ["memmap", "pread", "overlapped",
                                    "uring", "odirect"])
def test_replay_deterministic_per_engine(tmp_path, engine):
    """Two port replays and the JAX package's replay of one captured trace,
    under each engine (the kernel-bypass ones run where the host has them
    and degrade as documented elsewhere): one digest, one decision audit."""
    path = _capture(tmp_path)
    trace = tio.load_trace(path)
    r1 = tio.replay_trace(trace, str(tmp_path / "rp1"), engine=engine,
                          device="cpu")
    r2 = tio.replay_trace(trace, str(tmp_path / "rp2"), engine=engine,
                          device="cpu")
    j = jreplay(jload(path), str(tmp_path / "rpj"), engine=engine)
    assert r1.digest == r2.digest
    assert r1.decisions == r2.decisions and r1.decisions
    assert r1.bytes_verified == r2.bytes_verified > 0
    assert r1.clock_end == r2.clock_end
    _same(r1, j)


def test_replay_rejects_auto_engine(tmp_path):
    trace = tio.load_trace(_capture(tmp_path, with_reorg=False))
    with pytest.raises(ValueError, match="pinned engine"):
        tio.replay_trace(trace, str(tmp_path / "rp"), engine="auto",
                         device="cpu")


def test_replay_catches_divergence(tmp_path):
    """The oracle check is live: a read past the materialized geometry
    cannot replay silently, and neither can a stored byte changed under
    the replay."""
    trace = tio.load_trace(_capture(tmp_path, with_reorg=False))
    tio.replay_trace(trace, str(tmp_path / "rp"), device="cpu")
    ev = next(e for e in trace.events if e.kind == "read")
    bad = dataclasses.replace(trace, events=[dataclasses.replace(
        ev, hi=tuple(h + 32 for h in ev.hi))])
    with pytest.raises(Exception):
        tio.replay_trace(bad, str(tmp_path / "rp_bad"), device="cpu")

    class Flip(tio.MemmapEngine):
        def read_plan(self, plan, store, out):
            super().read_plan(plan, store, out)
            out.reshape(-1).view(np.uint8)[:1] ^= 1

    with pytest.raises(tio.ReplayError, match="diverge from oracle"):
        tio.replay_trace(trace, str(tmp_path / "rp_flip"), engine=Flip(),
                         device="cpu")


def test_trace_prior_matches_live_decision(tmp_path):
    path = _capture(tmp_path, with_reorg=False)
    trace = tio.load_trace(path)
    src = os.path.join(str(tmp_path), "capture_src")
    now = time.time() + 1.0
    ds = tio.Dataset.open(src, telemetry=False, device="cpu")
    rows = ds.index.var_rows("T")
    blocks = [Block(tuple(int(v) for v in rows.los[i]),
                    tuple(int(v) for v in rows.his[i]),
                    owner=int(rows.subfiles[i]), block_id=i)
              for i in range(rows.n)]
    ds.close()
    live = LayoutPolicy(log=AccessLog(src, clock=lambda: now),
                        calibration=FALLBACK_CALIBRATION) \
        .choose_layout("T", blocks, SHAPE, now=now)
    assert live.num_records > 0
    prior_records = load_prior_records(
        trace.export_prior(str(tmp_path / "prior.json"), now=now), now=now)
    assert len(prior_records) == sum(
        1 for e in trace.events
        if e.kind in ("read", "read_decomposed", "read_pattern", "serve"))
    cold = LayoutPolicy(prior_records=prior_records,
                        calibration=FALLBACK_CALIBRATION) \
        .choose_layout("T", blocks, SHAPE, now=now)
    assert cold.num_prior_records == len(prior_records)
    assert (cold.strategy, cold.scheme) == (live.strategy, live.scheme)
    unwarmed = LayoutPolicy(calibration=FALLBACK_CALIBRATION) \
        .choose_layout("T", blocks, SHAPE, now=now)
    assert unwarmed.num_records == 0
