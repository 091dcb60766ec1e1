"""The port's distributed reorganization under the multi-process kill
matrix: real worker processes (``repro_torch.distributed.reorg.
worker_main`` on ``device="cpu"``) SIGKILLed while parked at each of the
four crash points, then a fleet restarted by ``distributed_reorganize``
adopting the journal.  The destination must be absent after the kill and,
once committed, bit-identical to the JAX package's single-process
``reorganize`` of a copy of the source.  The elastic shrink and the
compressed source are in ``test_torch_kill_matrix_elastic.py`` (one file
each keeps an xdist worker under a minute).  Every wait has a deadline."""

import hashlib
import json
import multiprocessing as mp
import os
import shutil
import signal
import time

import numpy as np
import pytest

import repro.core as jc
import repro.io as jio

from repro_torch.core.blocks import Block
from repro_torch.distributed.reorg import (BARRIERS, distributed_reorganize,
                                           worker_main)
from repro_torch.io import (Dataset, ReorgJournal, build_write_plan,
                            choose_reorg_layout)
from repro_torch.io.journal import REORG_JOURNAL_NAME

GLOBAL = (32, 32, 32)
WAIT_S = 60.0


def world(seed=7, nprocs=4):
    blocks = jc.simulate_load_balance(
        jc.uniform_grid_blocks(GLOBAL, (8, 8, 8)), num_procs=nprocs,
        seed=seed)
    rng = np.random.default_rng(seed)
    data = {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
            for b in blocks}
    ref = np.zeros(GLOBAL, np.float32)
    for b in blocks:
        ref[b.slices()] = data[b.block_id]
    return blocks, data, ref


def write_src(tmp_path, blocks, data, codec="none"):
    """The source, written by the JAX package under ``subfiled_fpp``."""
    src = str(tmp_path / "src")
    ds = jio.Dataset.create(src)
    ds.write("B", jc.plan_layout("subfiled_fpp", blocks, num_procs=4,
                                 global_shape=GLOBAL), np.float32, data,
             codec=codec)
    ds.close()
    return src


def dir_hashes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def reference(tmp_path, src):
    """The JAX package's single-process ``reorganize`` of a byte-identical
    copy of the source: the bit-identity oracle for the port's fleet."""
    src2 = str(tmp_path / "src_ref")
    shutil.copytree(src, src2)
    refdst = str(tmp_path / "dst_ref")
    _, ds, _ = jio.reorganize(src2, refdst, "B", layout="auto",
                              engine="pread")
    ds.close()
    return refdst


def assert_bit_identical(d_ref, d):
    bins = sorted(f for f in os.listdir(d_ref) if f.endswith(".bin"))
    assert bins == sorted(f for f in os.listdir(d) if f.endswith(".bin"))
    ha, hb = dir_hashes(d_ref), dir_hashes(d)
    for f in bins:
        assert ha[f] == hb[f], f
    with open(os.path.join(d_ref, "index.json")) as f:
        ja = json.load(f)
    with open(os.path.join(d, "index.json")) as f:
        jb = json.load(f)
    assert ja["chunks"] == jb["chunks"]      # extents, offsets AND crcs
    assert ja["variables"] == jb["variables"]
    assert ja["generation"] == jb["generation"]


def wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def arm_barrier(tmp_path, armed):
    """A barrier dir where only ``armed`` parks workers."""
    bdir = str(tmp_path / "barriers")
    os.makedirs(bdir, exist_ok=True)
    for name in BARRIERS:
        if name != armed:
            with open(os.path.join(bdir, f"go.{name}"), "w"):
                pass
    return bdir


def reached(bdir, name):
    return [f for f in os.listdir(bdir) if f.endswith(f".{name}.reached")]


def make_journal(src, dst, *, num_units, lease_timeout_s):
    """The coordinator's journal-creation path, inlined so the test owns
    the fleet (and can SIGKILL all of it)."""
    sds = Dataset.open(src, engine="pread", telemetry=False, device="cpu")
    decision = choose_reorg_layout(sds, "B")
    dtype = sds.index.var_dtype("B")
    sds.close()
    plan = build_write_plan(decision.layout, "B", dtype)
    ReorgJournal.create(dst, plan, src, num_units=num_units,
                        lease_timeout_s=lease_timeout_s,
                        attrs={"var": "B", "engine": "pread",
                               "policy": decision.to_json()})


def kill_fleet_at(dst, bdir, barrier, names=("k0", "k1")):
    """Spawn workers on ``dst``'s journal, wait for one to park at
    ``barrier``, then SIGKILL the whole fleet."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker_main, args=(dst, w, "pread"),
                         kwargs={"barrier_dir": bdir, "device": "cpu"},
                         daemon=True) for w in names]
    for p in procs:
        p.start()
    try:
        wait_for(lambda: reached(bdir, barrier), WAIT_S,
                 f"a worker parked at {barrier}")
        for p in procs:                    # whole-fleet death, no cleanup
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
        for p in procs:
            p.join(timeout=10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    assert not any(p.is_alive() for p in procs)


def restart_and_check(src, dst, refdst, ref, src_before):
    """The crash invariant, then a fresh fleet adopting the journal and
    converging to the oracle."""
    assert not os.path.exists(os.path.join(dst, "index.json"))
    assert os.path.exists(os.path.join(dst, REORG_JOURNAL_NAME))
    assert dir_hashes(src) == src_before
    ds, stats = distributed_reorganize(src, dst, "B", num_workers=2,
                                       engine="pread", device="cpu",
                                       round_timeout_s=WAIT_S)
    try:
        got, _ = ds.read("B", Block((0, 0, 0), GLOBAL))
    finally:
        ds.close()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert_bit_identical(refdst, dst)
    assert not os.path.exists(os.path.join(dst, REORG_JOURNAL_NAME))
    assert stats["validation_failures"] == 0 and stats["rounds"] >= 1
    return stats


@pytest.mark.parametrize("barrier", BARRIERS)
def test_fleet_sigkill_then_restart_converges(tmp_path, barrier):
    blocks, data, ref = world()
    src = write_src(tmp_path, blocks, data)
    refdst = reference(tmp_path, src)
    src_before = dir_hashes(src)
    dst = str(tmp_path / "dst")
    bdir = arm_barrier(tmp_path, barrier)
    make_journal(src, dst, num_units=4, lease_timeout_s=1.0)
    kill_fleet_at(dst, bdir, barrier)
    restart_and_check(src, dst, refdst, ref, src_before)
