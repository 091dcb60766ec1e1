"""The port's distributed reorganization, the rest of the kill matrix: an
elastic 2 -> 1 shrink (one of two workers SIGKILLed mid-fleet, its death
journaled by the coordinator's heartbeat monitor, the survivor converging
alone) and a compressed source (the workers' gathers take the host route
and decode; a mid-write fleet kill, then a restarted fleet).  Each
destination bit-identical to the JAX package's single-process
``reorganize`` of a copy of the source.  Every wait has a deadline."""

import os
import signal
import threading

import numpy as np

from repro_torch.core.blocks import Block
from repro_torch.distributed.reorg import distributed_reorganize
from repro_torch.io import ReorgJournal
from repro_torch.io.journal import REORG_JOURNAL_NAME

from test_torch_kill_matrix import (GLOBAL, WAIT_S, arm_barrier,
                                    assert_bit_identical, dir_hashes,
                                    kill_fleet_at, make_journal, reached,
                                    reference, restart_and_check, wait_for,
                                    world, write_src)


def test_elastic_shrink_two_to_one_converges(tmp_path):
    blocks, data, ref = world(seed=13)
    src = write_src(tmp_path, blocks, data)
    refdst = reference(tmp_path, src)
    dst = str(tmp_path / "dst")
    bdir = arm_barrier(tmp_path, "mid_gather")
    journal = ReorgJournal(dst)
    result = {}

    def run():
        ds, stats = distributed_reorganize(
            src, dst, "B", num_workers=2, units_per_worker=2,
            engine="pread", lease_timeout_s=2.0, round_timeout_s=WAIT_S,
            barrier_dir=bdir, device="cpu")
        try:
            result["arr"], _ = ds.read("B", Block((0, 0, 0), GLOBAL))
        finally:
            ds.close()
        result["stats"] = stats

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        wait_for(lambda: reached(bdir, "mid_gather"), WAIT_S,
                 "a worker parked at mid_gather")
        marker = sorted(reached(bdir, "mid_gather"))[0]
        victim = marker.split(".")[0]
        with open(os.path.join(bdir, marker)) as f:
            os.kill(int(f.read()), signal.SIGKILL)

        def death_recorded():
            try:
                events = journal.load()["events"]
            except (OSError, ValueError):
                return False
            return any(e.get("event") == "worker_dead"
                       and e.get("worker") == victim for e in events)

        # the coordinator's heartbeat monitor notices the silent worker and
        # journals the rescale decision while the survivor is still parked
        wait_for(death_recorded, WAIT_S, "the worker's death to be journaled")
        with open(os.path.join(bdir, "go.mid_gather"), "w"):
            pass
    finally:
        t.join(timeout=2 * WAIT_S)
    assert not t.is_alive(), "elastic fleet did not converge"

    np.testing.assert_array_equal(result["arr"].numpy(), ref)
    assert_bit_identical(refdst, dst)
    deaths = [e for e in result["stats"]["events"]
              if e["event"] == "worker_dead"]
    assert [d["worker"] for d in deaths] == [victim]
    assert "(2, 1) -> (1, 1)" in deaths[0]["rescale"]  # the N-1 decision
    assert result["stats"]["rounds"] == 1          # the survivor, same fleet
    assert not os.path.exists(os.path.join(dst, REORG_JOURNAL_NAME))


def test_fleet_sigkill_mid_write_compressed_source(tmp_path):
    """A zlib source: every unit's gather decodes on the host route, the
    journal's CRCs are over the stored bytes written; a mid-write fleet
    kill leaves the source untouched and a restarted fleet converges."""
    blocks, data, ref = world(seed=31)
    src = write_src(tmp_path, blocks, data, codec="zlib")
    refdst = reference(tmp_path, src)
    src_before = dir_hashes(src)
    dst = str(tmp_path / "dst")
    bdir = arm_barrier(tmp_path, "mid_write")
    make_journal(src, dst, num_units=4, lease_timeout_s=1.0)
    kill_fleet_at(dst, bdir, "mid_write")
    restart_and_check(src, dst, refdst, ref, src_before)
