"""Online vs post-hoc layout reorganization, end to end (paper Section 5),
with the producer's output on the card.

A producer loop emits one output per "computation phase": it writes the
write-optimized layout directly and hands the same blocks to a staging
executor, which snapshots them on the card and assembles the reorganized
layout there while the producer computes; a post-hoc pass then does the
same work after the fact.  Both paths are measured, the Section-5.2 model
decides, and the restore-style reads show the payoff.

Run:        PYTHONPATH=src python -m repro_torch.examples.layout_reorg_demo
Fast check: PYTHONPATH=src python -m repro_torch.examples.layout_reorg_demo \
                --tiny --device cpu
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..core import (StagingTimings, plan_layout, simulate_load_balance,
                    uniform_grid_blocks)
from ..core.blocks import Block
from ..core.reorg import decide
from ..device import resolve_device
from ..interop import tensors_from_numpy
from ..io import Dataset, StagingExecutor, reorganize

N_OUTPUTS = 4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="32^3 field, 0.05 s phases (CI)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    glob, box, t_c = ((32, 32, 32), (8, 8, 8), 0.05) if args.tiny \
        else ((128, 128, 128), (32, 32, 32), 0.4)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    blocks = simulate_load_balance(uniform_grid_blocks(glob, box),
                                   num_procs=8, seed=2)
    tmp = tempfile.mkdtemp()
    try:
        run(tmp, glob, blocks, t_c, rng, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(tmp: str, glob, blocks, t_c: float, rng, dev) -> None:
    # -- producer writes write-optimized + stages reorganized copies -------
    direct_plan = plan_layout("subfiled_fpp", blocks, num_procs=8,
                              global_shape=glob)
    reorg_plan = plan_layout("reorganized", blocks, num_procs=8,
                             global_shape=glob, reorg_scheme=(2, 2, 2),
                             num_stagers=2)
    stager = StagingExecutor(os.path.join(tmp, "staged"), num_workers=2,
                             device=dev)
    t_w_direct = []
    for step in range(N_OUTPUTS):
        data = tensors_from_numpy(
            {b.block_id: rng.standard_normal(b.shape).astype(np.float32)
             for b in blocks}, dev)
        time.sleep(t_c)                                   # the simulation
        dds = Dataset.create(os.path.join(tmp, f"direct_{step}"),
                             engine="pread", device=dev)
        ws = dds.write_planned(dds.plan_write("B", direct_plan, np.float32),
                               data)
        dds.close()
        t_w_direct.append(ws.total_seconds)
        stall = stager.submit(step, "B", np.float32, reorg_plan, data)
        print(f"step {step}: direct write {ws.total_seconds:.3f}s, "
              f"staging stall {stall:.3f}s")
    results = stager.drain()
    stager.close()
    failed = [r for r in results if r.error]
    if failed:
        raise RuntimeError(f"staging failed: {failed[0].error}")

    # -- post-hoc reorganization of the last output -------------------------
    t0 = time.perf_counter()
    _, pds, _ = reorganize(os.path.join(tmp, f"direct_{N_OUTPUTS - 1}"),
                           os.path.join(tmp, "posthoc"), "B", reorg_plan,
                           device=dev)
    pds.close()
    posthoc_s = time.perf_counter() - t0

    t = StagingTimings(
        t_s=float(np.mean([r.t_s for r in results])),
        t_w_stage=float(np.mean([r.t_w for r in results])),
        t_w_sim=float(np.mean(t_w_direct)),
        t_r_stage=posthoc_s / 2, n=8, m=2)
    d = decide(t, t_c, N_OUTPUTS)
    print(f"\nmeasured: t_s={t.t_s:.3f}s t_w_stage={t.t_w_stage:.3f}s "
          f"t_w_sim={t.t_w_sim:.3f}s posthoc={posthoc_s:.3f}s")
    print(f"decision for t_c={t_c}s, N={N_OUTPUTS}: {d.mode} "
          f"(U_o={d.utilization_on_the_fly:.1f} vs "
          f"U_p={d.utilization_post_hoc:.1f} node-seconds; "
          f"blocking={d.blocking})")

    # -- the payoff: restore-style reads -----------------------------------
    whole = Block((0,) * len(glob), glob)
    outs = {}
    for name, path, var in (
            ("write-optimized", f"direct_{N_OUTPUTS - 1}", "B"),
            ("reorganized(post-hoc)", "posthoc", "B"),
            ("reorganized(staged)", "staged", f"B@{N_OUTPUTS - 1}")):
        ds = Dataset(os.path.join(tmp, path), device=dev)
        outs[name], st = ds.read(var, whole)
        ds.close()
        print(f"restore read [{name:22s}]: {st.seconds * 1e3:6.1f} ms, "
              f"chunks={st.chunks_touched}, seeks~{st.runs}")
    first = next(iter(outs.values()))
    if not all(torch.equal(first, o) for o in outs.values()):
        raise RuntimeError("the three layouts read back differently")


if __name__ == "__main__":
    main()
