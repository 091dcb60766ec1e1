#!/usr/bin/env python3
"""Per-device memory of mamba2-780m's cells on meshes (1, 1) and (1, 2):
the SSD scan splits over the data axes only, so its heads stay whole on
every model rank; the dry run (``launch/dryrun.run_cell``) gives the
per-device peak on each mesh, each in a fake world of its own size.

    PYTHONPATH=src python3 tools/ssd_mesh_memory.py [--device cpu] [shape ...]

One JSON line a (mesh, shape): the record's memory, flops and trace
seconds (default shapes: train_4k and prefill_32k at their registered
sizes; the card's machine: fake tensors allocate nothing).
"""
import argparse
import json
import multiprocessing as mp
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
ARCH = "mamba2-780m"


def one(shape, cell, device):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    rec = run_cell(ARCH, cell, make_mesh(shape, ("data", "model"), device),
                   False)
    rec.pop("traceback", None)
    return {"mesh": list(shape), **{k: rec.get(k) for k in (
        "shape", "status", "error", "lower_seconds", "memory",
        "hlo_flops_per_dev")}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("shapes", nargs="*",
                    default=["train_4k", "prefill_32k"])
    args = ap.parse_args()
    jobs = [((1, 1), s) for s in args.shapes] + \
        [((1, 2), s) for s in args.shapes]
    with mp.get_context("spawn").Pool(len(jobs)) as pool:
        for rec in pool.starmap(one, [(m, s, args.device) for m, s in jobs]):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
