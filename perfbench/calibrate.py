"""The readings a cell's limits are set from, at the cell's own sizes, on
the card, in one process: the program's numbers on each of ``--seeds``
(a short window at the cell's load, long enough for the check's
sample), the control's (the reference with fp8 operands, ``CONTROL``,
in the program's place) on ``--control-seeds``, and each planted
fault's (``harness/faults.py``) on ``--fault-seeds``.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--faults half_batch --fault-seeds 1,2,3] \
        [--out readings.jsonl]

One JSON line a reading, on standard output and in ``--out``.  The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry

CONTROL = "float8"


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = "cuda"
    entry._environment()
    import torch
    from harness import check, faults, spec
    from harness.entries import ENTRIES
    bench = spec.load()
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])

    def emit(**rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def program(seed, fault=None, control=False):
        """The program's numbers on ``seed`` and, with ``control``, the
        control's against the same reference."""
        t0 = time.perf_counter()
        with faults.plant(fault):
            run = ENTRIES[mix["entry"]](cfg, mix, seed, args.seconds, False,
                                        device, t0)
        m = cfg["model"]
        low = None
        if run.check["kind"] == "train":
            ref = check.train_reference(m, mix["optimizer"], seed,
                                        run.check["batches"], device)
            nums = check.train_numbers(run.check, ref)
            nums["worst"] = check.worst_leaves(run.check, ref)
            if control:
                low = check.train_numbers(check.train_reference(
                    m, mix["optimizer"], seed, run.check["batches"],
                    device, CONTROL), ref)
        else:
            sample = check.serve_sample(run.check["served"], seed,
                                        mix["check"]["requests"])
            rows = mix["check"]["rows"]
            nums = check.serve_numbers(m, seed, sample, rows, device)
            if control:
                low = check.serve_numbers(m, seed, sample, rows, device,
                                          CONTROL)
        return run, nums, low, time.perf_counter() - t0

    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        run, nums, low, s = program(seed, control=seed in args.control_seeds)
        if seed in args.seeds:
            emit(kind="program", seed=seed, numbers=nums, seconds=s,
                 units=run.units, setup_s=run.setup_s)
        if low is not None:
            emit(kind="control", seed=seed, precision=CONTROL,
                 numbers=low)
    for fault in filter(None, args.faults.split(",")):
        for seed in args.fault_seeds:
            _, nums, _, s = program(seed, fault)
            emit(kind="fault", fault=fault, seed=seed, numbers=nums,
                 seconds=s)
    emit(kind="device", name=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
