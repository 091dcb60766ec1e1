"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``), one run of
one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, also the last lines of standard
error).  Exits non-zero, printing no result, without as many CUDA
devices as the cell asks for, or if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the run is over.  Caches go under
``build/perfbench/`` in the checkout; nothing else is written but a
temporary file under ``TMPDIR`` while a trace is read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in BANNED})


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv) -> int:
    args = parse(argv)
    _environment()
    from harness import spec
    bench = spec.load()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from harness.run import run_cell
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
