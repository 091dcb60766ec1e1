"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes in a fake world, and record per-device memory, the
op-level cost analysis and the collective schedule.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out dryrun_results.json [--device cpu]
      [--remat none|dots|full]

Each mesh runs in worker processes (``--jobs``), each holding one fake
process group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``) of the mesh's size as its rank 0: collectives return at once,
and every tensor is a fake one (``FakeTensorMode``), so a cell allocates
nothing.  A cell's step runs once under an ``OpCounter``
(``launch/op_analysis.py``: the flops, bytes and collectives this rank
dispatches, and the bytes its storages hold alive: arguments, outputs,
temporaries).  A sharding mismatch or an op without a fake
implementation here is a bug in the port.

The records keep the JAX package's keys.  Those only XLA gives have no
counterpart: ``compile_seconds`` and ``xla_reported_*`` are null,
``while_trips`` is ``{}`` (eager code runs each loop iteration as ops of
its own).  ``lower_seconds`` is the fake trace's.

The roofline's constants are the NVIDIA H100 SXM's data-sheet values,
never measured here: 989.4 TFLOP/s dense bf16, 3.35 TB/s of HBM3,
NVLink at 450 GB/s a direction between the 8 GPUs of a node, and a 400
Gb/s NIC a GPU (50 GB/s) for a collective whose group spans nodes (ranks
fill nodes of ``GPUS_PER_NODE`` in order).  On the (16, 16) and
(2, 16, 16) meshes every axis has 16 or more ranks or a stride of 16, so
every collective there is charged at the NIC's rate; the small test
meshes stay within one node (NVLink).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

__all__ = ["run_cell", "trace", "main", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
           "NIC_BW", "GPUS_PER_NODE"]

# H100 SXM data sheet (dense, per GPU)
PEAK_FLOPS = 989.4e12        # bf16
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s a direction, within a node
NIC_BW = 400e9 / 8           # bytes/s: one 400 Gb/s NIC a GPU
GPUS_PER_NODE = 8


def _link(group_ranks) -> str:
    """``"nvlink"`` where a group's ranks share one node, else ``"nic"``."""
    nodes = {r // GPUS_PER_NODE for r in group_ranks}
    return "nvlink" if len(nodes) <= 1 else "nic"


def _tensor_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    from ..distributed.sharding import is_dtensor
    total = 0
    for t in tree_flatten(tree)[0]:
        if hasattr(t, "numel"):
            loc = t.to_local() if is_dtensor(t) else t
            total += loc.numel() * loc.element_size()
    return total


def _storages(tree) -> set:
    from torch.utils._pytree import tree_flatten
    from ..distributed.sharding import is_dtensor
    out = set()
    for t in tree_flatten(tree)[0]:
        if hasattr(t, "untyped_storage"):
            loc = t.to_local() if is_dtensor(t) else t
            out.add(id(loc.untyped_storage()))
    return out


def trace(cell) -> tuple:
    """Run ``cell``'s step once under its fake mode: ``(counter,
    memory)``, the ``OpCounter`` of its ops and the reference's memory
    keys from the counter's live bytes (their peak, and the arguments,
    outputs and the outputs that alias the donated arguments)."""
    from torch.utils._pytree import tree_flatten
    from ..distributed.sharding import is_dtensor
    from .op_analysis import OpCounter
    counter = OpCounter()
    counter.track(*tree_flatten(cell.args)[0])
    with cell.fake_mode, counter:
        out = cell.fn(*cell.args)
    peak = counter.peak
    arg_b = _tensor_bytes(cell.args)
    out_b = _tensor_bytes(out)
    donated = _storages([cell.args[i] for i in cell.donate])
    alias_b = _tensor_bytes([t for t in tree_flatten(out)[0]
                             if hasattr(t, "untyped_storage") and id(
                                 (t.to_local() if is_dtensor(t) else t)
                                 .untyped_storage()) in donated])
    return counter, {
        "argument_bytes_per_dev": arg_b,
        "output_bytes_per_dev": out_b,
        "temp_bytes_per_dev": max(peak - arg_b - out_b + alias_b, 0),
        "alias_bytes_per_dev": alias_b,
        "peak_bytes_per_dev": max(peak, arg_b + out_b - alias_b),
    }


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
             zero1: bool = False, overrides: dict | None = None,
             variant: str = "baseline", cfg=None, shape=None) -> dict:
    """One cell's record on ``mesh`` (a ``DeviceMesh`` of a fake world,
    whose device type the cell's fake tensors take); ``cfg`` and
    ``shape`` replace the registered config and shape cell (tests pass
    smoke ones)."""
    import torch.distributed as dist
    from ..configs import get_config, skip_reason
    from ..distributed import sharding as shd
    from .specs import build_cell
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if tuple(mesh.shape) not in ((16, 16), (2, 16, 16)):
        rec["mesh"] = "x".join(str(s) for s in mesh.shape)
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    base = cfg or get_config(arch)
    rules = dict(shd.FSDP_RULES if base.fsdp else shd.DEFAULT_RULES)
    t0 = time.time()
    try:
        with shd.use_sharding(mesh, rules):
            cell = build_cell(arch, shape_name, zero1=zero1,
                              overrides=dict(overrides or {}),
                              device=mesh.device_type, cfg=cfg,
                              shape=shape)
            counter, memory = trace(cell)
            t_lower = time.time() - t0
        c = counter.cost
        colls = {k: {"count": v["count"], "bytes": v["bytes"]}
                 for k, v in c.collectives.items() if v["count"]}
        colls["total_bytes"] = c.collective_bytes
        colls["total_count"] = sum(v["count"] for v in
                                   c.collectives.values())
        by_link = {"nvlink": 0.0, "nic": 0.0}
        for name, nbytes in counter.by_group.items():
            by_link[_link(dist.get_process_group_ranks(_group(name)))
                    if name != "?" else "nic"] += nbytes
        nchips = mesh.size()
        flops_dev, bytes_dev = float(c.flops), float(c.bytes)
        rec.update({
            "status": "ok",
            "lower_seconds": round(t_lower, 2),
            "compile_seconds": None,
            "chips": nchips,
            "memory": memory,
            "hlo_flops_per_dev": flops_dev,
            "hlo_bytes_per_dev": bytes_dev,
            "xla_reported_flops_per_dev": None,
            "xla_reported_bytes_per_dev": None,
            "while_trips": {},
            "collectives": colls,
            "collective_bytes_by_link": by_link,
            "model_flops": cell.model_flops,
            "roofline": {
                "compute_s": flops_dev / PEAK_FLOPS,
                "memory_s": bytes_dev / HBM_BW,
                "collective_s": by_link["nvlink"] / NVLINK_BW
                + by_link["nic"] / NIC_BW,
            },
        })
        r = rec["roofline"]
        r["dominant"] = max(r, key=r.get)
        total = flops_dev * nchips
        rec["useful_flop_ratio"] = cell.model_flops / total if total \
            else None
    except Exception as e:       # noqa: BLE001 - record, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


# -- the fake world of a worker process --------------------------------------

_WORLD: dict = {}


def start_fake_world(multi_pod: bool, device: str):
    """This process as rank 0 of a fake world of the production mesh's
    size, and that mesh (``launch/mesh.make_production_mesh``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from .mesh import make_production_mesh
    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    _WORLD["mesh"] = make_production_mesh(multi_pod=multi_pod,
                                          device=device)
    _WORLD["multi_pod"] = multi_pod
    return _WORLD["mesh"]


def _task(arch, shape_name, zero1, overrides, variant) -> dict:
    return run_cell(arch, shape_name, _WORLD["mesh"], _WORLD["multi_pod"],
                    zero1=zero1, overrides=overrides, variant=variant)


def _print(mesh_name: str, rec: dict) -> None:
    arch, shape_name, status = rec["arch"], rec["shape"], rec["status"]
    if status == "ok":
        print(f"[{mesh_name}] {arch} x {shape_name}: OK "
              f"trace={rec['lower_seconds']}s "
              f"dom={rec['roofline']['dominant']}", flush=True)
        print("  memory:", rec["memory"], flush=True)
        print("  cost: flops/dev=%.3e bytes/dev=%.3e"
              % (rec["hlo_flops_per_dev"], rec["hlo_bytes_per_dev"]),
              flush=True)
    elif status == "skip":
        print(f"[{mesh_name}] {arch} x {shape_name}: SKIP "
              f"({rec['reason']})", flush=True)
    else:
        print(f"[{mesh_name}] {arch} x {shape_name}: ERROR "
              f"{rec['error']}", flush=True)


def main(argv=None) -> None:
    from concurrent.futures import ProcessPoolExecutor, as_completed
    import multiprocessing as mp
    from ..configs import list_archs, shapes_for
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="the flash-attention kernels (as custom ops)")
    ap.add_argument("--moe-local", action="store_true",
                    help="local-expert-slice MoE dispatch")
    ap.add_argument("--remat", default=None, choices=["none", "dots", "full"],
                    help="the remat policy instead of the config's")
    ap.add_argument("--variant", default=None,
                    help="variant label recorded with each cell")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (cuda or cpu)")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="worker processes, each a fake world")
    args = ap.parse_args(argv)

    overrides = {}
    if args.flash:
        overrides["flash"] = True
    if args.moe_local:
        overrides["moe_dispatch"] = "local"
    if args.remat:
        overrides["remat"] = args.remat
    variant = args.variant or ("baseline" if not overrides else "+".join(
        k if k != "remat" else f"remat={args.remat}"
        for k in sorted(overrides)))

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"],
             r.get("variant", "baseline")) for r in results}

    t0 = time.time()
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        todo = [(arch, s) for arch in archs
                for s in ([c.name for c in shapes_for(arch)]
                          if args.shape == "all" else args.shape.split(","))
                if (arch, s, mesh_name, variant) not in done]
        if not todo:
            continue
        # a fake world per worker process: one cannot start beside another
        with ProcessPoolExecutor(
                max_workers=max(1, min(args.jobs, len(todo))),
                mp_context=mp.get_context("spawn"),
                initializer=start_fake_world,
                initargs=(multi_pod, args.device)) as pool:
            jobs = [pool.submit(_task, arch, s, args.zero1, overrides,
                                variant) for arch, s in todo]
            for job in as_completed(jobs):
                rec = job.result()
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                _print(mesh_name, rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"dry-run complete: {n_ok} ok, {n_skip} documented skips, "
          f"{n_err} errors in {time.time() - t0:.1f} s", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
