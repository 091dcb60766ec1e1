#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device probe (torch, CUDA, nvcc, card, power limit);
1. kernel build from ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a);
2. every kernel against its plain PyTorch version on the card, bit-exact:
   the unit sweeps, the main path's shapes, and the 3-D merge world;
3. the main path at full size: a WarpX-style 2-D field output step (six
   8192 x 8192 f32 components in 256 x 256 blocks over 48 load-balanced
   processes) written through ``Dataset.write`` and read back through
   ``Dataset.read`` under ``merged_process`` and ``reorganized``, each
   component compared with its source, plus one partial-region read;
4. kernel times at the main path's shapes (CUDA events, median of 20),
   beside the memory-bandwidth bound, the plain version and one PyTorch
   call computing the same function;
5. launch counts of the main-path run; every kernel must have run.

The last lines are the kernel summary, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

FIELD = (8192, 8192)
BLOCK = (256, 256)
NPROCS, PPN = 48, 6             # 6 ranks per node, as the 3-D benchmark
COMPONENTS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
SEED = 0
REPS = 20

KERNELS = {
    "pack_rows": ("src/repro_torch/kernels/csrc/pack_rows.cu",
                  "src/repro/kernels/pack_blocks.py:29"),
    "chunked_to_rowmajor": ("src/repro_torch/kernels/csrc/relayout.cu",
                            "src/repro/kernels/relayout.py:22"),
    "rowmajor_to_chunked": ("src/repro_torch/kernels/csrc/relayout.cu",
                            "src/repro/kernels/relayout.py:26"),
}


def emit(phase, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_abs_err(a, b) -> float:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if not torch.equal(a, b):
        raise AssertionError("kernel and plain version differ: "
                             f"{(a.double() - b.double()).abs().max()}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def time_ms(fn, reps: int = REPS) -> dict:
    """Device time of one call, CUDA events around each of ``reps`` calls
    after a warm-up: the median and the quartiles, in milliseconds."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {"median": med, "p25": q1, "p75": q3}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# -- phase 0 / 1 ---------------------------------------------------------------

def probe(torch) -> dict:
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    cap = torch.cuda.get_device_capability(0)
    info = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc.strip().splitlines()[-1],
            "device": torch.cuda.get_device_name(0),
            "capability": list(cap), "count": torch.cuda.device_count(),
            "nvidia_smi": smi_line()}
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    return info


def build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    return {"seconds": time.perf_counter() - t0,
            "libs": {n: {"seconds": v["seconds"],
                         "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                   if "Used" in ln or "spill" in ln]}
                     for n, v in info.items()}}


# -- phase 2 -------------------------------------------------------------------

def _rows_case(rng, n, w, torch, dtype, dev):
    src = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
    if dtype in (torch.int32, torch.int8):
        src = (src * 50).round().clamp(-128, 127)
    src = src.to(dtype).to(dev)
    perm = rng.permutation(n).astype(np.int32)
    m = n + 8
    dst = rng.choice(m, size=n, replace=False).astype(np.int32)
    return (src, torch.from_numpy(perm).to(dev),
            torch.from_numpy(dst).to(dev), m)


def slice_tables(layout):
    """Row tables of the main path's merged write of one component."""
    from repro_torch.core.clustering import Cluster
    from repro_torch.core.merge import plan_from_clusters
    from repro_torch.kernels.ref import plan_row_tables
    plan = plan_from_clusters([Cluster(cp.chunk, tuple(cp.sources))
                               for cp in layout.chunks])
    return plan_row_tables(plan)


def check_kernels(torch, dev, layout) -> dict:
    from repro_torch.core import (build_merge_plan, simulate_load_balance,
                                  uniform_grid_blocks)
    from repro_torch.kernels import (chunked_to_rowmajor,
                                     merge_blocks_device, pack_rows,
                                     rowmajor_to_chunked)
    from repro_torch.kernels.ref import (chunked_to_rowmajor_ref,
                                         pack_rows_ref,
                                         rowmajor_to_chunked_ref)
    cases = 0
    err = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(SEED)
    # the unit sweep, plus row lengths that take every vector width
    # (12, 8, 6 and 7 bytes: 4-, 8-, 2- and 1-byte accesses)
    sweep = [(dt, n, w) for dt in (torch.float32, torch.bfloat16,
                                   torch.int32, torch.int8)
             for n, w in ((32, 128), (64, 256), (16, 512))]
    sweep += [(torch.float32, 40, 3), (torch.int32, 40, 2),
              (torch.bfloat16, 40, 3), (torch.int8, 40, 7)]
    for dt, n, w in sweep:
        src, sr, dr, m = _rows_case(rng, n, w, torch, dt, dev)
        got = pack_rows(src, sr, dr, n_dst_rows=m, width=w)
        max_abs_err(got, pack_rows_ref(src, sr, dr, n_dst_rows=m, width=w))
        cases += 1
    # the checkpoint-merge case: row-slab shards of a 2-D weight
    W = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    shards = [(32, 48), (0, 16), (48, 64), (16, 32)]
    src = torch.cat([W[a:b] for a, b in shards]).to(dev)
    dst_rows = np.concatenate([np.arange(a, b) for a, b in shards])
    got = pack_rows(src, torch.arange(64, dtype=torch.int32, device=dev),
                    torch.from_numpy(dst_rows.astype(np.int32)).to(dev),
                    n_dst_rows=64, width=256)
    max_abs_err(got, W.to(dev))
    cases += 1

    for dt in (torch.float32, torch.bfloat16):
        for grid, chunk in (((4, 2), (8, 128)), ((2, 4), (16, 128)),
                            ((3, 3), (8, 256))):
            x = torch.from_numpy(rng.standard_normal(
                (*grid, *chunk)).astype(np.float32)).to(dt).to(dev)
            rm = chunked_to_rowmajor(x, chunk=chunk)
            max_abs_err(rm, chunked_to_rowmajor_ref(x))
            back = rowmajor_to_chunked(rm, chunk=chunk)
            max_abs_err(back, rowmajor_to_chunked_ref(rm, chunk))
            max_abs_err(back, x)
            cases += 3

    # the main path's shapes: the merged write of one component, and the
    # 8 x 8 grid of 1024 x 1024 chunks of the reorganized layout
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    width, sr, dr, total, _ = slice_tables(layout)
    src = torch.randn(total, generator=gen, device=dev)
    sr_t, dr_t = (torch.from_numpy(a).to(dev) for a in (sr, dr))
    kw = dict(n_dst_rows=total // width, width=width)
    err["pack_rows"] = max_abs_err(pack_rows(src, sr_t, dr_t, **kw),
                                   pack_rows_ref(src, sr_t, dr_t, **kw))
    x = torch.randn((8, 8, 1024, 1024), generator=gen, device=dev)
    rm = chunked_to_rowmajor(x, chunk=(1024, 1024))
    err["chunked_to_rowmajor"] = max_abs_err(rm, chunked_to_rowmajor_ref(x))
    back = rowmajor_to_chunked(rm, chunk=(1024, 1024))
    err["rowmajor_to_chunked"] = max_abs_err(
        back, rowmajor_to_chunked_ref(rm, (1024, 1024)))
    max_abs_err(back, x)
    cases += 4
    del src, sr_t, dr_t, x, rm, back

    # merge_blocks_device on the 3-D world: 256^3 f32, 32x32x64 blocks, 48
    # load-balanced processes (64-element rows: N-D row tables)
    blocks = simulate_load_balance(uniform_grid_blocks((256, 256, 256),
                                                       (32, 32, 64)),
                                   num_procs=48, seed=SEED)
    merged = 0
    for p in range(48):
        mine = [b for b in blocks if b.owner == p]
        if not mine:
            continue
        plan = build_merge_plan(mine)
        data = {b.block_id: torch.randn(b.shape, generator=gen, device=dev)
                for b in mine}
        ref = [torch.empty(c.cuboid.shape, device=dev) for c in plan.clusters]
        for op in plan.copies:
            ref[op.dst_index][op.dst_slices] = data[op.block_id]
        for a, b in zip(merge_blocks_device(plan, data), ref):
            max_abs_err(a, b)
        merged += len(plan.clusters)
        cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "merged_buffers_3d": merged,
            "tolerance": "bit-exact: torch.equal, max_abs_err 0",
            "max_abs_err": err}


# -- phase 3 -------------------------------------------------------------------

def main_path(torch, dev, blocks, layouts) -> dict:
    from repro_torch.core.blocks import Block
    from repro_torch.io import Dataset
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = {c: torch.randn(FIELD, generator=gen, device=dev)
              for c in COMPONENTS}
    # every block its own allocation, as a WarpX FArrayBox
    data = {c: {b.block_id: fields[c][b.slices()].contiguous()
                for b in blocks} for c in COMPONENTS}
    torch.cuda.synchronize()
    whole = Block((0, 0), FIELD)
    part = Block((FIELD[0] // 8, FIELD[1] * 3 // 8),
                 (FIELD[0] * 5 // 8, FIELD[1] * 7 // 8))
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, layout in layouts.items():
        st = dict.fromkeys(("plan", "lower_write", "kernel", "d2h",
                            "engine_write", "engine_read", "lower_read",
                            "h2d", "linearize", "checksum_and_index"), 0.0)
        st["plan"] = layout["plan_seconds"]
        d = tempfile.mkdtemp(dir=work)
        try:
            ds = Dataset.create(d)
            for c in COMPONENTS:
                t0 = time.perf_counter()
                plan = ds.plan_write(c, layout["plan"], np.float32)
                st["plan"] += time.perf_counter() - t0
                ws = ds.write_planned(plan, data[c])
                st["lower_write"] += ws.lower_seconds
                st["kernel"] += ws.kernel_seconds
                st["d2h"] += ws.d2h_seconds
                st["engine_write"] += ws.write_seconds
                st["checksum_and_index"] += (ws.total_seconds
                                             - ws.assemble_seconds
                                             - ws.write_seconds)
            ds.close()
            ds = Dataset.open(d)
            for c in COMPONENTS:
                got, rs = ds.read(c, whole)
                if got.device != dev or not torch.equal(got, fields[c]):
                    raise AssertionError(f"{name}/{c}: read-back differs")
                st["engine_read"] += rs.seconds
                st["lower_read"] += rs.lower_seconds
                st["h2d"] += rs.h2d_seconds
                st["linearize"] += rs.linearize_seconds
                del got
            got, _ = ds.read("Ez", part)
            if not torch.equal(got, fields["Ez"][part.slices()]):
                raise AssertionError(f"{name}: partial read differs")
            ds.close()
            nbytes = sum(p.stat().st_size for p in Path(d).iterdir())
        finally:
            shutil.rmtree(d)
        out[name] = {"chunks": len(layout["plan"].chunks),
                     "stored_bytes": nbytes, "seconds": st}
    return out


# -- phase 4 -------------------------------------------------------------------

def timings(torch, dev, layout) -> dict:
    from repro_torch.kernels import pack_blocks, relayout
    from repro_torch.kernels.ref import (chunked_to_rowmajor_ref,
                                         pack_rows_ref,
                                         rowmajor_to_chunked_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    width, sr, dr, total, _ = slice_tables(layout)
    src = torch.randn(total, generator=gen, device=dev)
    sr_t, dr_t = (torch.from_numpy(a).to(dev) for a in (sr, dr))
    n_dst = total // width
    out = torch.zeros((n_dst, width), device=dev)
    copy_dst = torch.empty_like(src)
    rows = len(sr)
    pack_bytes = 2 * rows * width * 4 + 2 * rows * 4
    res = {"pack_rows": {
        "shape": {"rows": rows, "width": width, "dtype": "float32"},
        "ms": time_ms(lambda: pack_blocks.launch(src, out, sr_t, dr_t,
                                                 width)),
        "wrapper_ms": time_ms(lambda: pack_blocks.pack_rows(
            src, sr_t, dr_t, n_dst_rows=n_dst, width=width)),
        "plain_ms": time_ms(lambda: pack_rows_ref(
            src, sr_t, dr_t, n_dst_rows=n_dst, width=width)),
        "library_ms": time_ms(lambda: copy_dst.copy_(src)),
        "bytes": pack_bytes}}
    del src, out, copy_dst, sr_t, dr_t

    x = torch.randn((8, 8, 1024, 1024), generator=gen, device=dev)
    rm = torch.empty(FIELD, device=dev)
    ch = torch.empty_like(x)
    nbytes = 2 * x.numel() * 4
    res["chunked_to_rowmajor"] = {
        "shape": {"chunks": [8, 8, 1024, 1024], "dtype": "float32"},
        "ms": time_ms(lambda: relayout.launch(x, rm, 8, 8, 1024, 1024,
                                              to_rowmajor=True)),
        "plain_ms": time_ms(lambda: chunked_to_rowmajor_ref(x)),
        "library_ms": time_ms(
            lambda: x.permute(0, 2, 1, 3).contiguous().view(FIELD)),
        "bytes": nbytes}
    res["rowmajor_to_chunked"] = {
        "shape": {"array": list(FIELD), "chunk": [1024, 1024],
                  "dtype": "float32"},
        "ms": time_ms(lambda: relayout.launch(rm, ch, 8, 8, 1024, 1024,
                                              to_rowmajor=False)),
        "plain_ms": time_ms(lambda: rowmajor_to_chunked_ref(rm,
                                                            (1024, 1024))),
        "library_ms": time_ms(
            lambda: rm.view(8, 1024, 8, 1024).permute(0, 2, 1, 3)
            .contiguous()),
        "bytes": nbytes}
    for r in res.values():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        for key in [k for k in r if isinstance(r[k], dict)
                    and "median" in r[k]]:
            r[f"{key}_quartiles"] = [r[key]["p25"], r[key]["p75"]]
            r[key] = r[key]["median"]
    return res


# -- driver --------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import (plan_layout, simulate_load_balance,
                                  uniform_grid_blocks)
    dev = torch.device("cuda", 0)

    info = probe(torch)
    emit(0, **info)
    emit(1, **build())

    t0 = time.perf_counter()
    blocks = simulate_load_balance(uniform_grid_blocks(FIELD, BLOCK),
                                   num_procs=NPROCS, seed=SEED)
    layouts = {}
    for name in ("merged_process", "reorganized"):
        t1 = time.perf_counter()
        layouts[name] = {"plan": plan_layout(name, blocks, num_procs=NPROCS,
                                             procs_per_node=PPN)}
        layouts[name]["plan_seconds"] = time.perf_counter() - t1
    checks = check_kernels(torch, dev, layouts["merged_process"]["plan"])
    emit(2, seconds=time.perf_counter() - t0, **checks)

    t0 = time.perf_counter()
    K.reset_launch_counts()
    stages = main_path(torch, dev, blocks, layouts)
    launches = K.launch_counts()
    torch.cuda.empty_cache()
    emit(3, seconds=time.perf_counter() - t0, field=list(FIELD),
         block=list(BLOCK), components=len(COMPONENTS), procs=NPROCS,
         layouts=stages)

    t0 = time.perf_counter()
    times = timings(torch, dev, layouts["merged_process"]["plan"])
    emit(4, seconds=time.perf_counter() - t0, kernels=times,
         hbm_bytes_per_s=HBM_BYTES_PER_S)

    emit(5, launches=launches)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": checks["max_abs_err"][name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": times[name]["library_ms"]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
