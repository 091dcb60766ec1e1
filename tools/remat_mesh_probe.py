#!/usr/bin/env python3
"""Remat under a mesh: deepseek-moe-16b cut to 2 layer steps (the
smallest cut that remats: a one-step segment runs as a single layer) on
mesh (data 1, model 2) in a 2-rank gloo world, f32, the functional
collectives on ``chip_smoke.classic_dtensor_collectives``' classic calls
(phase 26's world).  Each remat variant runs in a fresh world; its
gradients are held to the ``remat="none"`` world's, and the collectives
that ran in the forward and in the backward are counted.  With
``PROBE_STACKS=1`` every collective that runs in the backward is listed
with the port's and DTensor's frames that issued it.

    python3 tools/remat_mesh_probe.py [cpu] [variant ...]

``cpu`` runs the smoke config on CPU tensors (no card); the variants are
remat modes (default: none, dots, full).  One JSON line a variant.
"""
import collections
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def rank_main(rank, remat, init, out, device, smoke):
    import faulthandler
    import traceback
    trail = open(f"{out}.rank{rank}.trail", "w")
    faulthandler.enable(trail)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.checkpoint.blocks_map import flatten_pytree
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.train.trainer import place_batch, value_and_grad
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    mesh = make_mesh((1, 2), ("data", "model"), dev.type)
    base = dataclasses.replace((get_smoke_config if smoke else get_config)(
        "deepseek-moe-16b"), flash=True)
    if smoke:
        base = dataclasses.replace(base, loss_chunk=32, flash_block=32)
    cfg = cs.cut_depth(dataclasses.replace(
        base, remat=remat, moe=dataclasses.replace(base.moe,
                                                   dispatch="local")), 2)
    stacks = collections.Counter()
    counted = cs._counted

    def listing(fn):                  # the backward's collectives' frames
        run = counted(fn)

        def traced(*a):
            if os.environ.get("PROBE_STACKS") and \
                    torch._C._current_graph_task_id() != -1:
                frames = [f"{f.filename.split('/')[-1]}:{f.lineno}:{f.name}"
                          for f in traceback.extract_stack()
                          if "repro_torch" in f.filename
                          or "tensor/_" in f.filename][-6:]
                stacks[(fn.__name__, " < ".join(reversed(frames)))] += 1
            return run(*a)
        return traced
    cs._counted = listing
    seq = 64 if smoke else cs.TRAIN_SEQ
    b = next(SyntheticTokens(PipelineConfig(
        global_batch=cs.TRAIN_BATCH, seq_len=seq, vocab=cfg.vocab,
        seed=0, frontend=cfg.frontend, d_model=cfg.d_model)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    model = LM(cfg, device=dev)
    t0 = time.perf_counter()
    cs.CLASSIC_COUNTS.update(forward=0, backward=0)
    with cs.classic_dtensor_collectives(device), \
            cs.compute_dtype(torch.float32), \
            shd.use_sharding(mesh, shd.DEFAULT_RULES):
        params = cs.training_params(model, torch.Generator(device=dev)
                                    .manual_seed(0))
        loss, _, grads = value_and_grad(model, params, place_batch(batch))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        g = {n: t.to_local().cpu() for n, t in
             flatten_pytree(grads).items()}
    torch.save({"loss": float(loss.to_local()), "grads": g,
                "collectives": dict(cs.CLASSIC_COUNTS),
                "stacks": [[k, v] for k, v in sorted(stacks.items())],
                "seconds": time.perf_counter() - t0},
               f"{out}.rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def main(argv) -> int:
    import multiprocessing as mp
    import torch
    device = "cpu" if argv[:1] == ["cpu"] else "cuda"
    variants = (argv[1:] if device == "cpu" else argv) or \
        ["none", "dots", "full"]
    work = ROOT / "build" / "remat_mesh_probe"
    work.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    if device == "cuda":
        import chip_smoke as cs
        print(cs.smi_line(), flush=True)
        cs.build()
    oracle = None
    for remat in variants:
        out = str(work / remat)
        if os.path.exists(f"{out}.store"):
            os.remove(f"{out}.store")
        t0 = time.time()
        procs = [ctx.Process(target=rank_main, args=(
            r, remat, f"file://{out}.store", out, device,
            device == "cpu")) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        r = {"remat": remat, "exit": [p.exitcode for p in procs],
             "seconds": time.time() - t0}
        if any(c != 0 for c in r["exit"]):
            r["trails"] = [Path(f"{out}.rank{i}.trail").read_text()[-2500:]
                           for i in range(2)]
        else:
            got = [torch.load(f"{out}.rank{i}.pt") for i in range(2)]
            r.update(loss=got[0]["loss"], step_seconds=got[0]["seconds"],
                     collectives=got[0]["collectives"],
                     backward_stacks=got[0]["stacks"])
            if oracle is None:
                oracle = [x["grads"] for x in got]
            else:
                gaps = {}
                for i in range(2):
                    for n, t in got[i]["grads"].items():
                        w = oracle[i][n]
                        gaps[n] = max(gaps.get(n, 0.0), float(
                            (t - w).abs().max()
                            / w.abs().max().clamp_min(1e-30)))
                r["grad_gap_max"] = max(gaps.values())
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
