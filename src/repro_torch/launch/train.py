"""Training launcher: a few AdamW steps on a (smoke or full) config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 20 [--device cpu] [--ckpt-dir DIR \
      --ckpt-strategy merged_process --ckpt-every 25 [--resume]]

  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
      -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
      --mesh host [--device cpu]

Runs on the card unless ``--device cpu`` is given; raises without one.
Weights come from a seeded ``torch.Generator``, batches from the seeded
synthetic token pipeline.  With ``--ckpt-dir`` the params are saved every
``--ckpt-every`` steps and once at the end (the last two kept);
``--resume`` restores the latest before training and carries on from its
step.

``--mesh`` trains under a sharding context (``FSDP_RULES`` if the config
says ``fsdp``, else ``DEFAULT_RULES``) over the world ``torchrun`` started
(without one, a world of this process alone): ``host`` is (1, world
size), ``production`` (16, 16) and ``production-multi`` (2, 16, 16).  The
backend is NCCL on the card (a card a rank) and gloo on the CPU.  Params
and AdamW state are DTensors; rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config, list_archs
from ..data.pipeline import PipelineConfig, make_pipeline
from ..device import resolve_device
from ..distributed import sharding as shd
from ..models import LM
from ..train import OptimizerConfig, Trainer
from .mesh import make_host_mesh, make_production_mesh

MESHES = {"host": make_host_mesh,
          "production": lambda device: make_production_mesh(
              multi_pod=False, device=device),
          "production-multi": lambda device: make_production_mesh(
              multi_pod=True, device=device)}


def start_world(device) -> bool:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment), or start one of
    this process alone on a free local port; True where this call
    started it.  NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None, choices=list(MESHES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-strategy", default="merged_process")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = LM(cfg, device=args.device)
    started = args.mesh is not None and start_world(args.device)
    talk = print if args.mesh is None or dist.get_rank() == 0 else \
        (lambda *a, **k: None)
    try:
        with contextlib.ExitStack() as stack:
            if args.mesh is not None:
                mesh = MESHES[args.mesh](device=args.device)
                stack.enter_context(shd.use_sharding(
                    mesh, shd.FSDP_RULES if cfg.fsdp else shd.DEFAULT_RULES))
            _train(args, cfg, model, talk)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, model, print) -> None:
    print(f"arch={cfg.name} device={model.device} "
          f"params={model.num_params():,}"
          + (f" mesh={args.mesh}" if args.mesh else ""))
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, strategy=args.ckpt_strategy,
                                 keep=2, device=model.device)
    # no prefetch thread: it would draw step 0's batches before a resume
    # moves the pipeline to the checkpoint's step
    src, data = make_pipeline(PipelineConfig(
        global_batch=args.global_batch, seq_len=args.seq_len,
        vocab=cfg.vocab, seed=args.seed, frontend=cfg.frontend,
        d_model=cfg.d_model), prefetch=0)
    tr = Trainer(model, OptimizerConfig(peak_lr=args.lr, warmup_steps=10,
                                        total_steps=max(args.steps, 100)),
                 data, ckpt_manager=ckpt, ckpt_every=args.ckpt_every)
    params, opt = tr.init(torch.Generator(model.device)
                          .manual_seed(args.seed))
    if args.resume and ckpt is not None and ckpt.steps():
        step, params = ckpt.restore_latest(template=params)
        tr.state.step = step
        src.restore({"step": step})
        print(f"resumed from step {step}")
    params, opt, hist = tr.run(params, opt, num_steps=args.steps,
                               log_every=10, log_fn=print)
    print(f"loss {hist[0][1]['loss']:.4f} -> {hist[-1][1]['loss']:.4f}")
    print("straggler report:", tr.straggler_report())
    if ckpt is not None:
        stats = ckpt.save(tr.state.step, params)
        print(f"checkpoint: {stats.num_original_blocks} blocks -> "
              f"{stats.num_chunks} chunks ({stats.bytes / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
