"""Training launcher: a few AdamW steps on a (smoke or full) config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 20 [--device cpu] [--ckpt-dir DIR \
      --ckpt-strategy merged_process --ckpt-every 25 [--resume]]

Runs on the card unless ``--device cpu`` is given; raises without one.
Weights come from a seeded ``torch.Generator``, batches from the seeded
synthetic token pipeline.  With ``--ckpt-dir`` the params are saved every
``--ckpt-every`` steps and once at the end (the last two kept);
``--resume`` restores the latest before training and carries on from its
step.
"""

from __future__ import annotations

import argparse

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config, list_archs
from ..data.pipeline import PipelineConfig, make_pipeline
from ..models import LM
from ..train import OptimizerConfig, Trainer

#: options of the reference's launcher that wait for a later slice
WAITING = {"--mesh": "the distributed slice (ROADMAP.md queue 1, item 13)"}


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
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-strategy", default="merged_process")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    for opt, waits in WAITING.items():
        if getattr(args, opt[2:].replace("-", "_")):
            raise NotImplementedError(f"{opt} is not ported yet: it waits "
                                      f"for {waits}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = LM(cfg, device=args.device)
    print(f"arch={cfg.name} device={model.device} "
          f"params={model.num_params():,}")
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
                               log_every=10)
    print(f"loss {hist[0][1]['loss']:.4f} -> {hist[-1][1]['loss']:.4f}")
    print("straggler report:", tr.straggler_report())
    if ckpt is not None:
        stats = ckpt.save(tr.state.step, params)
        print(f"checkpoint: {stats.num_original_blocks} blocks -> "
              f"{stats.num_chunks} chunks ({stats.bytes / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
