"""Training launcher: a few AdamW steps on a (smoke or full) config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 20 [--device cpu]

Runs on the card unless ``--device cpu`` is given; raises without one.
Weights come from a seeded ``torch.Generator``, batches from the seeded
synthetic token pipeline.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..data.pipeline import PipelineConfig, make_pipeline
from ..models import LM
from ..train import OptimizerConfig, Trainer

#: options of the reference's launcher that wait for a later slice
WAITING = {"--mesh": "the distributed slice (ROADMAP.md queue 1, item 13)",
           "--ckpt-dir": "the checkpoint slice (ROADMAP.md queue 1, "
                         "items 5-7)",
           "--resume": "the checkpoint slice (ROADMAP.md queue 1, "
                       "items 5-7)"}


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
    _, data = make_pipeline(PipelineConfig(
        global_batch=args.global_batch, seq_len=args.seq_len,
        vocab=cfg.vocab, seed=args.seed))
    tr = Trainer(model, OptimizerConfig(peak_lr=args.lr, warmup_steps=10,
                                        total_steps=max(args.steps, 100)),
                 data)
    params, opt = tr.init(torch.Generator(model.device)
                          .manual_seed(args.seed))
    params, opt, hist = tr.run(params, opt, num_steps=args.steps,
                               log_every=10)
    print(f"loss {hist[0][1]['loss']:.4f} -> {hist[-1][1]['loss']:.4f}")
    print("straggler report:", tr.straggler_report())


if __name__ == "__main__":
    main()
