"""End-to-end training example: a ~100M-param dense LM trained for a few
hundred steps on synthetic data, with layout-aware checkpointing, a
restart-exact data pipeline, and straggler reporting — on the card.

Run:        PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
Fast check: PYTHONPATH=src python -m repro_torch.examples.train_e2e \
                --steps 5 --tiny --device cpu

Weights come from a seeded ``torch.Generator``.  The pipeline runs without
a prefetch thread (``prefetch=0``): a prefetch thread would draw step 0's
batches before a resume moves the source to the checkpoint's step.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_smoke_config
from ..data.pipeline import PipelineConfig, make_pipeline
from ..models import LM, ModelConfig
from ..train import OptimizerConfig, Trainer


def base_100m() -> ModelConfig:
    return ModelConfig(
        name="base-100m", family="dense",
        n_layers=12, d_model=640, n_heads=10, n_kv=5, head_dim=64,
        d_ff=2560, vocab=32000,
        program=(("attn", 12),),
        remat="none", grad_accum=1, loss_chunk=128,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-scale model (CI)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2.5-3b") if args.tiny else base_100m()
    model = LM(cfg, device=args.device)
    print(f"model: {cfg.name}  device={model.device}  "
          f"params={model.num_params():,}")

    mgr = CheckpointManager(args.ckpt_dir, strategy="merged_process", keep=2,
                            device=model.device)
    pcfg = PipelineConfig(global_batch=args.batch, seq_len=args.seq,
                          vocab=cfg.vocab, seed=17)
    src, data = make_pipeline(pcfg, prefetch=0)

    tr = Trainer(model, OptimizerConfig(peak_lr=1e-3, warmup_steps=20,
                                        total_steps=max(args.steps, 100)),
                 data, ckpt_manager=mgr, ckpt_every=args.ckpt_every)
    params, opt = tr.init(torch.Generator(model.device).manual_seed(0))
    if args.resume and mgr.steps():
        step, params = mgr.restore_latest(template=params)
        tr.state.step = step
        src.restore({"step": step})
        print(f"resumed from step {step}")

    params, opt, hist = tr.run(params, opt, num_steps=args.steps,
                               log_every=10)
    losses = [m["loss"] for _, m in hist]
    print(f"loss: first10={np.mean(losses[:10]):.4f} "
          f"last10={np.mean(losses[-10:]):.4f}")
    print("straggler report:", tr.straggler_report())
    stats = mgr.save(tr.state.step, params)
    print(f"final checkpoint: {stats.num_original_blocks} blocks -> "
          f"{stats.num_chunks} chunks, {stats.bytes / 1e6:.1f} MB "
          f"in {stats.seconds:.2f}s at {args.ckpt_dir}")


if __name__ == "__main__":
    main()
