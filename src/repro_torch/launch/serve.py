"""Serving launcher: batched generation against a (smoke or full) config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu]

Runs on the card unless ``--device cpu`` is given; raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..models import LM
from ..serve import ServeEngine, cache_bytes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch: no decode step exists")
    model = LM(cfg, device=args.device)
    gen = torch.Generator(model.device).manual_seed(args.seed)
    params = model.init(gen)
    max_len = args.prompt_len + args.new_tokens
    engine = ServeEngine(model, params, max_len=max_len, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    extra = None
    if cfg.family == "vlm":
        extra = {"memory": torch.as_tensor(
            rng.standard_normal((args.batch, cfg.n_memory_tokens,
                                 cfg.d_model)) * 0.02,
            device=model.device).to(torch.bfloat16)}
    out, stats = engine.generate(prompts, args.new_tokens,
                                 temperature=args.temperature, generator=gen,
                                 extra=extra)
    print(f"arch={cfg.name} device={model.device} generated={out.shape} "
          f"prefill={stats.prefill_seconds * 1e3:.1f}ms "
          f"decode={stats.decode_tps:.1f} tok/s "
          f"kv-cache={cache_bytes(model, args.batch, max_len) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
