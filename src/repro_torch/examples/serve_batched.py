"""Batched serving example: prefill + decode with KV and SSM caches on the
card, then snapshot the live serving state (params + the bf16 caches)
through the layout-aware checkpoint — server migration the paper's way.

Run:        PYTHONPATH=src python -m repro_torch.examples.serve_batched
Fast check: PYTHONPATH=src python -m repro_torch.examples.serve_batched \
                --device cpu

Weights come from a seeded ``torch.Generator``.  The snapshot is restored
once and every leaf compared with its source.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_smoke_config
from ..models import LM
from ..serve import ServeEngine, cache_bytes, cache_spec_summary, \
    flatten_cache

ARCHS = ("qwen2.5-3b", "gemma2-2b", "mamba2-780m", "hymba-1.5b")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--snap-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_serve_snapshot"))
    args = ap.parse_args(argv)

    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = LM(cfg, device=args.device)
        params = model.init(torch.Generator(model.device).manual_seed(0))
        engine = ServeEngine(model, params, max_len=96, device=args.device)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, (4, 32))
        out, stats = engine.generate(prompts, num_new=16)
        print(f"{arch:14s} generated {out.shape} "
              f"prefill={stats.prefill_seconds * 1e3:6.1f} ms "
              f"decode={stats.decode_tps:7.1f} tok/s "
              f"cache={cache_bytes(model, 4, 96) / 1e6:6.2f} MB "
              f"{cache_spec_summary(model, 4, 96)}")

    # snapshot live serving state via the layout engine
    cfg = get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(1))
    engine = ServeEngine(model, params, max_len=64, device=args.device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    _, _ = engine.generate(prompts, num_new=4)
    with torch.inference_mode():
        _, cache = engine._prefill(params, {"tokens": torch.as_tensor(
            prompts, device=model.device)})
    state = {"params": params, "kv": flatten_cache(cache)}
    mgr = CheckpointManager(args.snap_dir, strategy="merged_process", keep=1,
                            device=model.device)
    stats = mgr.save(0, state)
    back, _ = mgr.restore(0, template=state)
    same = all(torch.equal(a, b) for a, b in zip(
        flatten_cache(back).values(), flatten_cache(state).values()))
    print(f"serving-state snapshot: {stats.bytes / 1e6:.1f} MB, "
          f"{stats.num_chunks} chunks -> {args.snap_dir}; "
          f"restored equal: {same}")
    if not same:
        raise SystemExit("the restored serving state differs from its source")


if __name__ == "__main__":
    main()
