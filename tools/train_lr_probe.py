#!/usr/bin/env python3
"""Six AdamW steps of the full qwen2.5-3b on one repeated batch, under
several optimizer configs and both attention routes, on one CUDA card.

Run from the repository root on a machine with a GPU and ``nvcc``:

    python3 tools/train_lr_probe.py

It uses ``chip_smoke.py``'s training weights (``training_params``) and
batch (global batch 2 x 2048 tokens of the synthetic pipeline, seed 0)
and prints one JSON line per config with its losses, grad norms and
learning rates, then the card's name and power limit.  It is how the
training run's warmup was chosen: with the 2-step warmup the loss rises
after the first step on the flash and the q-chunked route alike.
"""

import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import OptimizerConfig, Trainer, adamw_init  # noqa

#: name -> (flash route, AdamW config)
RUNS = {
    "flash_warmup_2": (True, dict(peak_lr=3e-4, warmup_steps=2,
                                  total_steps=100)),
    "q_chunked_warmup_2": (False, dict(peak_lr=3e-4, warmup_steps=2,
                                       total_steps=100)),
    "flash_warmup_100": (True, dict(peak_lr=3e-4, warmup_steps=100,
                                    total_steps=1000)),
    "flash_peak_3e-5": (True, dict(peak_lr=3e-5, warmup_steps=2,
                                   total_steps=100)),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build()
    host = next(SyntheticTokens(PipelineConfig(
        global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ, vocab=151936,
        seed=cs.SEED)))
    for name, (flash, ocfg) in RUNS.items():
        model = LM(dataclasses.replace(get_config(cs.SERVE_ARCH),
                                       flash=flash))
        params = cs.training_params(model, torch.Generator(device=dev)
                                    .manual_seed(cs.SEED))
        tr = Trainer(model, OptimizerConfig(**ocfg), itertools.repeat(host))
        t0 = time.perf_counter()
        params, opt, hist = tr.run(params, adamw_init(params), 6,
                                   log_every=0)
        print(json.dumps({"run": name, "seconds": time.perf_counter() - t0,
                          "losses": [m["loss"] for _, m in hist],
                          "grad_norms": [m["grad_norm"] for _, m in hist],
                          "lrs": [m["lr"] for _, m in hist]}), flush=True)
        del params, opt, tr, model
        torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
