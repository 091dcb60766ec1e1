"""Model flops of the untraced part of the traced run's window over its
seconds, as a percentage of the card's bf16 peak (``harness/arith``:
6 N_active a token for a training step, 2 N_active a token, prompt and
decoded, for serving)."""

from harness import arith

KIND = {"train": "train", "generate": "forward"}


def read(obs):
    u = obs["untraced"]
    if not u["units"]:
        return None
    flops = arith.model_flops(obs["model"], KIND[obs["entry"]], u["tokens"])
    return 100.0 * flops / u["seconds"] / arith.PEAK_FLOPS["bfloat16"]
