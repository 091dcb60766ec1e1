"""The least time of the cell's self-attention work (live (q, k) pairs by
the flops a pair at the card's bf16 peak, ``harness/arith``: forward, dq
and dkv once a training step, the forward once a prefill) over the
device time of the kernels launched inside the port's flash custom ops
in the profiled sub-window, in percent.  Nothing where no flash kernel
ran."""

from harness import arith

FLASH_OPS = ("repro_torch::flash_fwd", "repro_torch::flash_dq",
             "repro_torch::flash_dkv")
PASSES = {"train": ("fwd", "dq", "dkv"), "generate": ("fwd",)}


def read(obs):
    p = obs.get("profiled")
    if not p:
        return None
    flash_s = sum(p["op_device_s"].get(op, 0.0) for op in FLASH_OPS)
    if flash_s <= 0:
        return None
    work = arith.attention_flops(obs["model"], obs["rows"], obs["seq_len"],
                                 PASSES[obs["entry"]])
    least = work * p["units"] / arith.PEAK_FLOPS["bfloat16"]
    return 100.0 * least / flash_s
