#!/usr/bin/env python3
"""One deepseek-moe-16b smoke ``moe`` block in f32 on the CUDA card
against its CPU run, with its attention weights as the reference's init
draws them and rescaled to fan-in (as ``tests/test_torch_cuda.py``'s
``test_moe_block_and_ssd_backward_on_the_card`` holds it).

Run from the repository root on a machine with a GPU and ``nvcc``:

    python3 tools/moe_block_card_probe.py

It prints one JSON object: for each weighting, whether the experts the
router picks are equal on both devices (from the block's raw input and
from the router's own input, ``ln2`` of x plus attention), and for the
output, the aux loss and every gradient the largest |card - cpu|, its
largest share of the test's tolerance (rtol 1e-3, atol 1e-4) and the
elements past it; then the card's name and power limit.
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.params import (materialize, tree_leaves,  # noqa: E402
                                       tree_map)

RTOL, ATOL = 1e-3, 1e-4


def grads_on(dev, fn, params, *inputs):
    """``fn``'s outputs and the gradients of their seeded weighted sum."""
    p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
    out, *rest = fn(p, *(t.to(dev) for t in inputs))
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    loss = (out * ct.to(dev)).sum() + sum(r.sum() for r in rest)
    return [out, *rest], torch.autograd.grad(loss, tree_leaves(p))


def run(cuda, scaled: bool) -> dict:
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              flash=True, flash_block=16)
    params = materialize(tfm.block_defs(cfg, "moe"),
                         torch.Generator().manual_seed(0))
    if scaled:
        a = params["attn"]
        for name, scale in (("wq", cfg.n_heads / cfg.d_model),
                            ("wk", cfg.n_kv / cfg.d_model),
                            ("wv", cfg.n_kv / cfg.d_model),
                            ("wo", 1 / cfg.n_heads)):
            a[name] = a[name] * scale ** 0.5
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, cfg.d_model, generator=gen) * 0.5
    pos = torch.arange(32)

    def fn(p, h, ps):
        y, aux, _ = tfm.block_forward(cfg, "moe", p, h, ps)
        return y, aux
    raw = [moe_mod._route({"router": params["moe"]["router"].to(d)},
                          x.reshape(64, -1).to(d), cfg.moe)[1].cpu()
           for d in ("cpu", cuda)]
    picks, route = [], moe_mod._route

    def spy(p, xf, dims):
        o = route(p, xf, dims)
        picks.append(o[1].cpu())
        return o
    moe_mod._route = spy
    saved, layers._COMPUTE = layers._COMPUTE, torch.float32
    try:
        outs_cpu, g_cpu = grads_on("cpu", fn, params, x, pos)
        outs_gpu, g_gpu = grads_on(cuda, fn, params, x, pos)
    finally:
        layers._COMPUTE = saved
        moe_mod._route = route
    rows = {}
    names = ["out", "aux"] + cs._leaf_names(params)
    for name, a, b in zip(names, outs_gpu + list(g_gpu),
                          outs_cpu + list(g_cpu)):
        a, b = a.detach().cpu(), b.detach()
        d = (a - b).abs()
        allowed = ATOL + RTOL * b.abs()
        rows[name] = {"max_abs": float(d.max()),
                      "max_share_of_tolerance": float((d / allowed).max()),
                      "past_tolerance": int((d > allowed).sum()),
                      "elements": d.numel()}
    return {"raw_input_picks_equal": bool(torch.equal(*raw)),
            "router_input_picks_equal": len(picks) == 2
            and bool(torch.equal(*picks)),
            "within_tolerance": all(r["past_tolerance"] == 0
                                    for r in rows.values()),
            "leaves": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_block_card_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    print(json.dumps({"reference_init": run(cuda, False),
                      "attention_at_fan_in": run(cuda, True)}))
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
