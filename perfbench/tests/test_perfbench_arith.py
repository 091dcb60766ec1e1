"""The yardstick's arithmetic against hand counts and against the port's
own definitions it was copied from."""

import pytest

from harness import arith


@pytest.mark.parametrize("Lq,Lk,causal,window,want", [
    (4, 4, True, None, 10),          # 1 + 2 + 3 + 4
    (4, 4, False, None, 16),
    (6, 6, True, 2, 11),             # 1 + 2 + 2 + 2 + 2 + 2
    (5, 5, True, 1, 5),              # the diagonal alone
    (3, 5, True, None, 6),           # q 0..2 against k 0..4
])
def test_live_pairs_by_hand(Lq, Lk, causal, window, want):
    assert arith.live_pairs(Lq, Lk, causal, window) == want


@pytest.mark.parametrize("L,window", [(2048, None), (8192, 1024),
                                      (300, 64)])
def test_live_pairs_match_the_ports(L, window):
    from repro_torch.kernels.flash_attention import live_pairs
    assert arith.live_pairs(L, L, True, window) == \
        live_pairs(L, L, True, window)


def test_attention_flops_match_the_ports_flop_formula():
    from repro_torch.kernels.flash_attention import flash_flops
    m = {"program": [["attn", 2], ["swa", 1], ["ssd", 3]], "window": 16,
         "causal": True, "head_dim": 32, "n_heads": 4}
    B, L = 3, 64
    q, k = (B, 4, L, 32), (B, 2, L, 32)
    want = sum(2 * flash_flops(p, q, k, True, None)
               + flash_flops(p, q, k, True, 16) for p in ("fwd", "dq",
                                                          "dkv"))
    assert arith.attention_flops(m, B, L, ("fwd", "dq", "dkv")) == want
    assert arith.attention_flops(m, B, L, ("fwd",)) == \
        2 * flash_flops("fwd", q, k, True, None) \
        + flash_flops("fwd", q, k, True, 16)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "hymba-1.5b",
                                  "arctic-480b", "mamba2-780m"])
@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("forward", "prefill_32k")])
def test_model_flops_match_model_flops_estimate(arch, kind, shape):
    """On the port's smoke configs: 6 N_active a token for training, 2 for
    a forward pass, MoE experts at top_k / n_experts."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.launch.specs import model_flops_estimate
    from repro_torch.models import LM
    cfg = get_smoke_config(arch)
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    m["program"] = [list(s) for s in cfg.program]
    for key in ("moe", "ssm"):
        if m[key] is not None:
            m[key] = dataclasses.asdict(m[key])
    cell = next(s for s in LM_SHAPES if s.name == shape)
    tokens = cell.seq_len * cell.global_batch
    want = model_flops_estimate(LM(cfg, device="cpu"), cell)
    assert arith.model_flops(m, kind, tokens) == pytest.approx(want,
                                                               rel=1e-12)


def test_the_cells_sizes(bench):
    """The full configurations' counts by hand: deepseek-moe-16b's first
    4 layers (dense layer 0, 3 MoE layers) are 2.27e9 parameters, 0.762e9
    active; hymba-1.5b at the published SSM width is 1.59e9."""
    from reference.params import count
    m = bench.config("deepseek-moe-16b-l4")["model"]
    d, v = 2048, 102400
    layer = 4 * d * d + 2 * d                     # attention, two norms
    experts = 64 * 3 * d * 1408
    moe = d * 64 + experts + 3 * d * 2 * 1408     # router, routed, shared
    total = 2 * v * d + 4 * layer + 3 * d * 10944 + 3 * moe + d
    assert count(m)["total"] == total == 2_267_039_744
    assert arith.active_params(m) == \
        pytest.approx(total - 3 * experts + 3 * experts * 6 / 64)
    d, di, heads, n = 1600, 3200, 50, 16
    ssm = d * (2 * di + 2 * n + heads) + 4 * (di + 2 * n) + (di + 2 * n) \
        + 3 * heads + di + di * d
    layer = 2 * d * 25 * 64 + 2 * d * 5 * 64 + 3 * d * 5504 + 4 * d + ssm
    total = 32001 * d + 32 * layer + d
    assert count(bench.config("hymba-1.5b")["model"])["total"] == total \
        == 1_589_773_120
