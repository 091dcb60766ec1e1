"""The benchmark's own tests: ``python -m pytest -q perfbench/tests`` from
the root of the repository (the card's: ``-m cuda``, on a machine with
one).  They drive the harness at the small sizes below on the CPU, with
the port's plain kernels; nothing here decides at import whether a card
is present."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the cells the tests drive
TRAIN = "deepseek-moe-16b-l4.train_2x4k"
SERVE = "hymba-1.5b.prefill_48x8k"

#: each cell's small size: widths of the port's smoke configs, the cell's
#: layer kinds, lengths that take the flash route (multiples of 16)
SMALL = {
    TRAIN: {
        "model": {"name": "moe-small", "n_layers": 3, "d_model": 64,
                  "n_heads": 4, "n_kv": 4, "head_dim": 16, "d_ff": 96,
                  "vocab": 64, "program": [["attn", 1], ["moe", 2]],
                  "moe": {"d_model": 64, "d_ff": 32, "n_experts": 8,
                          "top_k": 3, "n_shared": 2, "capacity_factor": 1.25,
                          "renorm_topk": False, "dispatch": "gather"},
                  "flash_block": 16, "q_chunk": 16, "loss_chunk": 16},
        "traffic": {"seq_len": 32, "traced_units": 1}},
    SERVE: {
        "model": {"name": "hybrid-small", "n_layers": 4, "d_model": 64,
                  "n_heads": 4, "n_kv": 2, "head_dim": 16, "d_ff": 128,
                  "vocab": 64,
                  "program": [["hyb_full", 1], ["hyb_swa", 2],
                              ["hyb_full", 1]],
                  "window": 8,
                  "ssm": {"d_model": 64, "d_inner": 128, "headdim": 16,
                          "d_state": 8, "n_groups": 1, "conv_width": 4},
                  "ssd_chunk": 16, "flash_block": 16, "q_chunk": 16},
        "traffic": {"batch": 4, "prompt_len": 64, "new_tokens": 8,
                    "warmup_batches": 1, "traced_units": 1,
                    "check": {"requests": 8, "rows": 2}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips where there "
        "is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def bench():
    from harness import spec
    return spec.load()


@pytest.fixture
def small(monkeypatch):
    """``small(cell, compute)``: the benchmark with that cell's
    configuration and traffic at ``SMALL``'s sizes, and the port
    computing in ``compute`` (float32 by default: the CPU's comparisons
    at rounding) for the test."""
    import torch
    from harness import spec
    from repro_torch.models import layers

    def make(cell: str, compute: str = "float32"):
        monkeypatch.setattr(layers, "_COMPUTE", getattr(torch, compute))
        b = spec.load()
        w, over = b.cell(cell), SMALL[cell]
        cfg, mix = b.config(w["config"]), b.traffic(w["traffic"])
        cfg = dict(cfg, model=dict(cfg["model"], **over["model"]))
        mix = dict(mix, **over["traffic"])
        b.config = lambda name: cfg
        b.traffic = lambda name: mix
        return b
    return make
