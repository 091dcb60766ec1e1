"""Flop parity of the port's op-level count with the JAX package's HLO
count: every smoke config's forward (``LM.loss``) and train-step
gradients (``value_and_grad``) on one device, batch 2 x 64, remat
``none``, counted by ``launch/op_analysis.analyze_ops`` against
``analyze_hlo`` of the reference's compiled ``jit(loss)`` and
``jit(grad(loss))``.  The frames (hubert-xlarge) and memory
(llama-3.2-vision-90b) archs take their inputs.

Every forward is equal.  The train steps are equal but for the SSD
layers: per SSD layer the reference's scan computes three products of
2·B·H·N·P·Q flops that the port's autograd skips, the incoming state's
cotangent at the first chunk (the state starts as zeros, which need no
gradient) and the last chunk's state update's two input cotangents (the
final state goes to the cache, not to the loss); ``_ssd_gap`` pins
them.  The archs are split over this file and
``tests/test_torch_op_parity_rest.py`` (each file under a minute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.configs import list_archs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import LM as JLM

B, L = 2, 64
#: this file's archs; the rest are ``test_torch_op_parity_rest.py``'s
ARCHS = list_archs()[:5]


def _batch(cfg, rng):
    out = {}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    else:
        out["frames"] = rng.standard_normal((B, L, cfg.d_model)).astype(
            np.float32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    if cfg.family == "vlm":
        out["memory"] = rng.standard_normal(
            (B, cfg.n_memory_tokens, cfg.d_model)).astype(np.float32)
    return out


def _ssd_gap(cfg) -> float:
    """The reference's extra flops of a train step: 3 products of
    2·B·H·N·P·Q a SSD layer (hybrid layers hold one)."""
    from repro_torch.models.transformer import COMPOSITE
    if cfg.ssm is None:
        return 0.0

    def ssd_layers(kind):
        if kind in COMPOSITE:
            return sum(ssd_layers(s.split(":")[1]) for s in COMPOSITE[kind])
        return int(kind == "ssd" or kind.startswith("hyb"))
    n = sum(ssd_layers(k) * c for k, c in cfg.program)
    d = cfg.ssm
    Q = cfg.ssd_chunk if L % cfg.ssd_chunk == 0 else L
    return 3 * 2.0 * B * d.n_heads * d.d_state * d.headdim * Q * n


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_the_reference_hlo_count(arch):
    check_flops(arch)


def check_flops(arch):
    """The forward's flops equal the reference's, the train step's less
    the pinned SSD products."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.models import LM
    from repro_torch.train.trainer import value_and_grad
    jcfg = jsmoke(arch)
    assert jcfg.remat == "none" and not jcfg.flash
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    host = _batch(jcfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k in ("frames", "memory")
                         else None) for k, v in host.items()}

    def loss(p, b):
        return jm.loss(p, b)[0]
    ref_fwd = analyze_hlo(jax.jit(loss).lower(params, jb).compile()
                          .as_text()).flops
    ref_train = analyze_hlo(jax.jit(jax.grad(loss)).lower(params, jb)
                            .compile().as_text()).flops

    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    tp = model.init(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v).to(torch.bfloat16)
          if k in ("frames", "memory") else torch.from_numpy(v)
          for k, v in host.items()}
    with torch.no_grad():
        fwd = analyze_ops(model.loss, tp, tb).flops
    train = analyze_ops(value_and_grad, model, tp, tb).flops
    assert fwd == ref_fwd
    assert train - ref_train == -_ssd_gap(cfg)
