"""Fake stand-ins for every model input: the dry run traces against these
(DTensors under ``FakeTensorMode``, placed by the active sharding context,
allocating nothing), as the JAX package lowers against its
``ShapeDtypeStruct``s.

``build_cell(arch, shape)`` returns the step function and fake args for one
(architecture x shape) cell under the ACTIVE sharding context; the cell
owns the ``FakeTensorMode`` its args belong to, and its step runs under
that mode (``with cell.fake_mode: cell.fn(*cell.args)``).  Without a
context over a ``DeviceMesh`` the args are plain fake tensors.  A decode
cell's position is the cache's last slot (the port's decode step takes
it as an int, the reference's as a traced scalar).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs import get_config, shapes_for, skip_reason
from ..configs.common import ShapeCell
from ..distributed import sharding as shd
from ..models.model import LM
from ..models.params import ParamDef, count_params, torch_dtype, tree_map
from ..serve.engine import make_decode_step, make_prefill_step
from ..train.optimizer import OptimizerConfig, zero_moment_defs
from ..train.trainer import make_train_step

__all__ = ["build_cell", "Cell", "model_flops_estimate", "fake_leaf"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeCell
    fn: Callable
    args: tuple
    donate: tuple
    model: LM
    model_flops: float          # 6ND-style useful flops for the cell
    fake_mode: object = None    # the FakeTensorMode of ``args``


def fake_leaf(fake_mode, shape, dtype, logical_axes, device):
    """A fake tensor of ``shape`` and ``dtype`` on ``device``: under an
    active context over a ``DeviceMesh``, a DTensor placed by the rules'
    placements of ``logical_axes`` (each rank's block fake too)."""
    from torch.distributed.tensor import distribute_tensor
    shape = tuple(int(s) for s in shape)
    with fake_mode:
        t = torch.empty(shape, dtype=dtype, device=device)
        ctx = shd.current_ctx()
        if ctx is None or not hasattr(ctx.mesh, "get_group"):
            return t
        return distribute_tensor(t, ctx.mesh,
                                 ctx.placements(logical_axes, shape),
                                 src_data_rank=None)


def _fake_tree(fake_mode, defs, device):
    return tree_map(lambda d: fake_leaf(fake_mode, d.shape,
                                        torch_dtype(d.dtype), d.axes,
                                        device), defs)


def _batch_specs(fake_mode, cfg, B: int, L: int, with_labels: bool,
                 device) -> dict:
    def leaf(shape, dtype, axes):
        return fake_leaf(fake_mode, shape, dtype, axes, device)
    out = {}
    if cfg.frontend == "tokens":
        out["tokens"] = leaf((B, L), torch.int32, ("batch", None))
    else:
        out["frames"] = leaf((B, L, cfg.d_model), torch.bfloat16,
                             ("batch", None, "act_embed"))
    if with_labels:
        out["labels"] = leaf((B, L), torch.int32, ("batch", None))
    if cfg.family == "vlm":
        out["memory"] = leaf((B, cfg.n_memory_tokens, cfg.d_model),
                             torch.bfloat16, ("batch", None, "act_embed"))
    return out


def model_flops_estimate(model: LM, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N_active*D for single forward
    (prefill) / per-token (decode); MoE counts active experts only."""
    cfg = model.cfg
    total = count_params(model.skeleton())
    active = total
    if cfg.moe is not None:
        expert_params = 0
        for seg in model.skeleton()["segments"]:
            if isinstance(seg, dict) and "moe" in seg:
                for nm in ("w_gate", "w_up", "w_down"):
                    expert_params += math.prod(seg["moe"][nm].shape)
        active = total - expert_params \
            + expert_params * (cfg.moe.top_k / cfg.moe.n_experts)
    D = cell.seq_len * cell.global_batch
    if cell.kind == "train":
        return 6.0 * active * D
    if cell.kind == "prefill":
        return 2.0 * active * D
    return 2.0 * active * cell.global_batch      # decode: one token per seq


def build_cell(arch: str, shape_name: str,
               opt_cfg: OptimizerConfig | None = None,
               zero1: bool = False,
               overrides: dict | None = None, device="cuda",
               cfg=None, shape: ShapeCell | None = None) -> Cell:
    """The cell's step and fake args on ``device`` (the card's, unless the
    caller asks for ``"cpu"``); ``cfg`` and ``shape`` replace the
    registered config and shape cell (a cut or smoke one) where given."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    if overrides:
        moe_over = overrides.pop("moe_dispatch", None)
        cfg = dataclasses.replace(cfg, **overrides)
        if moe_over and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_over))
    cell = shape or next(s for s in shapes_for(arch)
                         if s.name == shape_name)
    reason = skip_reason(arch, shape_name)
    if reason:
        raise ValueError(f"cell ({arch} x {shape_name}) is a documented "
                         f"skip: {reason}")
    dev = torch.device(device)
    model = LM(cfg, device=dev)
    skel = model.skeleton()
    fm = FakeTensorMode()
    params = _fake_tree(fm, skel, dev)
    flops = model_flops_estimate(model, cell)

    if cell.kind == "train":
        opt_cfg = opt_cfg or OptimizerConfig(zero1=zero1)
        mdefs = zero_moment_defs(skel) if (zero1 or opt_cfg.zero1) else \
            tree_map(lambda d: ParamDef(d.shape, d.axes, "float32",
                                        "zeros"), skel)
        opt = {"m": _fake_tree(fm, mdefs, dev),
               "v": _fake_tree(fm, mdefs, dev),
               "count": fake_leaf(fm, (), torch.int32, (), dev)}
        batch = _batch_specs(fm, cfg, cell.global_batch, cell.seq_len,
                             True, dev)
        fn = make_train_step(model, opt_cfg, grad_accum=cfg.grad_accum)
        return Cell(arch, cell, fn, (params, opt, batch), donate=(0, 1),
                    model=model, model_flops=flops, fake_mode=fm)

    if cell.kind == "prefill":
        batch = _batch_specs(fm, cfg, cell.global_batch, cell.seq_len,
                             False, dev)
        fn = make_prefill_step(model, cache_len=cell.seq_len)
        return Cell(arch, cell, fn, (params, batch), donate=(),
                    model=model, model_flops=flops, fake_mode=fm)

    # decode: one new token against a cache of seq_len
    cache = _fake_tree(fm, model.cache_skeleton(cell.global_batch,
                                                cell.seq_len), dev)
    tokens = fake_leaf(fm, (cell.global_batch, 1), torch.int32,
                       ("batch", None), dev)
    fn = make_decode_step(model)
    return Cell(arch, cell, fn, (params, cache, tokens, cell.seq_len - 1),
                donate=(1,), model=model, model_flops=flops, fake_mode=fm)
