"""AdamW with tree state, cosine schedule and global-norm clipping, and
ZeRO-1 moments.

The update runs in place under ``torch.no_grad``: the reference donates
params and optimizer state to its jitted step, and an out-of-place update
of a 3B-parameter model would hold a second copy of params, m and v.
``zero_moment_defs`` returns the moments' ``ParamDef``s with the extra
"zero_data" axis the reference shards them on (``launch/specs.py`` places
its moments so); ``adamw_init(..., zero1=True)`` places m and v so under
the active sharding context, and ``adamw_update`` takes moments whose
placements differ from their params': each rank updates its slice of the
param, then gathers the param back, which the reference's jitted step
does for free.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.sharding import is_dtensor
from ..models.params import ParamDef, tree_leaves, tree_map
from ..spans import span

__all__ = ["OptimizerConfig", "warmup_cosine", "adamw_init", "adamw_update",
           "global_norm", "zero_moment_defs"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = False           # shard moments over the data axis


def warmup_cosine(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as an f32 tensor
    on ``step``'s device: linear warmup to ``peak_lr``, then a cosine to
    ``end_lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, zero1: bool = False, skeleton=None) -> dict:
    """Zero moments like ``params`` and a step count of 0 (int32, on the
    params' device).  With ``zero1`` (DTensor params under an active
    sharding context; ``skeleton``, the params' ``ParamDef`` tree, gives
    their logical axes) m and v are placed by ``zero_moment_defs``: split
    over ``"data"`` on the largest dim the rules leave whole, where it
    divides, so each data rank holds its slice of them."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    if zero1:
        if skeleton is None:
            raise ValueError("zero1 moments need the params' skeleton")
        from torch.distributed.tensor import zeros as dzeros
        from ..distributed.sharding import current_ctx
        ctx = current_ctx()
        if ctx is None or not hasattr(ctx.mesh, "get_group"):
            raise ValueError("zero1 moments need an active sharding "
                             "context over a DeviceMesh")

        def zero(d: ParamDef, p):
            return dzeros(d.shape, dtype=torch.float32,
                          device_mesh=p.device_mesh,
                          placements=ctx.placements(d.axes, d.shape,
                                                    mesh=p.device_mesh))
        mdefs = zero_moment_defs(skeleton)
        return {"m": tree_map(zero, mdefs, params),
                "v": tree_map(zero, mdefs, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.  Updates
    ``params`` (f32, as every ``ParamDef`` of the ported models) and the
    moments in place and uses ``grads`` as scratch (its values are gone
    afterwards); ``state["count"]`` is replaced."""
    with span("repro_torch.adamw"):
        # a sharded model's gradient of a replicated param may come back as
        # a partial sum (``Partial``): reduced to the param's placements
        # first, or the update would add each rank's term as the whole
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                     p.placements)
                         if is_dtensor(g) and g.placements != p.placements
                         else g, grads, params)
        count = state["count"] + 1
        lr = warmup_cosine(cfg, count)
        gn = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
        c = count.float()
        bc1 = 1 - torch.pow(torch.full_like(c, cfg.b1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, cfg.b2), c)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            if not p.dtype == g.dtype == torch.float32:
                raise TypeError(f"AdamW updates f32 params from f32 grads; "
                                f"got {p.dtype}, {g.dtype}")
            if is_dtensor(m) and m.placements != p.placements:
                _zero1_leaf(cfg, g, m, v, p, scale, lr, bc1, bc2)
            else:
                _adamw_leaf(cfg, g, m, v, p, scale, lr, bc1, bc2)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gn, "lr": lr}


def _adamw_leaf(cfg, g, m, v, p, scale, lr, bc1, bc2) -> None:
    """One leaf's update, in place: m, v and p; g becomes the step."""
    g.mul_(scale)
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
    # g becomes the step: mh / (sqrt(vh) + eps) + wd * p
    torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)
    torch.div(torch.div(m, bc1), g, out=g)
    g.add_(p, alpha=cfg.weight_decay)
    p.sub_(g.mul_(lr))


def _zero1_leaf(cfg, g, m, v, p, scale, lr, bc1, bc2) -> None:
    """A leaf whose moments are split where its param is not (ZeRO-1):
    this rank's slices of g and p (the param and its gradient are whole
    over the axes the moments split, so taking a slice moves nothing)
    take the same elementwise update as ``_adamw_leaf`` on the local
    blocks, then the param is gathered back to its placements."""
    def local(t):
        return t.to_local() if is_dtensor(t) else t
    mesh, want = m.device_mesh, m.placements
    gz = g.redistribute(mesh, want)
    pz = p.redistribute(mesh, want)
    _adamw_leaf(cfg, gz.to_local(), m.to_local(), v.to_local(),
                pz.to_local(), local(scale), local(lr), local(bc1),
                local(bc2))
    p.to_local().copy_(pz.redistribute(mesh, p.placements).to_local())


def zero_moment_defs(skel):
    """Moment ParamDefs with an extra 'data' shard on the largest divisible
    dim (ZeRO-1)."""
    def zdef(d: ParamDef) -> ParamDef:
        axes = list(d.axes)
        # carry the data axis on the largest dim that the default rules
        # leave replicated (None, or "embed"/"head_dim"/"state" which map
        # to no mesh axis in non-FSDP runs)
        order = sorted(range(len(d.shape)), key=lambda i: -d.shape[i])
        for i in order:
            if axes[i] in (None, "embed", "head_dim", "state") \
                    and d.shape[i] >= 2:
                axes[i] = "zero_data"
                break
        return ParamDef(d.shape, tuple(axes), "float32", "zeros")
    return tree_map(zdef, skel)
