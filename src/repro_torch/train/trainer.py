"""Training loop: step factory, metrics, fault-tolerance hooks.

``make_train_step`` returns a (params, opt_state, batch) -> (params,
opt_state, metrics) function that updates params and optimizer state in
place (the reference donates them to its jitted step).  The
:class:`Trainer` drives it with a checkpoint hook and straggler tracking.
The data-parallel variant that reduces gradients once per step is
``make_train_step_reduce_once``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from ..distributed import sharding as shd
from ..models.model import LM, plain_as_replicated
from ..models.params import tree_leaves, tree_map
from .optimizer import OptimizerConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_train_step_reduce_once",
           "make_eval_step", "value_and_grad", "place_batch", "Trainer",
           "TrainState"]


def value_and_grad(model: LM, params, batch, grads=None) -> tuple:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``.  The
    gradients accumulate into ``grads`` when it is given (a tree like
    ``params``), else into a fresh zeroed one."""
    if grads is None:
        grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad(), plain_as_replicated(params):
        loss, metrics = model.loss(model.trainable(params, grads), batch)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(batch: dict, n: int) -> list:
    """``n`` microbatches of ``batch`` along its leading dimension."""
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _rows_split(t) -> bool:
    """Whether ``t`` is a DTensor whose leading dim is split over more
    than one rank."""
    if not shd.is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(pl, Shard) and pl.dim == 0 and n > 1
               for pl, n in zip(t.placements, t.device_mesh.shape))


def _split_sharded(batch: dict, n: int) -> list:
    """``_split`` of a batch whose rows are split over ranks: microbatch
    ``i`` is the ``i``-th block of every rank's own rows, split over the
    same ranks (a logical chunk would first gather the whole batch to
    every rank).  Where a rank holds fewer rows than ``n`` (``n`` a
    multiple of them), each of its rows is a microbatch of one row a
    rank: fewer microbatches, each in the least working set the mesh
    allows."""
    from torch.distributed.tensor import DTensor
    local = {k: v.to_local() for k, v in batch.items()}
    rows = next(iter(local.values())).shape[0]
    if rows < n and n % rows == 0:
        n = rows
    if rows % n:
        raise ValueError(f"{rows} rows a rank are not {n} microbatches")
    return [{k: DTensor.from_local(local[k].chunk(n)[i].clone(), v.device_mesh,
                                   v.placements, run_check=False)
             for k, v in batch.items()} for i in range(n)]


def make_train_step(model: LM, opt_cfg: OptimizerConfig,
                    grad_accum: int = 1) -> Callable:
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_accum`` > 1 runs the microbatches one after another and sums
    their gradients in f32 (one buffer like ``params``) before a single
    optimizer step: the activation working set shrinks by the
    accumulation factor.  A batch of DTensors split over their rows is
    split on each rank (``_split_sharded``): a microbatch then holds
    other rows than the reference's contiguous one.  The step still
    averages over the same rows; only a term computed over a whole
    microbatch (the MoE's load-balance loss, its expert capacity) sees
    other groups of rows.
    """
    def train_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} is not {grad_accum} "
                             f"microbatches")
        if grad_accum == 1:
            micro = [batch]
        elif all(_rows_split(v) for v in batch.values()):
            micro = _split_sharded(batch, grad_accum)
        else:
            micro = _split(batch, grad_accum)
        grads = tree_map(torch.zeros_like, params)
        losses, per_micro = [], []
        for mb in micro:
            loss, metrics, _ = value_and_grad(model, params, mb, grads)
            losses.append(loss)
            per_micro.append(metrics)
        with torch.no_grad():
            tree_map(lambda g: g.div_(len(micro)), grads)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        metrics["loss"] = torch.stack(losses).sum() / len(micro)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)
    return train_step


def _submesh_view(t, sub):
    """A leaf as the reduce-once body sees it: the full-mesh DTensor
    ``t`` (replicated over the data axes) as a DTensor over the model
    sub-mesh ``sub`` sharing its storage, or its plain local tensor where
    ``sub`` is None (no model axis of more than one device)."""
    if not shd.is_dtensor(t):
        return t
    local = t.to_local()
    if sub is None:
        return local
    from torch.distributed.tensor import DTensor
    names = t.device_mesh.mesh_dim_names
    pl = tuple(t.placements[names.index(a)] for a in sub.mesh_dim_names)
    return DTensor.from_local(local, sub, pl, run_check=False)


def make_train_step_reduce_once(model: LM, opt_cfg: OptimizerConfig,
                                grad_accum: int, mesh,
                                rules=None) -> Callable:
    """The data-parallel axes run *manually*: each data rank takes its own
    rows of the batch, accumulates its microbatches' gradients locally in
    f32, and the cross-rank reduction happens ONCE per step — one
    all-reduce a gradient leaf and one for the loss and metrics, each
    divided by the data ranks — instead of once per microbatch; then
    AdamW on the full mesh (moments split over ``"data"`` by
    ``adamw_init(..., zero1=True)`` take its ZeRO-1 path).  The model
    axis stays under DTensor: params and optimizer state are DTensors
    over ``mesh`` (replicated over the data axes, moments split over them
    under ZeRO-1); the forward and backward see the params as DTensors
    over the model sub-mesh sharing their storage (plain tensors where
    that sub-mesh is one device).

    The step takes the global batch (the same on every rank, plain or a
    DTensor) and updates params and state in place.  ``step.grads(params,
    batch)`` gives the reduced ``(loss, metrics, grads)`` without the
    update, ``step.apply(params, opt_state, grads)`` the update from them
    (``(opt_state, metrics)``; ``grads`` are scratch afterwards)."""
    import torch.distributed as dist
    sizes = shd.mesh_axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    rules = rules or shd.DEFAULT_RULES
    ndp = math.prod(sizes[a] for a in dp_axes)
    rest = tuple(a for a in sizes if a not in dp_axes)
    sub = mesh[rest] if rest and math.prod(
        sizes[a] for a in rest) > 1 else None
    row = 0
    for a in dp_axes:                               # major first
        row = row * sizes[a] + mesh.get_local_rank(a)

    def rows(t):
        if shd.is_dtensor(t):
            t = t.full_tensor()
        if t.shape[0] % ndp:
            raise ValueError(f"batch of {t.shape[0]} does not split over "
                             f"{ndp} data ranks")
        n = t.shape[0] // ndp
        return t[row * n:(row + 1) * n]

    def reduce_once(x):
        for a in dp_axes:
            dist.all_reduce(x, group=mesh.get_group(a))
        return x.div_(ndp)

    def grads_of(params, batch):
        local = tree_map(lambda t: _submesh_view(t, sub), params)
        mine = {k: rows(v) for k, v in batch.items()}
        with shd.use_sharding(mesh, rules, manual=frozenset(dp_axes)):
            n = next(iter(mine.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"{n} rows a data rank are not "
                                 f"{grad_accum} microbatches")
            grads = tree_map(torch.zeros_like, local)
            losses, per_micro = [], []
            for mb in _split(mine, grad_accum):
                loss, metrics, _ = value_and_grad(model, local, mb, grads)
                losses.append(loss)
                per_micro.append(metrics)
        with torch.no_grad():
            for g in tree_leaves(grads):             # THE one reduction
                reduce_once(g.to_local() if shd.is_dtensor(g) else g
                            ).div_(grad_accum)

            def value(t):
                return t.to_local() if shd.is_dtensor(t) else t
            keys = sorted(per_micro[0])
            vals = torch.stack(
                [torch.stack([value(l) for l in losses]).sum() / grad_accum]
                + [torch.stack([value(m[k]) for m in per_micro]).mean()
                   for k in keys]).float()
            vals = reduce_once(vals)
        return vals[0], dict(zip(keys, vals[1:])), local, grads

    def apply(params, opt_state, grads):
        # the reduced gradients are whole over the data axes, as the
        # params are: seen as full-mesh DTensors with the params'
        # placements, so that ZeRO-1 moments (split over "data") take
        # ``adamw_update``'s sliced path
        from torch.distributed.tensor import DTensor
        full = tree_map(lambda g, p: DTensor.from_local(
            g.to_local() if shd.is_dtensor(g) else g, p.device_mesh,
            p.placements, run_check=False) if shd.is_dtensor(p) else g,
            grads, params)
        _, opt_state, opt_metrics = adamw_update(opt_cfg, full, opt_state,
                                                 params)
        return opt_state, {k: v.to_local() if shd.is_dtensor(v) else v
                           for k, v in opt_metrics.items()}

    def train_step(params, opt_state, batch):
        loss, metrics, _, grads = grads_of(params, batch)
        opt_state, opt_metrics = apply(params, opt_state, grads)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    def reduced_grads(params, batch):
        loss, metrics, _, grads = grads_of(params, batch)
        return loss, metrics, grads

    train_step.grads = reduced_grads
    train_step.apply = apply
    return train_step


def place_batch(batch: dict) -> dict:
    """Under an active sharding context, each batch tensor (the same global
    batch on every rank) as a DTensor split over the "batch" rule's axes
    on its leading dim; without one, the batch itself."""
    ctx = shd.current_ctx()
    if ctx is None or not hasattr(ctx.mesh, "get_group"):
        return batch
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(
        v, ctx.mesh, ctx.placements(("batch",) + (None,) * (v.dim() - 1),
                                    v.shape), src_data_rank=None)
        for k, v in batch.items()}


def make_eval_step(model: LM) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return dict(metrics, loss=loss)
    return eval_step


@dataclasses.dataclass
class TrainState:
    step: int = 0
    step_times: list = dataclasses.field(default_factory=list)


class Trainer:
    """Single-controller training loop with fault-tolerance hooks.

    * every ``ckpt_every`` steps calls ``ckpt_manager.save(step, params)``
      (a :class:`~repro_torch.checkpoint.CheckpointManager`, which merges
      each host's shards on the card before it writes);
    * records per-step wall times; ``straggler_report`` flags outliers;
    * ``resume()`` restores the manager's latest checkpoint: it sets the
      step and returns the flat ``name -> tensor`` map, as the reference
      does.

    Batches come from ``data_iter`` as dicts of numpy arrays and are moved
    to the model's device; a step's time ends with its metrics on the host.
    """

    def __init__(self, model: LM, opt_cfg: OptimizerConfig,
                 data_iter, ckpt_manager=None, ckpt_every: int = 100,
                 straggler_factor: float = 2.0):
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = data_iter
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.state = TrainState()
        self._step_fn = make_train_step(model, opt_cfg)

    def init(self, generator: torch.Generator):
        params = self.model.init(generator)
        return params, adamw_init(params)

    def resume(self, params_template=None):
        if self.ckpt is None:
            raise RuntimeError("no checkpoint manager configured")
        step, params = self.ckpt.restore_latest()
        self.state.step = step
        return params

    def run(self, params, opt_state, num_steps: int,
            log_every: int = 10, log_fn=print):
        history = []
        dev = self.model.device
        for _ in range(num_steps):
            batch = place_batch({k: torch.as_tensor(np.asarray(v),
                                                     device=dev)
                                 for k, v in next(self.data).items()})
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       batch)
            metrics = {k: float(v.full_tensor() if shd.is_dtensor(v)
                                else v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.state.step += 1
            self.state.step_times.append(dt)
            metrics["step_seconds"] = dt
            history.append((self.state.step, metrics))
            if log_every and self.state.step % log_every == 0:
                log_fn(f"step {self.state.step}: "
                       f"loss={metrics['loss']:.4f} "
                       f"grad_norm={metrics['grad_norm']:.3f} "
                       f"({dt*1e3:.0f} ms)")
            if self.ckpt is not None and \
                    self.state.step % self.ckpt_every == 0:
                self.ckpt.save(self.state.step, params)
        return params, opt_state, history

    def straggler_report(self) -> dict:
        """Step-time outlier detection: steps slower than
        ``straggler_factor`` times the median (the first step, which pays
        for setup, is left out)."""
        ts = np.asarray(self.state.step_times[1:])
        if ts.size < 3:
            return {"stragglers": [], "median": None}
        med = float(np.median(ts))
        out = [int(i + 1) for i, t in enumerate(ts)
               if t > self.straggler_factor * med]
        return {"stragglers": out, "median": med,
                "worst": float(ts.max()), "mean": float(ts.mean())}
