"""Training loop: step factory, metrics, fault-tolerance hooks.

``make_train_step`` returns a (params, opt_state, batch) -> (params,
opt_state, metrics) function that updates params and optimizer state in
place (the reference donates them to its jitted step).  The
:class:`Trainer` drives it with a checkpoint hook and straggler tracking.
The data-parallel variant that reduces gradients once per step
(``make_train_step_reduce_once``) waits for the distributed slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..models.model import LM
from ..models.params import tree_map
from .optimizer import OptimizerConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_eval_step", "value_and_grad", "Trainer",
           "TrainState"]


def value_and_grad(model: LM, params, batch, grads=None) -> tuple:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``.  The
    gradients accumulate into ``grads`` when it is given (a tree like
    ``params``), else into a fresh zeroed one."""
    if grads is None:
        grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss, metrics = model.loss(model.trainable(params, grads), batch)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(batch: dict, n: int) -> list:
    """``n`` microbatches of ``batch`` along its leading dimension."""
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(model: LM, opt_cfg: OptimizerConfig,
                    grad_accum: int = 1) -> Callable:
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_accum`` > 1 runs the microbatches one after another and sums
    their gradients in f32 (one buffer like ``params``) before a single
    optimizer step: the activation working set shrinks by the
    accumulation factor.
    """
    def train_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} is not {grad_accum} "
                             f"microbatches")
        grads = tree_map(torch.zeros_like, params)
        losses, per_micro = [], []
        for mb in _split(batch, grad_accum):
            loss, metrics, _ = value_and_grad(model, params, mb, grads)
            losses.append(loss)
            per_micro.append(metrics)
        with torch.no_grad():
            tree_map(lambda g: g.div_(grad_accum), grads)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        metrics["loss"] = torch.stack(losses).sum() / grad_accum
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)
    return train_step


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
            batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                     for k, v in next(self.data).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       batch)
            metrics = {k: float(v) for k, v in metrics.items()}
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
