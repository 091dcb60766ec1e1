"""Online data-layout reorganization policy (paper §5) — thin wrappers.

:mod:`repro_torch.core.cost_model` (:func:`~repro_torch.core.cost_model.
recommend`) chooses *when to reorganize* — on-the-fly vs post-hoc;
:class:`~repro_torch.core.policy.LayoutPolicy` chooses *what layout* from
the observed access mix.  A copy of the JAX package's module:

  * on-the-fly: :class:`repro_torch.io.staging.StagingExecutor` consumes
    the plans produced here while the producer keeps computing;
  * post-hoc: :func:`repro_torch.io.reorganize` reads a written dataset
    back — gathering every new chunk on the card — and re-writes it with
    the reorganized plan.

:mod:`repro_torch.checkpoint.async_ckpt` calls :func:`decide` to answer,
per run, the paper's "should I spend 1% extra nodes on staging" question.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from . import cost_model
from .blocks import Block
from .layouts import LayoutPlan, plan_layout

__all__ = ["ReorgDecision", "plan_reorganization", "decide"]


@dataclasses.dataclass(frozen=True)
class ReorgDecision:
    mode: str                     # "on_the_fly" | "post_hoc" | "none"
    utilization_on_the_fly: float
    utilization_post_hoc: float
    blocking: bool
    breakeven_N: int | None
    timings: cost_model.StagingTimings


def plan_reorganization(blocks: Sequence[Block],
                        global_shape: Sequence[int],
                        scheme: Sequence[int] | None = None,
                        num_stagers: int = 1) -> LayoutPlan:
    """Target layout for reorganization: regular ``scheme`` decomposition
    (paper §5.2 uses 4x4x4 = 64 chunks for a 2048x4096x4096 variable).

    ``scheme=None`` picks the dimension-aware default
    (:func:`~repro_torch.core.layouts.default_reorg_scheme`) — 4x4x4 for 3-D
    variables, rank-matched factorizations otherwise; the historical fixed
    ``(4, 4, 4)`` silently mismatched 2-D/4-D variables.  For a scheme
    derived from *observed* access patterns, use
    :meth:`repro_torch.core.policy.LayoutPolicy.choose_layout`.
    """
    return plan_layout("reorganized", blocks, num_procs=0,
                       global_shape=global_shape, reorg_scheme=scheme,
                       num_stagers=num_stagers)


def decide(timings: cost_model.StagingTimings, t_c: float, N: int,
           min_saving_frac: float = 0.0) -> ReorgDecision:
    """Pick the reorganization mode that minimizes chip/node-seconds.

    ``min_saving_frac``: require on-the-fly to beat post-hoc by at least this
    fraction before paying its operational complexity (default: any win).
    """
    rec = cost_model.recommend(timings, t_c, N)
    u_o, u_p = rec["on_the_fly"], rec["post_hoc"]
    mode = "on_the_fly" if u_o < u_p * (1.0 - min_saving_frac) else "post_hoc"
    return ReorgDecision(mode=mode, utilization_on_the_fly=u_o,
                         utilization_post_hoc=u_p, blocking=rec["blocking"],
                         breakeven_N=rec["breakeven_N"], timings=timings)
