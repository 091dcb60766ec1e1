"""Faults planted in the program under test, for the tests and for
``calibrate.py``: each a context manager that breaks the timed path
underneath the harness and restores it on exit.

``state_unchanged``: the optimizer step returns the state it was given.
``half_batch``: the loss is taken over half of the batch (half of the
rows, or of the positions of a single row), the mean over the rest.
``token_altered``: every served token is the next id after the one the
model chose."""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "plant"]


@contextlib.contextmanager
def _state_unchanged():
    from repro_torch.train import trainer

    def frozen(cfg, grads, state, params):
        import torch
        return params, dict(state, count=state["count"] + 1), \
            {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}
    saved = trainer.adamw_update
    trainer.adamw_update = frozen
    try:
        yield
    finally:
        trainer.adamw_update = saved


@contextlib.contextmanager
def _half_batch():
    from repro_torch.models.model import LM
    saved = LM.loss

    def half(self, params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows > 1:
            batch = {k: v[:rows // 2] for k, v in batch.items()}
        else:
            n = next(iter(batch.values())).shape[1] // 2
            batch = {k: v[:, :n] for k, v in batch.items()}
        return saved(self, params, batch)
    LM.loss = half
    try:
        yield
    finally:
        LM.loss = saved


@contextlib.contextmanager
def _token_altered():
    from repro_torch.serve.engine import ServeEngine
    saved = ServeEngine.__dict__["_sample"]

    def altered(logits, temperature, generator):
        return (saved.__func__(logits, temperature, generator) + 1) \
            % logits.shape[-1]
    ServeEngine._sample = staticmethod(altered)
    try:
        yield
    finally:
        ServeEngine._sample = saved


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def plant(name: str | None):
    return contextlib.nullcontext() if name is None else FAULTS[name]()
