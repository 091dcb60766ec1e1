"""Deterministic sharded data pipeline with background prefetch.

A copy of the JAX package's numpy pipeline: the same config, seed and step
give bit-equal batches in both packages.

Each host materializes only its shard of the global batch (seeded,
reproducible, restart-exact via the step counter — the pipeline state that a
checkpoint needs is a single integer).  A bounded prefetch thread overlaps
host-side batch synthesis with device compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["PipelineConfig", "SyntheticTokens", "Prefetcher", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    frontend: str = "tokens"       # tokens | frames
    d_model: int = 0               # for frames
    start_step: int = 0


class SyntheticTokens:
    """Zipf-ish synthetic corpus: deterministic per (seed, step, host)."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.step = cfg.start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, self.step, cfg.host_id))
        b = cfg.global_batch // cfg.num_hosts
        self.step += 1
        if cfg.frontend == "frames":
            frames = rng.standard_normal(
                (b, cfg.seq_len, cfg.d_model)).astype(np.float32) * 0.1
            labels = rng.integers(0, cfg.vocab, (b, cfg.seq_len),
                                  dtype=np.int32)
            return {"frames": frames, "labels": labels}
        # zipf-flavoured token draw, clipped to vocab
        raw = rng.zipf(1.3, size=(b, cfg.seq_len + 1))
        toks = np.minimum(raw, cfg.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -- checkpointable state -------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


class Prefetcher:
    """Bounded background prefetch over any batch iterator."""

    def __init__(self, it, depth: int = 2):
        self.it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_pipeline(cfg: PipelineConfig, prefetch: int = 2):
    src = SyntheticTokens(cfg)
    return src, (Prefetcher(src, depth=prefetch) if prefetch else src)
