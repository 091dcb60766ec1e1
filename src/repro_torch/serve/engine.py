"""Batched serving: prefill + decode with a persistent KV cache.

``make_prefill_step`` / ``make_decode_step`` produce the step functions;
:class:`ServeEngine` drives them for batched generation, updating the
cache in place (where the reference donates its buffers).  On the card
the timings are CUDA events read once the generated tokens reach the
host, so timing stalls nothing; on the CPU the host's clock.  Under a
profiler the prefill and each decode step are spans
(``repro_torch.serve.prefill``, ``repro_torch.serve.decode``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import LM
from ..models.params import tree_leaves
from ..spans import span

__all__ = ["make_prefill_step", "make_decode_step", "GenStats",
           "ServeEngine"]


def make_prefill_step(model: LM, cache_len: int | None = None) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(model: LM) -> Callable:
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return serve_step


@dataclasses.dataclass
class GenStats:
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    tokens_generated: int = 0

    @property
    def decode_tps(self) -> float:
        return self.tokens_generated / max(self.decode_seconds, 1e-9)


class ServeEngine:
    """Static-batch generation engine (greedy / temperature sampling) on
    ``device`` (the card unless the caller asks for ``"cpu"``); ``params``
    must lie there."""

    def __init__(self, model: LM, params, max_len: int = 512,
                 device="cuda"):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        where = tree_leaves(params)[0].device
        if where.type != self.device.type:
            raise ValueError(f"params on {where}, engine on {self.device}")
        self._prefill = make_prefill_step(model, cache_len=max_len)
        self._decode = make_decode_step(model)

    def _mark(self):
        """A point on the engine's timeline: a CUDA event recorded on the
        engine's card's current stream, or the host's clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def _seconds(a, b) -> float:
        """Seconds from mark ``a`` to mark ``b``; waits for ``b`` on the
        card."""
        if isinstance(a, float):
            return b - a
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    @torch.inference_mode()
    def generate(self, tokens, num_new: int, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 extra: dict | None = None) -> tuple:
        """``tokens``: (B, L) prompt. Returns (generated (B, num_new) int32
        ndarray, stats).  Temperature sampling draws from ``generator``
        (on the engine's device; a fresh one seeded 0 if none).  ``extra``
        joins the prefill's batch (a VLM's ``memory`` tokens); decode
        reads what the prefill cached of it."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        B, L = tokens.shape
        if L + num_new > self.max_len:
            raise ValueError("exceeds engine max_len")
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        batch = {"tokens": tokens}
        if extra:
            batch.update(extra)
        t0 = self._mark()
        with span("repro_torch.serve.prefill"):
            logits, cache = self._prefill(self.params, batch)
            cur = self._sample(logits[:, -1], temperature, generator)
        t1 = self._mark()

        out = []
        pos = L
        for _ in range(num_new):
            out.append(cur)
            with span("repro_torch.serve.decode"):
                logits, cache = self._decode(self.params, cache, cur, pos)
                cur = self._sample(logits[:, -1], temperature, generator)
            pos += 1
        t2 = self._mark()
        gen = torch.cat(out, dim=1) if out else tokens[:, :0]
        gen = gen.to(torch.int32).cpu().numpy()
        stats = GenStats(prefill_seconds=self._seconds(t0, t1),
                         decode_seconds=self._seconds(t1, t2),
                         tokens_generated=num_new * B)
        return gen, stats

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
