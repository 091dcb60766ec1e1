"""The program's entries, driven as a cell's traffic file says.

``train``: ``Trainer.run`` one step a call in a closed loop, a fresh batch
of ``rows`` x ``seq_len`` token ids from the seed every step.  Set-up
builds the model, the weights, the optimizer state and the trainer once,
and drives that same trainer through its first ``check_steps`` steps
(the window's own call and feed), keeping what the check compares: each
step's loss, the first gradient as AdamW's first moment holds it after
step 1 and the parameters' change after the last check step, each as
per-layer norms and a seeded sample of entries (``per_layer_stats``).  The window continues from there.

``generate``: ``ServeEngine.generate`` on static batches of ``batch`` x
``prompt_len`` token ids from the seed, ``new_tokens`` greedy tokens, in
a closed loop; set-up warms up on ``warmup_batches`` batches drawn apart
from the window's.  Every finished request's prompt and served tokens
are kept for the check.

With ``trace``, a profiled sub-window of ``traced_units`` steps or
batches follows the untraced one, under ``trace.profile``."""

from __future__ import annotations

import dataclasses
import gc
import time
import zlib

import numpy as np

from reference.params import flatten, specs

from . import trace as tr
from . import weights

__all__ = ["model_config", "per_layer_stats", "run_train", "run_generate",
           "ENTRIES", "Run"]


@dataclasses.dataclass
class Run:
    """What an entry hands back: the window's counts and seconds, the
    set-up's, the observations the per-layer readers take, and what the
    check compares (``check``)."""
    setup_s: float
    window_s: float
    units: int
    tokens: int
    attempted: int
    failed: int
    memory_peak_bytes: int
    obs: dict
    check: dict


def model_config(m: dict):
    """The port's ``ModelConfig`` of a configuration's model section."""
    from repro_torch.models.moe import MoEDims
    from repro_torch.models.ssm import SSMDims
    from repro_torch.models.transformer import ModelConfig
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(m) - known
    if unknown:
        raise ValueError(f"model keys the program does not take: "
                         f"{sorted(unknown)}")
    kw = dict(m, program=tuple(tuple(s) for s in m["program"]))
    if m.get("moe") is not None:
        kw["moe"] = MoEDims(**m["moe"])
    if m.get("ssm") is not None:
        kw["ssm"] = SSMDims(**m["ssm"])
    return ModelConfig(**kw)


#: entries sampled from each per-layer leaf for the check's differences
SAMPLE = 1 << 16


def _per_layer(tree, model: dict, fn=None):
    """``(name, tensor)`` of each leaf of a parameter-shaped tree, a
    stacked segment's leaves split per layer (``name[i]``); ``fn(name,
    t)`` maps each leaf first."""
    for name, t in flatten(tree):
        if fn is not None:
            t = fn(name, t)
        parts = name.split("/")
        if parts[0] == "segments" and model["program"][int(parts[1])][1] > 1:
            for i in range(t.shape[0]):
                yield f"{name}[{i}]", t[i]
        else:
            yield name, t


def sample_index(seed: int, name: str, numel: int) -> np.ndarray:
    """The entries of leaf ``name`` that the check compares, from the
    seed: ``SAMPLE`` of them, or all of a smaller leaf."""
    if numel <= SAMPLE:
        return np.arange(numel)
    rng = np.random.default_rng([seed, 4, zlib.crc32(name.encode())])
    return rng.integers(0, numel, SAMPLE)


def per_layer_stats(tree, model: dict, seed: int, fn=None) -> tuple:
    """``({name: L2 norm}, {name: sampled entries on the host})`` of each
    per-layer leaf (``_per_layer``)."""
    import torch
    norms, samples = {}, {}
    for name, t in _per_layer(tree, model, fn):
        flat = t.detach().reshape(-1)
        norms[name] = float(torch.linalg.vector_norm(flat.float()))
        idx = torch.as_tensor(sample_index(seed, name, flat.numel()),
                              device=flat.device)
        samples[name] = flat[idx].float().cpu()
    return norms, samples


class Feed:
    """Batches of token ids from the seed, one ``numpy`` generator for
    the run; ``kept`` holds the first ``keep`` batches."""

    def __init__(self, seed: int, rows: int, seq: int, vocab: int,
                 keep: int = 0, span: bool = False):
        self.rng = np.random.default_rng([seed, 1])
        self.rows, self.seq, self.vocab = rows, seq, vocab
        self.keep, self.kept = keep, []
        self.span = span

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self.span:
            with tr.span("data"):
                return self._next()
        return self._next()

    def _next(self) -> dict:
        ids = self.rng.integers(0, self.vocab, (self.rows, self.seq + 1),
                                dtype=np.int64)
        batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_train(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
              device, t_start: float) -> Run:
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, Trainer, adamw_init
    m = cfg["model"]
    model = LM(model_config(m), device=device)
    params = weights.make(m, seed, device)
    feed = Feed(seed, mix["rows"], mix["seq_len"], m["vocab"],
                keep=mix["check_steps"])
    trainer = Trainer(model, OptimizerConfig(**mix["optimizer"]), feed)
    opt = adamw_init(params)
    b1 = mix["optimizer"]["b1"]
    losses, grad = [], None
    for step in range(mix["check_steps"]):
        params, opt, hist = trainer.run(params, opt, 1, log_every=0)
        losses.append(hist[-1][1]["loss"])
        if step == 0:
            grad = per_layer_stats(opt["m"], m, seed,
                                   lambda _, t: t / (1 - b1))
    sp = dict(flatten(specs(m)))
    change = per_layer_stats(
        params, m, seed, lambda n, t: t - weights.make_leaf(sp[n], seed, n,
                                                            t.device))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    def step():
        nonlocal params, opt
        params, opt, hist = trainer.run(params, opt, 1, log_every=0)
        return hist[-1][1]["loss"]

    _reset_peak(device)
    steps = failed = 0
    t0 = time.perf_counter()
    while True:
        if not np.isfinite(step()):
            failed += 1
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    tokens_step = mix["rows"] * mix["seq_len"]
    obs = {"entry": "train", "model": m, "rows": mix["rows"],
           "seq_len": mix["seq_len"],
           "untraced": {"units": steps, "seconds": window_s,
                        "tokens": steps * tokens_step},
           "peak_window_bytes": _peak(device)}
    if trace:
        feed.span = True
        with tr.profile() as prof:
            with tr.span(tr.WINDOW):
                for _ in range(mix["traced_units"]):
                    with tr.span("step"):
                        step()
                with tr.span("sync"):
                    _sync(device)
        obs["profiled"] = dict(tr.reduce(prof), units=mix["traced_units"])
        del prof
    peak = _peak(device)
    del trainer, params, opt, model
    _free(device)
    return Run(setup_s=setup_s, window_s=window_s, units=steps,
               tokens=steps * tokens_step, attempted=steps, failed=failed,
               memory_peak_bytes=peak, obs=obs,
               check={"kind": "train", "losses": losses, "grad": grad,
                      "change": change, "batches": feed.kept})


def run_generate(cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float) -> Run:
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    m = cfg["model"]
    model = LM(model_config(m), device=device)
    params = weights.make(m, seed, device)
    B, L, new = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    engine = ServeEngine(model, params, max_len=L + new, device=device)
    warm = np.random.default_rng([seed, 2])
    for _ in range(mix["warmup_batches"]):
        engine.generate(warm.integers(0, m["vocab"], (B, L)), new)
    rng = np.random.default_rng([seed, 1])
    _sync(device)
    setup_s = time.perf_counter() - t_start

    served = []

    def batch():
        prompts = rng.integers(0, m["vocab"], (B, L), dtype=np.int64)
        gen, _ = engine.generate(prompts, new)
        served.append((prompts, gen))
        return gen

    _reset_peak(device)
    batches = 0
    t0 = time.perf_counter()
    while True:
        batch()
        batches += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    obs = {"entry": "generate", "model": m, "rows": B, "seq_len": L,
           "untraced": {"units": batches, "seconds": window_s,
                        "tokens": batches * B * (L + new)},
           "peak_window_bytes": _peak(device)}
    if trace:
        with tr.profile() as prof:
            with tr.span(tr.WINDOW):
                for _ in range(mix["traced_units"]):
                    with tr.span("generate"):
                        batch()
                with tr.span("sync"):
                    _sync(device)
        obs["profiled"] = dict(tr.reduce(prof), units=mix["traced_units"])
        del prof
    peak = _peak(device)
    failed = sum(int(((g < 0) | (g >= m["vocab"])).any(axis=1).sum())
                 for _, g in served)
    del engine, params, model
    _free(device)
    return Run(setup_s=setup_s, window_s=window_s, units=batches,
               tokens=batches * B * L, attempted=len(served) * B,
               failed=failed, memory_peak_bytes=peak, obs=obs,
               check={"kind": "generate", "served": served})


ENTRIES = {"train": run_train, "generate": run_generate}
