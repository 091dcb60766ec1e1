"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``perfbench/reference``), recomputed from
the same seed and inputs once the program's state is freed.

Training: the reference follows the program's first check steps on the
same batches, in float32 with TF32 off, each layer recomputed in the
backward pass so that it fits beside its optimizer state.  Numbers:
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``,
the largest gap between the program's and the reference's norm of a
leaf's first gradient (as AdamW clipped it), over the larger of that
leaf's reference norm and the median leaf's; ``update_gap``, the same for
the change of each leaf over the check steps, leaving out leaves whose
reference gradient is under ``NOUGHT`` of the median leaf's (their change
is AdamW's rounding alone); ``grad_diff`` and ``update_diff`` (and their
``_median``), the worst (the median) leaf's root-mean-square difference
on a seeded sample of its entries, scaled alike.  A leaf is one layer's
slice of a stacked segment.  The cell's limits file names the numbers
that are compared.

Serving: a sample of the finished requests drawn from the seed, always
with the last one in it; the reference runs once over each prompt
followed by its served tokens (but the last) and gives the logits where
each served token was chosen.  Compared: ``logit_gap``, the widest gap by
which a served token's reference logit lies below the reference's best
there.

``precision`` runs the reference at a lower precision in the program's
place: the control (``calibrate.py``)."""

from __future__ import annotations

import statistics

import numpy as np

from reference import adamw, lm
from reference.params import flatten, specs

from . import weights
from .entries import per_layer_stats

__all__ = ["NOUGHT", "train_reference", "train_numbers", "worst_leaves",
           "serve_sample", "serve_numbers", "numbers", "judge"]

NOUGHT = 1e-3


def train_reference(model: dict, opt: dict, seed: int, batches: list,
                    device, precision: str = "float32") -> dict:
    """The reference's losses, first gradient and change over
    ``batches`` from the weights the seed gives, as ``per_layer_stats``."""
    import torch
    params = weights.make(model, seed, device)
    named = flatten(params)
    leaves = [t.requires_grad_(True) for _, t in named]
    opt_ = adamw.AdamW(opt, leaves)
    losses, grad = [], None
    with lm.highest_precision():
        for i, b in enumerate(batches):
            tok = torch.as_tensor(b["tokens"], device=device)
            lab = torch.as_tensor(b["labels"], device=device)
            loss, _ = lm.loss(params, model, tok, lab, precision, remat=True)
            loss.backward()
            losses.append(float(loss.detach()))
            scale = opt_.step(leaves, [t.grad for t in leaves])
            if i == 0:
                grad = per_layer_stats(
                    weights.unflatten({n: t.grad for n, t in named}), model,
                    seed, lambda _, g: g * scale)
            for t in leaves:
                t.grad = None
    sp = dict(flatten(specs(model)))
    with torch.no_grad():
        change = per_layer_stats(
            params, model, seed,
            lambda n, t: t - weights.make_leaf(sp[n], seed, n, t.device))
    del params, named, leaves, opt_
    return {"losses": losses, "grad": grad, "change": change}


def _norm_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap of norms, over the larger of its reference
    norm and the median leaf's."""
    med = statistics.median(want[n] for n in keep)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in keep)


def _diffs(got: dict, want: dict, keep) -> dict:
    """Each leaf's root-mean-square difference on its sampled entries,
    over the larger of its reference's and the median leaf's."""
    rms = {n: float(want[n].square().mean().sqrt()) for n in keep}
    med = statistics.median(rms.values())
    return {n: float((got[n] - want[n]).square().mean().sqrt())
            / max(rms[n], med, 1e-30) for n in keep}


def _leaf_diffs(got: dict, ref: dict) -> tuple:
    """The first gradient's and the change's ``_diffs``, the change's
    over the leaves whose reference gradient is not nought."""
    g = ref["grad"][0]
    med = statistics.median(g.values())
    moved = [n for n, v in g.items() if v >= NOUGHT * med]
    return (_diffs(got["grad"][1], ref["grad"][1], list(g)),
            _diffs(got["change"][1], ref["change"][1], moved), moved)


def train_numbers(got: dict, ref: dict) -> dict:
    g = ref["grad"][0]
    grad_d, change_d, moved = _leaf_diffs(got, ref)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": _norm_gap(got["grad"][0], g, list(g)),
            "update_gap": _norm_gap(got["change"][0], ref["change"][0],
                                    moved),
            "grad_diff": max(grad_d.values()),
            "grad_diff_median": statistics.median(grad_d.values()),
            "update_diff": max(change_d.values()),
            "update_diff_median": statistics.median(change_d.values())}


def worst_leaves(got: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves that read worst in ``grad_diff`` and
    ``update_diff``, each with its reading, its reference norm over the
    median leaf's, and its reference gradient's over the median's, and
    the leaves left out of the change as nought (``calibrate.py``'s look
    at what a worst leaf is)."""
    g = ref["grad"][0]
    gmed = statistics.median(g.values())
    grad_d, change_d, moved = _leaf_diffs(got, ref)
    out = {"left_out": sorted(set(g) - set(moved))}
    for key, d, norms in zip(("grad_diff", "update_diff"),
                             (grad_d, change_d), (g, ref["change"][0])):
        cmed = statistics.median(norms.values())
        out[key] = [[name, v, norms[name] / cmed, g[name] / gmed]
                    for name, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:n]]
    return out


def serve_sample(served: list, seed: int, n: int) -> list:
    """``n`` requests (prompt, served tokens) of the finished ``served``
    batches, drawn from the seed, the last one finished always in."""
    flat = [(p[i], g[i]) for p, g in served for i in range(len(p))]
    last = len(flat) - 1
    rest = np.random.default_rng([seed, 3]).permutation(last)
    pick = sorted(int(i) for i in rest[:max(0, n - 1)]) + [last]
    return [flat[i] for i in pick]


def serve_numbers(model: dict, seed: int, sample: list, rows: int, device,
                  precision: str = "float32") -> dict:
    """``logit_gap`` of the served tokens in ``sample``; with a lower
    ``precision``, of the tokens that precision puts first instead."""
    import torch
    params = weights.make(model, seed, device)
    worst = 0.0
    with lm.highest_precision():
        for s in range(0, len(sample), rows):
            part = sample[s:s + rows]
            prompts = np.stack([p for p, _ in part])
            gen = np.stack([g for _, g in part]).astype(np.int64)
            L, new = prompts.shape[1], gen.shape[1]
            seq = torch.as_tensor(np.concatenate([prompts, gen[:, :-1]], 1),
                                  device=device)
            pos = list(range(L - 1, L - 1 + new))
            ref = lm.logits_at(params, model, seq, pos)
            if precision == "float32":
                pick = torch.as_tensor(gen, device=device)
            else:
                pick = lm.logits_at(params, model, seq, pos,
                                    precision).argmax(-1)
            gap = ref.max(-1).values - ref.gather(-1, pick[..., None])[..., 0]
            worst = max(worst, float(gap.max()))
    del params
    return {"logit_gap": worst}


def numbers(run_check: dict, cfg: dict, mix: dict, seed: int,
            device) -> dict:
    """The compared numbers of a run's ``check`` record."""
    m = cfg["model"]
    if run_check["kind"] == "train":
        ref = train_reference(m, mix["optimizer"], seed,
                              run_check["batches"], device)
        return train_numbers(run_check, ref)
    sample = serve_sample(run_check["served"], seed,
                          mix["check"]["requests"])
    return serve_numbers(m, seed, sample, mix["check"]["rows"], device)


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``): every number that has a
    limit finite and at or under it."""
    out = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return bool(ok), out
