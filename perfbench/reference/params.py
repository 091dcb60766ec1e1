"""Parameter layout and initialisation laws of the benchmark's models.

The tree is nested dicts and lists: ``embed`` (vocab, d_model), one entry
of ``segments`` per ``[kind, count]`` of the configuration's ``program``
(a segment of more than one layer holds every leaf stacked on a leading
layer dimension), ``final_norm`` and, for an untied head, ``lm_head``.
Laws: ``zeros``, ``ones``, or a normal draw of a given std.  Projections
take the true fan-in, one over the root of the dimensions their product
contracts, and the embedding 1/sqrt(d_model), so that logits start near
std 1.  (At std 1 a tied embedding dominates the residual stream: the
last input token's own logit leads every other by hundreds and every
served token repeats it, whatever the layers compute.)
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Spec", "specs", "flatten", "count", "layer"]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    law: str            # normal | zeros | ones
    std: float = 0.0


def _normal(shape, fan: int) -> Spec:
    return Spec(tuple(shape), "normal", 1.0 / math.sqrt(fan))


def _zeros(shape) -> Spec:
    return Spec(tuple(shape), "zeros")


def _ones(shape) -> Spec:
    return Spec(tuple(shape), "ones")


def _mlp(d: int, f: int) -> dict:
    return {"w_gate": _normal((d, f), d), "w_up": _normal((d, f), d),
            "w_down": _normal((f, d), f)}


def _attn(m: dict) -> dict:
    d, h, k, hd = m["d_model"], m["n_heads"], m["n_kv"], m["head_dim"]
    return {"wq": _normal((d, h, hd), d), "wk": _normal((d, k, hd), d),
            "wv": _normal((d, k, hd), d), "wo": _normal((h, hd, d), h * hd)}


def _ssm(s: dict) -> dict:
    heads = s["d_inner"] // s["headdim"]
    conv = s["d_inner"] + 2 * s["n_groups"] * s["d_state"]
    proj = 2 * s["d_inner"] + 2 * s["n_groups"] * s["d_state"] + heads
    return {"in_proj": _normal((s["d_model"], proj), s["d_model"]),
            "conv_w": _normal((s["conv_width"], conv), s["conv_width"]),
            "conv_b": _zeros((conv,)), "A_log": _ones((heads,)),
            "D": _ones((heads,)), "dt_bias": _zeros((heads,)),
            "norm": _zeros((s["d_inner"],)),
            "out_proj": _normal((s["d_inner"], s["d_model"]), s["d_inner"])}


def _moe(e: dict) -> dict:
    d, f, n = e["d_model"], e["d_ff"], e["n_experts"]
    out = {"router": _normal((d, n), d), "w_gate": _normal((n, d, f), d),
           "w_up": _normal((n, d, f), d), "w_down": _normal((n, f, d), f)}
    if e["n_shared"]:
        out["shared"] = _mlp(d, f * e["n_shared"])
    return out


def _block(m: dict, kind: str) -> dict:
    d = m["d_model"]
    if kind == "ssd":
        return {"norm": _zeros((d,)), "ssm": _ssm(m["ssm"])}
    out = {"ln1": _zeros((d,)), "ln2": _zeros((d,)), "attn": _attn(m)}
    if kind in ("hyb_full", "hyb_swa"):
        out.update(ssm=_ssm(m["ssm"]), mix_na=_zeros((d,)),
                   mix_ns=_zeros((d,)))
    if kind == "moe":
        out["moe"] = _moe(m["moe"])
        if m["dense_residual"]:
            out["dense"] = _mlp(d, m["d_ff"])
    elif kind in ("attn", "swa", "hyb_full", "hyb_swa"):
        out["mlp"] = _mlp(d, m["d_ff"])
    else:
        raise NotImplementedError(f"layer kind {kind!r}")
    return out


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return Spec((n,) + tree.shape, tree.law, tree.std)


def specs(m: dict) -> dict:
    """The parameter tree of model section ``m`` of a configuration file."""
    d = m["d_model"]
    out = {"embed": _normal((m["vocab"], d), d), "segments": []}
    for kind, n in m["program"]:
        blk = _block(m, kind)
        out["segments"].append(_stacked(blk, n) if n > 1 else blk)
    out["final_norm"] = _zeros((d,))
    if not m["tie_embed"]:
        out["lm_head"] = _normal((m["vocab"], d), d)
    return out


def flatten(tree, prefix: str = "") -> list:
    """``[(name, leaf)]`` in sorted-key order; list items by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in flatten(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def count(m: dict) -> dict:
    """``{"total", "experts"}`` parameter counts of model section ``m``."""
    total = experts = 0
    for name, sp in flatten(specs(m)):
        n = math.prod(sp.shape)
        total += n
        if "/moe/w_" in name:
            experts += n
    return {"total": total, "experts": experts}


def layer(tree, i: int):
    """Layer ``i`` of a stacked segment's tree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
