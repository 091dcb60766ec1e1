"""Composable layer stacks.

A model is a *layer program*: a tuple of segments ``(kind, count)``.  Each
segment's parameters are stacked along a leading "layers" dim and the
model walks the segment one layer at a time (the reference scans it).
Composite kinds nest simple blocks inside one layer step.

Kinds:
  attn      pre-norm self-attention (full, causal) + MLP
  swa       sliding-window self-attention + MLP
  enc       bidirectional (encoder) self-attention + MLP     [hubert]
  moe       self-attention + MoE FFN (+ dense residual)  [arctic/deepseek]
  ssd       Mamba-2 SSD block                                 [mamba2]
  hyb_full  parallel attention+SSM heads, full attention      [hymba]
  hyb_swa   parallel attention+SSM heads, windowed attention  [hymba]
  xattn     cross-attention to memory tokens + MLP            [llama-vision]
  pair_lg   composite: swa block then attn block              [gemma2]
  group_sx  composite: 4 self blocks then 1 xattn block       [llama-vision]
"""

from __future__ import annotations

import dataclasses

import torch

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (layer_norm, layer_norm_defs, mlp_defs, mlp_forward,
                     rms_norm, rms_norm_def)
from ..distributed.sharding import is_dtensor, shard
from .params import ParamDef

__all__ = ["ModelConfig", "block_defs", "block_forward", "block_decode",
           "block_cache_defs", "block_prefill", "SIMPLE_KINDS"]

SIMPLE_KINDS = ("attn", "swa", "enc", "moe", "ssd", "hyb_full", "hyb_swa",
                "xattn")
COMPOSITE = {"pair_lg": ("local:swa", "global:attn"),
             "group_sx": ("self_0:attn", "self_1:attn", "self_2:attn",
                          "self_3:attn", "cross:xattn")}
_HYBRID = ("hyb_full", "hyb_swa")


def _check_kind(kind: str) -> None:
    if kind not in SIMPLE_KINDS and kind not in COMPOSITE:
        raise ValueError(f"unknown layer kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    program: tuple                  # ((kind, count), ...)
    # attention
    causal: bool = True
    window: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    use_rope: bool = True
    attn_cap: float | None = None
    final_cap: float | None = None
    q_chunk: int = 512
    norm: str = "rms"               # rms | ln
    act: str = "silu"               # silu | gelu
    gated_mlp: bool = True
    post_norm: bool = False         # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False
    tie_embed: bool = True
    # moe / ssm / vlm
    moe: moe_mod.MoEDims | None = None
    dense_residual: bool = False
    ssm: ssm_mod.SSMDims | None = None
    ssd_chunk: int = 256
    n_memory_tokens: int = 0        # vision/audio memory length (vlm)
    frontend: str = "tokens"        # tokens | frames
    # runtime
    remat: str = "dots"             # none | dots | full
    fsdp: bool = False
    loss_chunk: int = 512
    aux_weight: float = 0.01
    grad_accum: int = 8             # microbatches per train step
    flash: bool = False             # flash-attention kernel on prefill
    flash_block: int = 256

    @property
    def rotary_dim(self) -> int | None:
        if self.rotary_pct >= 1.0:
            return None
        return int(self.head_dim * self.rotary_pct)

    def layers_per_step(self, kind: str) -> int:
        return len(COMPOSITE[kind]) if kind in COMPOSITE else 1

    def total_layers(self) -> int:
        return sum(self.layers_per_step(k) * c for k, c in self.program)


def _norm_def(cfg):
    return rms_norm_def(cfg.d_model) if cfg.norm == "rms" \
        else layer_norm_defs(cfg.d_model)


def _norm(cfg, p, x):
    return rms_norm(x, p) if cfg.norm == "rms" else layer_norm(x, p)


def _subs(kind: str):
    """(name, simple kind) of each block of a composite kind."""
    return [tuple(spec.split(":")) for spec in COMPOSITE[kind]]


# ---------------------------------------------------------------------------
# defs
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, kind: str) -> dict:
    _check_kind(kind)
    if kind in COMPOSITE:
        return {nm: block_defs(cfg, sub) for nm, sub in _subs(kind)}
    if kind == "ssd":
        return {"norm": _norm_def(cfg), "ssm": ssm_mod.ssd_defs(cfg.ssm)}
    d = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg)}
    d["attn"] = attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                               cfg.head_dim, qkv_bias=cfg.qkv_bias,
                               gated=kind == "xattn")
    if kind in _HYBRID:
        d["ssm"] = ssm_mod.ssd_defs(cfg.ssm)
        d["mix_na"] = rms_norm_def(cfg.d_model)
        d["mix_ns"] = rms_norm_def(cfg.d_model)
    if cfg.post_norm:
        d["post1"] = _norm_def(cfg)
        d["post2"] = _norm_def(cfg)
    if kind == "moe":
        d["moe"] = moe_mod.moe_defs(cfg.moe)
        if cfg.dense_residual:
            d["dense"] = mlp_defs(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)
    return d


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg: ModelConfig, kind: str) -> dict:
    window = cfg.window if kind in ("swa", "hyb_swa") else None
    causal = cfg.causal and kind != "enc"
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                causal=causal, window=window, rope_theta=cfg.rope_theta,
                rotary_dim=cfg.rotary_dim, use_rope=cfg.use_rope,
                attn_cap=cfg.attn_cap, flash=cfg.flash,
                flash_block=cfg.flash_block)


def _ffn(cfg: ModelConfig, kind: str, p, h, zero):
    """The block's FFN and its auxiliary loss (MoE's load balance; else
    ``zero``)."""
    if kind == "moe":
        y, aux = moe_mod.moe_forward(p["moe"], h, cfg.moe)
        if cfg.dense_residual:
            y = y + mlp_forward(p["dense"], h, act=cfg.act)
        return y, aux
    return mlp_forward(p["mlp"], h, act=cfg.act), zero


def block_forward(cfg: ModelConfig, kind: str, p, x, positions,
                  memory=None, collect_kv: bool = False):
    """Returns (x, aux, kv) — ``kv`` is the (k, v)/state bundle when
    ``collect_kv`` (prefill), else None.  ``memory``: the (B, M, d_model)
    tokens the ``xattn`` blocks attend to."""
    _check_kind(kind)
    if kind in COMPOSITE:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = {}
        for nm, sub in _subs(kind):
            x, a, kv = block_forward(cfg, sub, p[nm], x, positions, memory,
                                     collect_kv)
            aux = aux + a
            if collect_kv:
                kvs[nm] = kv
        return x, aux, (kvs if collect_kv else None)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssd":
        h = _norm(cfg, p["norm"], x)
        if collect_kv:
            y, kv = ssm_mod.ssd_forward_with_state(p["ssm"], h, cfg.ssm,
                                                   chunk=cfg.ssd_chunk)
        else:
            y, kv = ssm_mod.ssd_forward(p["ssm"], h, cfg.ssm,
                                        chunk=cfg.ssd_chunk), None
        return _residual(x, y), zero, kv

    h = _norm(cfg, p["ln1"], x)
    if kind == "xattn":
        k, v = attn.cross_kv(p["attn"], memory)
        y = attn.cross_attn_forward(p["attn"], h, k, v, n_heads=cfg.n_heads,
                                    n_kv=cfg.n_kv, head_dim=cfg.head_dim)
        kv = {"xk": k, "xv": v} if collect_kv else None
    else:
        y, kv = _attn_with_kv(cfg, p["attn"], h, positions,
                              _attn_kwargs(cfg, kind), collect_kv)
    if kind in _HYBRID:
        if collect_kv:
            ys, kvs = ssm_mod.ssd_forward_with_state(p["ssm"], h, cfg.ssm,
                                                     chunk=cfg.ssd_chunk)
            kv = {"attn": kv, "ssm": kvs}
        else:
            ys = ssm_mod.ssd_forward(p["ssm"], h, cfg.ssm,
                                     chunk=cfg.ssd_chunk)
        y = 0.5 * (rms_norm(shard(y, *_ACT), p["mix_na"])
                   + rms_norm(shard(ys, *_ACT), p["mix_ns"]))
    if cfg.post_norm:
        y = _norm(cfg, p["post1"], shard(y, *_ACT))
    x = _residual(x, y)
    h2 = _norm(cfg, p["ln2"], x)
    y2, aux = _ffn(cfg, kind, p, h2, zero)
    if cfg.post_norm:
        y2 = _norm(cfg, p["post2"], shard(y2, *_ACT))
    return _residual(x, y2), aux, kv


#: the residual stream's logical axes
_ACT = ("batch", None, "act_embed")


def _residual(x, y):
    """The residual stream ``x + y`` at its activation sharding.  On a
    mesh a sublayer's output comes back as a partial sum over the model
    axis (the contraction over its heads or its mlp columns was split):
    it is reduced here, explicitly, before the sum, which a remat policy
    keeps, and not inside the sum or a later op that reads it (the norms,
    the next products), where DTensor would reduce it out of the policy's
    sight and a recompute would run the reduction again.  A norm that
    reads a sublayer's output (a post-norm, the hybrid mix) gets it so
    reduced too: the norm's backward would otherwise hand the product's
    gradient back split over the sequence on "model" as well, which
    DTensor's product rule refuses at one row a data shard.  The sum's
    gradient is reduced here too (``_reduced_grad``).  No-op off a
    mesh."""
    return _reduced_grad(shard(x, *_ACT) + shard(y, *_ACT))


def _reduced_grad(t):
    """``t`` whose gradient the backward reduces to ``t``'s placements
    (the counterpart of the forward's reduction in ``_residual``): a
    column-split product's input gradient is a partial sum over "model",
    and DTensor would carry it so down the residual stream into the next
    sublayer's backward, where a row-split product with a partial-sum
    gradient gathers its whole weight and every rank computes the whole
    product.  Reduced once here, every product's backward stays split."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(grad_placements=t.placements),
                              t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _attn_with_kv(cfg, p, h, positions, kwargs, collect_kv):
    y = attn.attn_forward(p, h, q_chunk=cfg.q_chunk, positions=positions,
                          **kwargs)
    if not collect_kv:
        return y, None
    # recompute k/v projections (cheap relative to attention) for the cache
    k, v = attn._project_kv(p, h)
    if kwargs["use_rope"]:
        k = attn._rope_heads(k, positions, kwargs["rope_theta"],
                             kwargs["rotary_dim"])
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int) -> dict | None:
    _check_kind(kind)
    if kind in COMPOSITE:
        return {nm: block_cache_defs(cfg, sub, batch, cache_len)
                for nm, sub in _subs(kind)}
    if kind == "enc":
        return None
    if kind == "ssd":
        return ssm_mod.ssd_cache_defs(batch, cfg.ssm)
    if kind == "xattn":
        shape = (batch, cfg.n_memory_tokens, cfg.n_kv, cfg.head_dim)
        axes = ("batch", None, "kv_heads", None)
        return {nm: ParamDef(shape, axes, dtype="bfloat16", init="zeros")
                for nm in ("xk", "xv")}
    seq_sharded = batch == 1           # long-context: shard cache over seq
    win = cfg.window if kind in ("swa", "hyb_swa") else None
    S = min(win, cache_len) if win else cache_len
    kv = attn.init_kv_cache_defs(batch, S, cfg.n_kv, cfg.head_dim,
                                 seq_sharded=seq_sharded and win is None)
    if kind in _HYBRID:
        return {"attn": kv, "ssm": ssm_mod.ssd_cache_defs(batch, cfg.ssm)}
    return kv


def block_decode(cfg: ModelConfig, kind: str, p, x, cache, pos: int):
    """One-token step; updates ``cache`` in place. Returns (x, cache)."""
    _check_kind(kind)
    if kind in COMPOSITE:
        new = {}
        for nm, sub in _subs(kind):
            x, new[nm] = block_decode(cfg, sub, p[nm], x, cache[nm], pos)
        return x, new

    if kind == "ssd":
        h = _norm(cfg, p["norm"], x)
        y, c = ssm_mod.ssd_decode(p["ssm"], h, cache, cfg.ssm)
        return x + y, c

    h = _norm(cfg, p["ln1"], x)
    kw = _attn_kwargs(cfg, kind)
    for drop in ("causal", "flash", "flash_block"):
        kw.pop(drop)
    if kind == "xattn":
        y = attn.cross_attn_forward(p["attn"], h, cache["xk"].to(x.dtype),
                                    cache["xv"].to(x.dtype),
                                    n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    head_dim=cfg.head_dim)
        new_cache = cache
    elif kind in _HYBRID:
        ya, ca = attn.attn_decode(p["attn"], h, cache["attn"], pos, **kw)
        ys, cs = ssm_mod.ssd_decode(p["ssm"], h, cache["ssm"], cfg.ssm)
        y = 0.5 * (rms_norm(ya, p["mix_na"]) + rms_norm(ys, p["mix_ns"]))
        new_cache = {"attn": ca, "ssm": cs}
    else:
        y, new_cache = attn.attn_decode(p["attn"], h, cache, pos, **kw)
    if cfg.post_norm:
        y = _norm(cfg, p["post1"], y)
    x = x + y
    h2 = _norm(cfg, p["ln2"], x)
    y2, _ = _ffn(cfg, kind, p, h2, None)
    if cfg.post_norm:
        y2 = _norm(cfg, p["post2"], y2)
    return x + y2, new_cache


# ---------------------------------------------------------------------------
# prefill cache construction
# ---------------------------------------------------------------------------

def block_prefill(cfg: ModelConfig, kind: str, kv, cache_defs_tree,
                  batch: int, L: int):
    """Convert collected prefill k/v (or SSM state) into the cache layout
    of ``block_cache_defs``.  ``kv`` comes from block_forward with
    collect_kv=True; returns a tree of tensors."""
    _check_kind(kind)
    if kind in COMPOSITE:
        return {nm: block_prefill(cfg, sub, kv[nm], cache_defs_tree[nm],
                                  batch, L)
                for nm, sub in _subs(kind)}
    if kind == "ssd":
        return kv                      # already {"S":..., "conv":...}
    if kind == "xattn":
        return {nm: kv[nm].to(torch.bfloat16) for nm in ("xk", "xv")}
    if kind in _HYBRID:
        return {"attn": _kv_to_cache(kv["attn"], cache_defs_tree["attn"], L),
                "ssm": kv["ssm"]}
    return _kv_to_cache(kv, cache_defs_tree, L)


def _kv_to_cache(kv, cdefs, L):
    """The prefill's k, v (B, L, K, D) in a zeroed cache of ``cdefs``; on
    DTensors the cache is placed by its defs' axes and each rank fills its
    own block (of a cache split over its sequence, its slots)."""
    from ..distributed.sharding import current_ctx, is_dtensor
    S = cdefs["k"].shape[1]
    out = {}
    for nm in ("k", "v"):
        src = kv[nm].to(torch.bfloat16)            # (B, L, K, D)
        buf = torch.zeros(cdefs[nm].shape, dtype=torch.bfloat16,
                          device=src.device)
        whole, local = buf, src
        if is_dtensor(src):
            from torch.distributed.tensor import distribute_tensor
            mesh = src.device_mesh
            pl = current_ctx().placements(cdefs[nm].axes, buf.shape,
                                          mesh=mesh)
            whole = distribute_tensor(buf, mesh, pl, src_data_rank=None)
            if attn.seq_split(whole):
                # this rank's slots of the positions the cache keeps
                buf = whole.to_local()
                start, n = attn.slot_range(whole)
                local = src.redistribute(mesh, attn._whole_sequence(
                    pl)).to_local()
                ps = torch.arange(max(L - S, 0), L, device=buf.device)
                sl = ps % S
                keep = (sl >= start) & (sl < start + n)
                buf[:, sl[keep] - start] = local[:, ps[keep]]
                out[nm] = whole
                continue
            buf, local = whole.to_local(), src.redistribute(
                mesh, pl).to_local()
        if S >= L:
            buf[:, :L] = local
        else:       # ring: keep last S, placed at slot p % S
            slots = torch.arange(L - S, L, device=buf.device) % S
            buf[:, slots] = local[:, L - S:]
        out[nm] = whole
    return out

