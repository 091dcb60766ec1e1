"""The Model API: skeleton / forward / loss / prefill / decode.

Everything is a function of (params, inputs); ``LM`` holds the config and
the device.  Parameters are a tree of nested dicts and lists under the
reference's path names (``embed``, ``segments/0/attn/wq``, ...); a
segment's parameters are stacked on a leading layer dimension, and the
model walks it one layer at a time (the reference scans it), each layer
under the config's remat policy when gradients are taken.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import spans
from ..device import resolve_device
from ..distributed.sharding import (active, current_ctx, is_dtensor,
                                    replicate_plain, shard)
from . import transformer as tfm
from .layers import (cross_entropy_chunked, embed_def, embed_lookup,
                     layer_norm, rms_norm, unembed_chunked)
from .params import (ParamDef, count_params, grad_leaf, materialize, stack,
                     tree_map)
from .transformer import ModelConfig

__all__ = ["LM"]

_aten = torch.ops.aten


#: the reductions a sharded layer runs, whose outputs a remat policy keeps
_REDUCTIONS = ("all_reduce", "reduce_scatter_tensor")


def _collectives_saveable(ctx, func, *args, **kwargs):
    """Keep the output of every reduction a sharded layer runs (the
    functional ``all_reduce`` and ``reduce_scatter_tensor`` ops: the
    explicit sums of ``distributed/collectives.py`` and DTensor's
    reductions of partial sums) and recompute the rest, all-gathers
    included: a gathered FSDP weight or activation is as large as the
    layer's whole operand, so it is gathered again in the backward (as
    FSDP does) rather than kept; a reduction's output is no larger than
    its input, and keeping it spares the backward a second reduction."""
    if func.namespace == "_c10d_functional" and \
            func._opname in _REDUCTIONS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_saveable(ctx, func, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matrix products without batch dimensions (the projections,
    which einsum and ``@`` lower to ``mm`` or to ``bmm`` over a batch of
    one) and recompute everything else, attention scores included; and,
    under a mesh, the reductions' outputs (``_collectives_saveable``)."""
    if func in (_aten.mm.default, _aten.addmm.default) or (
            func is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return _collectives_saveable(ctx, func, *args, **kwargs)


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one layer) under the config's remat policy: ``none``,
    ``dots`` (save the projections' outputs), anything else recomputes
    the whole layer in the backward pass; both keep the reductions'
    outputs (an all-gather is issued again in the recompute), and the
    recompute runs under the forward's sharding context
    (``sharding.active``, ``replicate_plain``)."""
    if cfg.remat == "none":
        return fn
    policy = _dots_saveable if cfg.remat == "dots" else \
        _collectives_saveable
    ctx_fn = functools.partial(create_selective_checkpoint_contexts, policy)
    sharding = current_ctx()

    def run(traced, *args):
        # the recompute runs on the backward's thread, where the forward's
        # thread-local state is not: its sharding context, and plain
        # tensors meeting DTensors as replicated ones.  Traced, it runs
        # inside ``repro_torch.remat.recompute``, before any span of the
        # layer's backward opens
        with active(sharding), (replicate_plain() if sharding is not None
                                else contextlib.nullcontext()):
            return spans.recompute_marked(fn, *args) if traced else \
                fn(*args)
    return lambda *args: checkpoint(run, spans.recording(), *args,
                                    use_reentrant=False, context_fn=ctx_fn)


def _stack_tree(defs, n: int):
    return tree_map(lambda d: stack(d, n), defs)


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack_def(d: ParamDef) -> ParamDef:
    """One layer's ``ParamDef`` of a layer-stacked one."""
    return ParamDef(d.shape[1:], d.axes[1:], d.dtype, d.init, d.scale)


class LM:
    """``device``: where :meth:`init` puts the weights (the card unless
    the caller asks for ``"cpu"``); the forward functions run wherever
    their inputs lie."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.total_layers() != cfg.n_layers:
            raise ValueError(
                f"{cfg.name}: program covers {cfg.total_layers()} layers, "
                f"config says {cfg.n_layers}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters ----------------------------------------------------------
    def skeleton(self) -> dict:
        cfg = self.cfg
        sk: dict = {}
        if cfg.frontend == "tokens":
            sk["embed"] = embed_def(cfg.vocab, cfg.d_model)
        sk["segments"] = []
        for kind, count in cfg.program:
            defs = tfm.block_defs(cfg, kind)
            sk["segments"].append(_stack_tree(defs, count) if count > 1
                                  else defs)
        sk["final_norm"] = tfm._norm_def(cfg)
        if not cfg.tie_embed or cfg.frontend != "tokens":
            sk["lm_head"] = ParamDef((cfg.vocab, cfg.d_model),
                                     ("vocab", "embed"), init="fan_in")
        return sk

    def init(self, generator: torch.Generator) -> dict:
        """Random weights from ``generator``, which must live on
        ``self.device``.  Under an active sharding context over a
        ``DeviceMesh`` each leaf is a DTensor placed by the rules
        (``materialize(place=True)``): the same numbers as without a
        mesh, each rank holding its blocks."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        ctx = current_ctx()
        return materialize(self.skeleton(), generator,
                           place=ctx is not None and hasattr(ctx.mesh,
                                                             "get_group"))

    def num_params(self) -> int:
        return count_params(self.skeleton())

    # -- embedding / head -----------------------------------------------------
    def _embed_in(self, params, batch):
        """The first hidden state: the embedded tokens, or the frames cast
        to bf16 whatever the compute dtype (as the reference casts them;
        every layer then computes in the frames' dtype)."""
        if self.cfg.frontend == "tokens":
            x = embed_lookup(params["embed"], batch["tokens"],
                             scale=self.cfg.embed_scale)
        else:
            x = batch["frames"].to(torch.bfloat16)
        return shard(x, "batch", None, "act_embed")

    def _head_table(self, params):
        return params["lm_head"] if "lm_head" in params else params["embed"]

    def _final_norm(self, params, x):
        return (rms_norm(x, params["final_norm"]) if self.cfg.norm == "rms"
                else layer_norm(x, params["final_norm"]))

    # -- forward --------------------------------------------------------------
    def hidden(self, params, batch, collect_kv: bool = False):
        """Runs the stack. Returns (hidden, aux, kv_per_segment); a stacked
        segment's kv is the list of its layers' kvs."""
        with plain_as_replicated(params):
            return self._hidden(params, batch, collect_kv)

    def _hidden(self, params, batch, collect_kv: bool):
        cfg = self.cfg
        x = self._embed_in(params, batch)
        B, L, _ = x.shape
        positions = torch.arange(L, device=x.device)
        memory = batch.get("memory")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        for (kind, count), seg in zip(cfg.program, params["segments"]):
            if count == 1:
                x, a, kv = tfm.block_forward(cfg, kind, seg, x, positions,
                                             memory, collect_kv)
                aux = aux + a
                kvs.append(kv)
                continue

            def body(xx, p, _kind=kind):
                return tfm.block_forward(cfg, _kind, p, xx, positions,
                                         memory, collect_kv)
            if torch.is_grad_enabled():
                body = _remat(cfg, body)
            seg_kv = []
            for i in range(count):
                x, a, kv = body(x, _layer(seg, i))
                aux = aux + a
                seg_kv.append(kv)
            kvs.append(seg_kv)
        x = self._final_norm(params, x)
        return x, aux, (kvs if collect_kv else None)

    def loss(self, params, batch):
        """Mean next-token cross-entropy plus ``aux_weight`` times the
        blocks' auxiliary loss: ``(loss, {"ce", "aux"})``."""
        cfg = self.cfg
        with plain_as_replicated(params):
            h, aux, _ = self._hidden(params, batch, False)
            ce = cross_entropy_chunked(h, self._head_table(params),
                                       batch["labels"], chunk=cfg.loss_chunk,
                                       final_cap=cfg.final_cap)
            return ce + cfg.aux_weight * aux, {"ce": ce, "aux": aux}

    def trainable(self, params, grads) -> dict:
        """``params`` as autograd leaves whose gradients accumulate in
        place into ``grads`` (a zeroed tree like ``params``).  Each layer
        of a stacked segment is a leaf of its own, a view of its slice of
        the stacked tensor, so a layer's backward adds into its slice of
        the stacked gradient with no stacked-size temporary per layer."""
        out = tree_map(grad_leaf, {k: v for k, v in params.items()
                                   if k != "segments"},
                       {k: v for k, v in grads.items() if k != "segments"})
        out["segments"] = [
            tree_map(grad_leaf, seg, gseg) if count == 1 else
            tree_map(lambda p, g, n=count: [grad_leaf(p[i], g[i])
                                            for i in range(n)], seg, gseg)
            for (_, count), seg, gseg in zip(self.cfg.program,
                                             params["segments"],
                                             grads["segments"])]
        return out

    # -- serving --------------------------------------------------------------
    def cache_skeleton(self, batch: int, cache_len: int):
        out = []
        for kind, count in self.cfg.program:
            cd = tfm.block_cache_defs(self.cfg, kind, batch, cache_len)
            out.append(_stack_tree(cd, count) if count > 1 else cd)
        return out

    def prefill(self, params, batch, cache_len: int | None = None):
        """Full-sequence pass producing (last_token_logits, cache)."""
        cfg = self.cfg
        B, L = batch.get("tokens", batch.get("frames")).shape[:2]
        cache_len = cache_len or L
        h, _, kvs = self.hidden(params, batch, collect_kv=True)
        caches = []
        for (kind, count), kv, cd in zip(cfg.program, kvs,
                                         self.cache_skeleton(B, cache_len)):
            if cd is None:
                caches.append(None)
            elif count == 1:
                caches.append(tfm.block_prefill(cfg, kind, kv, cd, B, L))
            else:
                cd_inner = tree_map(_unstack_def, cd)
                caches.append(_stack_layers([
                    tfm.block_prefill(cfg, kind, kv_i, cd_inner, B, L)
                    for kv_i in kv]))
        logits = unembed_chunked(h[:, -1:], self._head_table(params),
                                 final_cap=cfg.final_cap)
        return logits, caches

    def decode_step(self, params, cache, tokens, pos: int):
        """One token for the whole batch. ``tokens``: (B, 1). ``pos``: the
        current position. Updates ``cache`` in place (the reference donates
        it) and returns (logits, cache)."""
        with plain_as_replicated(params):
            return self._decode_step(params, cache, tokens, pos)

    def _decode_step(self, params, cache, tokens, pos: int):
        cfg = self.cfg
        x = self._embed_in(params, {"tokens": tokens}
                           if cfg.frontend == "tokens" else
                           {"frames": tokens})
        new_caches = []
        for (kind, count), seg, c in zip(cfg.program, params["segments"],
                                         cache):
            if count == 1:
                x, nc = tfm.block_decode(cfg, kind, seg, x, c, pos)
            else:
                for i in range(count):
                    x, _ = tfm.block_decode(cfg, kind, _layer(seg, i), x,
                                            _layer(c, i), pos)
                nc = c
            new_caches.append(nc)
        x = self._final_norm(params, x)
        logits = unembed_chunked(x, self._head_table(params),
                                 final_cap=cfg.final_cap)
        return logits, new_caches


def plain_as_replicated(params):
    """Where ``params`` are DTensors (a sharded model), plain tensors the
    model makes (positions, masks, zeros) meet them as replicated ones
    (``sharding.replicate_plain``); otherwise nothing."""
    leaf = params
    while isinstance(leaf, (dict, list)) and leaf:
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
            else leaf[0]
    return replicate_plain() if is_dtensor(leaf) else contextlib.nullcontext()


def _stack_layers(layers: list):
    """Per-layer cache trees -> one tree with a leading layer dimension."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in layers]) for k in first}
    return torch.stack(layers)
