"""Mixture-of-Experts FFN: top-k routing with fixed capacity.

The reference has two dispatch paths sharing the routing math:
  * ``gather`` — the dispatch buffer filled by a scatter-add of each kept
    (token, choice) into its expert's next free slot, gathered back and
    weighted in the combine;
  * ``local`` — each rank of a mesh's ``"model"`` axis builds the buffer
    for its own slice of the experts and one ``psum`` combines them.  It
    runs only under such a mesh; without one the reference takes the
    gather path.  The port has no mesh yet (``ROADMAP.md`` queue 1, item
    13), so ``local`` takes the gather path on one rank, as the reference
    does without a mesh.

Supports DeepSeek-MoE shared experts (always-on) and Arctic's parallel
dense residual branch (handled at the block level).  The reference
computes the block outside any Pallas kernel, so plain torch is its port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import mlp_defs, mlp_forward
from .params import ParamDef

__all__ = ["MoEDims", "moe_defs", "moe_forward"]

#: dispatch paths that need a mesh the port does not have yet
_NEEDS_MESH = {"a2a": "fixed-capacity all_to_all over the expert axis"}


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # always-active shared experts (deepseek)
    capacity_factor: float = 1.25
    renorm_topk: bool = True  # renormalize the top-k gate weights
    dispatch: str = "gather"  # gather | local (one rank: gather)


def moe_defs(dims: MoEDims) -> dict:
    E, M, F_ = dims.n_experts, dims.d_model, dims.d_ff
    d = {
        "router": ParamDef((M, E), ("embed", None), init="fan_in"),
        "w_gate": ParamDef((E, M, F_), ("experts", "embed", "expert_mlp"),
                           init="fan_in"),
        "w_up": ParamDef((E, M, F_), ("experts", "embed", "expert_mlp"),
                         init="fan_in"),
        "w_down": ParamDef((E, F_, M), ("experts", "expert_mlp", "embed"),
                           init="fan_in"),
    }
    if dims.n_shared:
        d["shared"] = mlp_defs(M, F_ * dims.n_shared, gated=True)
    return d


def _route(p, xf, dims: MoEDims):
    """Router: returns (weights (T,k), experts (T,k), aux_loss)."""
    logits = torch.einsum("tm,me->te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, dims.top_k, dim=-1)
    if dims.renorm_topk:
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # switch-style load-balance aux loss
    T = xf.shape[0]
    me = torch.mean(probs, dim=0)                                 # (E,)
    ce = torch.bincount(top_e[:, 0], minlength=dims.n_experts).float() / T
    aux = dims.n_experts * torch.sum(me * ce)
    return top_w, top_e, aux


def _capacity(T: int, dims: MoEDims) -> int:
    c = int(T * dims.top_k / dims.n_experts * dims.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def _positions(e_flat, n_experts: int):
    """Each (token, choice)'s position among the earlier choices of its
    expert, in (token, choice) order; int32, as the reference counts."""
    experts = torch.arange(n_experts, device=e_flat.device)
    onehot = (e_flat[:, None] == experts).to(torch.int32)  # (T*k, E)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(before, 1, e_flat[:, None])[:, 0]


def _expert_ffn(p, h, x_dtype):
    g = torch.bmm(h, p["w_gate"].to(x_dtype))             # (E, C, F)
    u = torch.bmm(h, p["w_up"].to(x_dtype))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(x_dtype))


def moe_forward(p, x, dims: MoEDims):
    """``x``: (B, L, M) -> (B, L, M), plus aux loss scalar."""
    if dims.dispatch in _NEEDS_MESH:
        raise NotImplementedError(
            f"MoE dispatch {dims.dispatch!r} ({_NEEDS_MESH[dims.dispatch]}) "
            f"needs a device mesh: ROADMAP.md queue 1, item 13")
    B, L, M = x.shape
    T = B * L
    xf = x.reshape(T, M)
    top_w, top_e, aux = _route(p, xf, dims)
    C = _capacity(T, dims)
    E, k = dims.n_experts, dims.top_k

    # position of each (token, choice) within its expert's capacity
    e_flat = top_e.reshape(T * k)                         # (T*k,)
    pos = _positions(e_flat, E)
    keep = pos < C
    pos_c = torch.clamp(pos, max=C - 1).long()
    t_idx = torch.arange(T * k, device=x.device) // k

    # dispatch: (E, C, M).  A kept (token, choice) owns its slot; a dropped
    # one adds zeros into (e, C-1), so the sum is exact in any order
    contrib = torch.where(keep[:, None], xf[t_idx], 0).to(x.dtype)
    disp = torch.zeros((E, C, M), dtype=x.dtype, device=x.device)
    disp = disp.index_put((e_flat, pos_c), contrib, accumulate=True)

    out_e = _expert_ffn(p, disp, x.dtype)                 # (E, C, M)

    # combine: gather back and weight
    gathered = out_e[e_flat, pos_c]                       # (T*k, M)
    w_flat = (top_w.reshape(T * k) * keep).to(x.dtype)
    y = torch.sum((gathered * w_flat[:, None]).reshape(T, k, M), dim=1)

    if dims.n_shared:
        y = y + mlp_forward(p["shared"], xf)
    return y.reshape(B, L, M), aux
