"""Mixture-of-Experts feed-forward: the port of ``repro.models.moe``'s
single-device path (capacity-based top-k dispatch, GShard style).

DeepSeekMoE's fine-grained experts (2 shared + 64 routed, top 6) and
Mixtral's 8 experts (top 2).  Without a mesh the reference always takes
``_apply_moe_dense``: a sort-based dispatch into ``[E, cap, d]`` expert
buffers, first come first kept in token order, overflow dropped.  The
expert-parallel paths (``_apply_moe_ep``, ``_apply_moe_ep_fshard``) wait
for multi-card serving (ROADMAP.md queue 1).

Exactness rules the dispatch keeps on every device:

- ``jnp.argsort`` is stable; the port sorts with ``stable=True``;
- ``jax.lax.top_k`` gives equal values lowest index first; the port takes
  the top k from a stable descending sort (``top_k``);
- ``cap`` is the reference's Python-float expression, left to right;
- dropped rows all land on the sentinel row ``E * cap``, whose sum is
  discarded unread (on the card ``index_add_`` sums it in no fixed order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import MLP, ModelCfg, param


def capacity(capacity_factor: float, top_k: int, T: int,
             n_experts: int) -> int:
    """Slots per expert for ``T`` tokens (reference ``moe.py:84``)."""
    return int(max(1, capacity_factor * top_k * T / n_experts))


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: values and indices, ties
    lowest index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router):
    """Router probabilities [T, E] in f32 (reference ``moe.py:81-83``)."""
    return torch.softmax(xt.float() @ router, dim=-1)


def local_dispatch(xt, probs, k: int, cap: int, n_exp: int):
    """Sort-based dispatch of ``xt`` [t, d] into ``[n_exp, cap, d]`` expert
    buffers (reference ``_local_dispatch``).  Returns ``(buffers, dst,
    keep, gate, counts, topi)``: per (token, slot) row in token-major
    order its buffer row (``n_exp * cap`` when dropped), whether it was
    kept and its gate; per expert the number of rows kept; then, beyond
    the reference's five, the top-k experts [t, k] each token asked for."""
    t, d = xt.shape
    dev = xt.device
    topv, topi = top_k(probs, k)
    slot_e = topi.reshape(-1)
    slot_t = torch.arange(t, device=dev).repeat_interleave(k)
    gate = topv.reshape(-1)

    order = torch.argsort(slot_e, stable=True)
    sorted_e = slot_e[order]
    pos = torch.arange(t * k, device=dev)
    is_start = torch.ones(t * k, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    rank = torch.empty_like(pos).scatter_(0, order, pos - seg_start)
    keep = rank < cap
    dst = torch.where(keep, slot_e * cap + rank, n_exp * cap)
    buf = torch.zeros((n_exp * cap + 1, d), dtype=xt.dtype, device=dev)
    buf.index_add_(0, dst, xt[slot_t])
    counts = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(keep, slot_e, n_exp),
                      torch.ones_like(slot_e, dtype=torch.int32))
    return (buf[:-1].reshape(n_exp, cap, d), dst, keep, gate,
            counts[:n_exp], topi)


def _experts(buf, w_gate, w_up, w_down):
    """SwiGLU of each expert over its buffer: [E, cap, d] -> [E, cap, d]."""
    g, u = torch.bmm(buf, w_gate), torch.bmm(buf, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def _aux(probs, counts, n_kept, n_exp: int):
    """Switch-style load-balance loss in f32."""
    ce = counts.float() / torch.clamp(n_kept.float(), min=1.0)
    return n_exp * torch.sum(probs.mean(0) * ce)


class MoE(nn.Module):
    """Routed experts (and ``shared``, an MLP of ``n_shared`` experts'
    width, when ``n_shared > 0``) with the reference's names and layouts
    (``init_moe``): ``router`` [d, E] always f32, ``w_gate`` / ``w_up``
    [E, d, f] and ``w_down`` [E, f, d] in ``cfg.dtype``."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None):
        super().__init__()
        me = self.me = cfg.moe
        d, f = cfg.d_model, me.d_ff_expert
        s, s2 = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        kw = dict(device=device, generator=generator)
        self.router = param((d, me.n_experts), torch.float32, scale=s, **kw)
        self.w_gate = param((me.n_experts, d, f), cfg.dtype, scale=s, **kw)
        self.w_up = param((me.n_experts, d, f), cfg.dtype, scale=s, **kw)
        self.w_down = param((me.n_experts, f, d), cfg.dtype, scale=s2, **kw)
        if me.n_shared:
            self.shared = MLP(d, f * me.n_shared, cfg.dtype, **kw)

    def forward(self, x, with_aux: bool = False):
        """x: [B, S, d] -> (out [B, S, d], aux): ``apply_moe`` on its
        dense path (reference ``_apply_moe_dense``).  ``aux``, the f32
        load-balance loss, is computed only ``with_aux`` (else None)."""
        me = self.me
        B, S, d = x.shape
        T, E = B * S, me.n_experts
        xt = x.reshape(T, d)
        probs = route(xt, self.router)
        cap = capacity(me.capacity_factor, me.top_k, T, E)
        buf, dst, keep, gate, counts, _ = local_dispatch(
            xt, probs, me.top_k, cap, E)
        ye = _experts(buf, self.w_gate, self.w_up, self.w_down)
        flat = ye.reshape(E * cap, d)
        ys = flat[torch.clamp(dst, max=E * cap - 1)] * \
            keep[:, None].to(flat.dtype)
        gk = (gate * keep).reshape(T, me.top_k)
        yk = ys.reshape(T, me.top_k, d)
        denom = torch.clamp(gk.sum(1, keepdim=True), min=1e-9)
        out = torch.einsum("tkd,tk->td", yk, (gk / denom).to(yk.dtype))
        out = out.reshape(B, S, d).to(x.dtype)
        if me.n_shared:
            out = out + self.shared(x)
        return out, (_aux(probs, counts, keep.sum(), E) if with_aux
                     else None)


def _topk_capacity(probs, k: int, cap: int):
    """probs [T, E] -> (gates [T, E, C], dispatch [T, E, C]): the
    reference's one-hot capacity rule (``_topk_capacity``)."""
    T, E = probs.shape
    topv, topi = top_k(probs, k)
    assign = F.one_hot(topi, E).to(torch.int32)              # [T, k, E]
    flat = assign.reshape(T * k, E)
    pos_in_e = (torch.cumsum(flat, 0) * flat - 1).long()
    keep = (pos_in_e < cap) & (pos_in_e >= 0)
    pos = torch.clamp(pos_in_e, 0, cap - 1)
    capslot = F.one_hot(pos, cap).float() * keep[..., None]
    disp = capslot.reshape(T, k, E, cap).sum(1)
    gate_vals = topv[..., None] * assign                     # [T, k, E]
    gates = torch.einsum("tke,tkec->tec", gate_vals,
                         capslot.reshape(T, k, E, cap))
    gates = gates / torch.clamp(gates.sum((1, 2), keepdim=True), min=1e-9)
    return gates, disp


def apply_moe_dense_einsum(moe: MoE, x):
    """The GShard one-hot einsum dispatch (reference
    ``_apply_moe_dense_einsum``): O(T^2), the small-shape oracle of the
    tests; shared experts are not added, as in the reference."""
    me = moe.me
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs = route(xt, moe.router)
    cap = capacity(me.capacity_factor, me.top_k, T, me.n_experts)
    gates, dispatch = _topk_capacity(probs, me.top_k, cap)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    ye = _experts(xe, moe.w_gate, moe.w_up, moe.w_down)
    out = torch.einsum("tec,ecd->td", gates.to(x.dtype), ye)
    ce = dispatch.sum(-1).float().mean(0)
    aux = me.n_experts * torch.sum(probs.mean(0) * ce)
    return out.reshape(B, S, d), aux
