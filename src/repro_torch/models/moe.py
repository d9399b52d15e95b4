"""Mixture-of-Experts feed-forward: the port of ``repro.models.moe``
(capacity-based top-k dispatch, GShard style), on one device and over a
mesh (``repro_torch.launch.mesh``).

DeepSeekMoE's fine-grained experts (2 shared + 64 routed, top 6) and
Mixtral's 8 experts (top 2).  Without a mesh the reference always takes
``_apply_moe_dense``: a sort-based dispatch into ``[E, cap, d]`` expert
buffers, first come first kept in token order, overflow dropped.

On a mesh whose 'model' axis has ``tp > 1`` ranks, each rank keeps only
its expert rows (whole experts over 'model' when ``E % tp == 0``, else an
f slice of every expert: the rule ``launch.shardings`` writes for
``moe/w_*``, and its tests hold the two equal) and ``apply_moe``'s
path choice is ported with ``torch.distributed`` collectives in place of
``shard_map`` (PORT.md, "Expert parallelism and the mesh"):

- ``S % tp == 0`` (prefill): each rank dispatches its own tokens, the
  block ``shard_map``'s ``P(dp, 'model', None)`` gives it, flattened in
  (b, s) order, with ``cap`` from its own token count; then whole
  experts all-to-all the ``[E, cap, d]`` buffers (``_apply_moe_ep``),
  f slices all-gather them and sum the partial outputs back to their
  senders in rank order (``_apply_moe_ep_fshard``); the output blocks are
  all-gathered back to ``[B, S, d]`` on every rank and ``aux`` averaged
  over the ranks; the combine runs in f32, as the reference's does there
  (its gates are not cast), then casts to the model's dtype;
- otherwise (decode) every rank makes the global dispatch of
  ``_apply_moe_dense`` and computes its experts (all-gathered) or its f
  slice (all-reduced), as GSPMD partitions the reference's dense path.

The mesh paths are differentiable: each collective is an autograd
function whose backward is the transpose JAX takes of the reference's
``shard_map`` (PORT.md, "Hybrid training and gradients on a mesh"): a
rank's block of a tensor every rank holds (its tokens, its experts'
rows in decode) gathers its gradient back whole; a gather whose result
every rank holds takes the rank's block of the gradient, unsummed; an
all-to-all's gradient is the all-to-all back; the f-split's gathered
buffers scatter theirs, summed in rank order; an all-reduce's gradient
passes as it is, ``aux``'s mean divides it; and a weight every rank
holds whole, where each rank feeds it only its own tokens (the router,
and the expert rows over the data axes on the EP paths), sums its
gradient over those ranks.  So every rank ends a backward with the same
gradients of its replicated parameters and of the layer's input.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import MLP, ModelCfg, param

EXPERT_ROWS = ("w_gate", "w_up", "w_down")


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


def _combine(ye, dst, keep, gate, k: int, f32: bool = False):
    """Each token's kept expert rows of ``ye`` [E, cap, d], weighted by
    its renormalised gates: [T, d].  The gates are cast to ``ye``'s dtype
    (``_apply_moe_dense``), or with ``f32`` the sum runs in f32 (the EP
    paths, whose f32 gates promote the product)."""
    E, cap, d = ye.shape
    flat = ye.reshape(E * cap, d)
    ys = flat[torch.clamp(dst, max=E * cap - 1)] * \
        keep[:, None].to(flat.dtype)
    gk = (gate * keep).reshape(-1, k)
    yk = ys.reshape(-1, k, d)
    denom = torch.clamp(gk.sum(1, keepdim=True), min=1e-9)
    if f32:
        # elementwise, so each row's sum is the same bits whatever the
        # token count (a GEMM may order its k products otherwise)
        return (yk.float() * (gk / denom)[..., None]).sum(1)
    return torch.einsum("tkd,tk->td", yk, (gk / denom).to(yk.dtype))


def expert_split(cfg: ModelCfg, mesh) -> str | None:
    """How the experts lie over ``mesh``'s 'model' axis: ``"experts"``
    (whole experts, ``E % tp == 0``), ``"f"`` (an f slice of each) or
    None (no mesh, or one rank on 'model')."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return "experts" if cfg.moe.n_experts % mesh.shape["model"] == 0 \
        else "f"


def expert_dim(cfg: ModelCfg, name: str, mesh) -> int | None:
    """The dimension of expert weight ``name`` (``w_gate`` / ``w_up``
    [E, d, f], ``w_down`` [E, f, d]) split over 'model': 0 (experts) or
    the f dimension; None when nothing is split."""
    split = expert_split(cfg, mesh)
    if split is None:
        return None
    return 0 if split == "experts" else (1 if name == "w_down" else 2)


def local_rows(cfg: ModelCfg, name: str, t, mesh):
    """This rank's block of expert weight ``name``, whole tensor ``t``
    (a view): its 'model' coordinate's slice of :func:`expert_dim`."""
    dim = expert_dim(cfg, name, mesh)
    if dim is None:
        return t
    n = mesh.shape["model"]
    if t.shape[dim] % n:
        raise ValueError(f"moe/{name} {tuple(t.shape)} does not split over "
                         f"'model' of size {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coords["model"] * size, size)


def rank_tokens(x, mesh):
    """This rank's tokens of x [B, S, d] on the EP paths: the block
    ``P(dp, 'model', None)`` gives it (batch over the data axes
    row-major, sequence over 'model'), flattened in (b, s) order."""
    B, S, d = x.shape
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    b = B // int(np.prod([mesh.shape[a] for a in dp]))
    s = S // mesh.shape["model"]
    return x[mesh.index(dp) * b:(mesh.index(dp) + 1) * b,
             mesh.coords["model"] * s:(mesh.coords["model"] + 1) * s
             ].reshape(-1, d)


def _all_to_all(t, group):
    """Block i of t's leading axis to rank i of ``group``; returns the
    blocks received, in rank order, stacked the same way."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _all_gather(t, group):
    """[n, *t.shape]: every rank's ``t``, in rank order."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    # one call into one buffer (torch 2.13 names it all_gather_single)
    gather = getattr(dist, "all_gather_single",
                     dist.all_gather_into_tensor)
    gather(out, t.contiguous(), group=group)
    return out.reshape(n, *t.shape)


def _sum_in_order(parts):
    """parts[0] + parts[1] + ..., in that order."""
    out = parts[0].clone()
    for i in range(1, parts.shape[0]):
        out += parts[i]
    return out


class _Block(torch.autograd.Function):
    """``take(t)``: this rank's block of a tensor every rank holds whole.
    Backward: the blocks' gradients joined whole on every rank
    (``join``), since each rank's block fed only its own computation."""

    @staticmethod
    def forward(ctx, t, take, join):
        ctx.join = join
        return take(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.join(g.contiguous()), None, None


class _Join(torch.autograd.Function):
    """``join(t)``: every rank's block, gathered whole on every rank.
    Backward: this rank's block of the gradient (``take``), not summed:
    every rank carries on with the same tensor and the same gradient (a
    reduce-scatter would give the ranks' count times the gradient)."""

    @staticmethod
    def forward(ctx, t, take, join):
        ctx.take = take
        return join(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.take(g), None, None


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; its gradient is the all-to-all back."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GatherParts(torch.autograd.Function):
    """:func:`_all_gather` of the f-split's buffers, which each rank
    multiplies by its own f slice.  Backward: each rank's share of every
    buffer's gradient sent to the buffer's rank and summed there in rank
    order (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_in_order(_all_to_all(g, ctx.group)), None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group`` of the ranks' partial ``t``; its gradient
    passes as it is (every rank holds the sum and its gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A tensor every rank of ``groups`` holds whole, entering a
    computation that each rank runs on its own share of the work: the
    identity forward; backward the gradient summed over each group (the
    ranks' shares add up to the whole gradient)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _PMean(torch.autograd.Function):
    """``v`` averaged over 'model', then over each data axis, as the
    reference's ``pmean`` calls do; the gradient is divided the same
    way."""

    @staticmethod
    def forward(ctx, v, mesh):
        ctx.sizes = []
        v = v.clone()
        for a in ("model", "pod", "data"):
            g = mesh.groups.get(a)
            if g is not None:
                dist.all_reduce(v, group=g)
                v = v / mesh.shape[a]
                ctx.sizes.append(mesh.shape[a])
        return v

    @staticmethod
    def backward(ctx, g):
        for n in ctx.sizes:
            g = g / n
        return g, None


def join_tokens(blk, mesh, B: int, S: int):
    """Every rank's token block ``blk`` (its :func:`rank_tokens`, [t, d]),
    gathered back to [B, S, d] on every rank."""
    d = blk.shape[-1]
    dp = [a for a in ("pod", "data") if a in mesh.shape]
    n_dp, tp = int(np.prod([mesh.shape[a] for a in dp])), mesh.shape["model"]
    # every rank's block, in rank order: row-major over (dp, 'model')
    blocks = _all_gather(blk.reshape(B // n_dp, S // tp, d),
                         dist.group.WORLD)
    return blocks.reshape(n_dp, tp, B // n_dp, S // tp, d).transpose(
        1, 2).reshape(B, S, d)


class MoE(nn.Module):
    """Routed experts (and ``shared``, an MLP of ``n_shared`` experts'
    width, when ``n_shared > 0``) with the reference's names and layouts
    (``init_moe``): ``router`` [d, E] always f32, ``w_gate`` / ``w_up``
    [E, d, f] and ``w_down`` [E, f, d] in ``cfg.dtype``.  On a ``mesh``
    each expert weight is drawn whole, as on one device, and only this
    rank's block is kept (:func:`local_rows`)."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None, mesh=None):
        super().__init__()
        me = self.me = cfg.moe
        self.mesh = mesh
        self.split = expert_split(cfg, mesh)
        if self.split and mesh.axis_names[-1] != "model":
            raise ValueError(f"mesh axes {mesh.axis_names}: want the data "
                             f"axes, then 'model'")
        d, f = cfg.d_model, me.d_ff_expert
        s, s2 = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        kw = dict(device=device, generator=generator)
        self.router = param((d, me.n_experts), torch.float32, scale=s, **kw)
        for name, shape, sc in (("w_gate", (me.n_experts, d, f), s),
                                ("w_up", (me.n_experts, d, f), s),
                                ("w_down", (me.n_experts, f, d), s2)):
            w = param(shape, cfg.dtype, scale=sc, **kw)
            if self.split:
                w = nn.Parameter(local_rows(cfg, name, w.data, mesh).clone(),
                                 requires_grad=False)
            setattr(self, name, w)
        if me.n_shared:
            self.shared = MLP(d, f * me.n_shared, cfg.dtype, **kw)

    def forward(self, x, with_aux: bool = False):
        """x: [B, S, d] -> (out [B, S, d], aux): ``apply_moe``.  ``aux``,
        the f32 load-balance loss, is computed only ``with_aux`` (else
        None)."""
        me = self.me
        B, S, d = x.shape
        if self.split is None:
            out, aux = self._dense(x.reshape(B * S, d), with_aux)
        else:
            if S % self.mesh.shape["model"] == 0:
                out, aux = self._ep(x, with_aux)
            else:
                out, aux = self._dense(x.reshape(B * S, d), with_aux)
        out = out.reshape(B, S, d).to(x.dtype)
        if me.n_shared:
            out = out + self.shared(x)
        return out, (aux if with_aux else None)

    def _experts_of(self, buf):
        return _experts(buf, self.w_gate, self.w_up, self.w_down)

    def _dense(self, xt, with_aux: bool, f32: bool = False):
        """The reference's ``_apply_moe_dense`` over every token ``xt``
        [T, d]; on a mesh, as GSPMD partitions it (the decode path):
        this rank's experts, all-gathered over 'model', or its f slice of
        every expert, all-reduced.  ``f32`` combines in f32, as the EP
        paths do (``ep_oracle``)."""
        me = self.me
        T, E = xt.shape[0], me.n_experts
        probs = route(xt, self.router)
        cap = capacity(me.capacity_factor, me.top_k, T, E)
        buf, dst, keep, gate, counts, _ = local_dispatch(
            xt, probs, me.top_k, cap, E)
        if self.split == "experts":
            n, group = self.w_gate.shape[0], self.mesh.groups["model"]
            lo = self.mesh.coords["model"] * n

            def take(t):
                return t.narrow(0, lo, n)

            def join(t):
                return _all_gather(t, group).reshape(E, *t.shape[1:])
            ye = _Join.apply(self._experts_of(_Block.apply(buf, take, join)),
                             take, join)
        elif self.split == "f":
            group = self.mesh.groups["model"]
            ye = _AllReduce.apply(self._experts_of(
                _Replicated.apply(buf, [group])), group)
        else:
            ye = self._experts_of(buf)
        out = _combine(ye, dst, keep, gate, me.top_k, f32)
        return out, (_aux(probs, counts, keep.sum(), E) if with_aux
                     else None)

    def _ep(self, x, with_aux: bool):
        """``_apply_moe_ep`` / ``_apply_moe_ep_fshard``: this rank's
        tokens through its experts or f slice; the output blocks
        all-gathered back to [B, S, d] (every rank the same) and ``aux``
        averaged over the ranks.  The router's gradient is summed over
        every rank, the expert rows' over the data axes."""
        me, mesh = self.me, self.mesh
        B, S, d = x.shape
        E, tp, group = me.n_experts, mesh.shape["model"], \
            mesh.groups["model"]
        dp = [a for a in ("pod", "data") if a in mesh.shape]
        n_dp = int(np.prod([mesh.shape[a] for a in dp]))
        if B % n_dp:
            raise ValueError(f"batch {B} does not split over the data "
                             f"axes {dp} ({n_dp} ranks)")
        def take(t):
            return rank_tokens(t, mesh)

        def join(t):
            return join_tokens(t, mesh, B, S)
        xt = _Block.apply(x, take, join)
        t = xt.shape[0]
        dp_groups = [mesh.groups[a] for a in dp if mesh.groups.get(a)]
        w_gate, w_up, w_down = (_Replicated.apply(w, dp_groups) for w in (
            self.w_gate, self.w_up, self.w_down))
        probs = route(xt, _Replicated.apply(self.router, [None]))
        cap = capacity(me.capacity_factor, me.top_k, t, E)
        buf, dst, keep, gate, counts, _ = local_dispatch(
            xt, probs, me.top_k, cap, E)
        if self.split == "experts":
            # experts scatter over 'model', token chunks gather:
            # recv[e, src * cap + c] = buf of rank src [own experts e, c]
            n = E // tp
            recv = _AllToAll.apply(buf, group).reshape(tp, n, cap, d)
            y = _experts(recv.transpose(0, 1).reshape(n, tp * cap, d),
                         w_gate, w_up, w_down)
            back = y.reshape(n, tp, cap, d).transpose(0, 1)
            ye = _AllToAll.apply(back, group).reshape(E, cap, d)
        else:
            # every expert on this rank's f slice of all ranks' buffers;
            # the partial outputs go back to their senders, summed there
            # in rank order
            bufs = _GatherParts.apply(buf, group)        # [tp, E, cap, d]
            y = _experts(bufs.transpose(0, 1).reshape(E, tp * cap, d),
                         w_gate, w_up, w_down)
            ye = _sum_in_order(_AllToAll.apply(
                y.reshape(E, tp, cap, d).transpose(0, 1), group))
        out = _combine(ye, dst, keep, gate, me.top_k, f32=True).to(x.dtype)
        aux = (_PMean.apply(_aux(probs, counts, keep.sum(), E), mesh)
               if with_aux else None)
        return _Join.apply(out, take, join).reshape(B * S, d), aux


def ep_oracle(moe: MoE, x, n_data: int, n_model: int):
    """The plain per-rank semantics of the EP paths on one device: each
    (data, model) block of x [B, S, d] (batch over ``n_data``, sequence
    over ``n_model``) through the dense layer alone, ``cap`` from its own
    tokens, combined in f32 as the EP paths combine; ``aux`` the blocks'
    mean.  ``moe`` holds every expert whole (no mesh).  Shared experts
    are not added."""
    me = moe.me
    B, S, d = x.shape
    b, s = B // n_data, S // n_model
    out = torch.empty(B, S, d, dtype=x.dtype, device=x.device)
    aux = []
    for i in range(n_data):
        for j in range(n_model):
            blk = x[i * b:(i + 1) * b, j * s:(j + 1) * s]
            o, a = moe._dense(blk.reshape(-1, d), True, f32=True)
            out[i * b:(i + 1) * b, j * s:(j + 1) * s] = o.reshape(b, s, d)
            aux.append(a)
    return out, torch.stack(aux).mean()


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
