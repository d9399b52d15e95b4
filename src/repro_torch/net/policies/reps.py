"""REPS — REcycling Entropies for Packet Spraying (Bonato et al.,
arXiv:2407.21625), the 11th registered scheme.

Port of ``repro.net.policies.reps``.  A clean ACK recycles its entropy
value (a path index) into a per-flow FIFO cache of ``REPS_SLOTS``; the
next packets pop the cache front instead of drawing fresh uniform
entropy.  An ECN-marked ACK is simply not recycled; a NACK or timeout
removes every cached copy of its EV.  Recycled packets do not feed the
network ECN estimate (``explored`` is false for them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.net.policies import base as PB
from repro_torch.net.policies.spritz import (ACK_OK, NACK, TIMEOUT,
                                             _buffer_push_back,
                                             _buffer_remove)

FAMILY = "reps"
REPS_SLOTS = 8           # cached EVs per flow (== Spritz buffer_paths size)


class RepsConfig(NamedTuple):
    pass                 # REPS has no tunables beyond the cache size


class RepsState(NamedTuple):
    cache: torch.Tensor  # [F, B] i32 recycled EVs, -1 = empty (FIFO)


def _make_cfg(spec) -> RepsConfig:
    del spec
    return RepsConfig()


def _init_state(weights: torch.Tensor, static_path: torch.Tensor
                ) -> RepsState:
    del static_path
    return RepsState(cache=torch.full((weights.shape[0], REPS_SLOTS), -1,
                                      dtype=torch.int32,
                                      device=weights.device))


def _choose_path(state: RepsState, cfg: RepsConfig,
                 tables: PB.PolicyTables, ctx: PB.SendCtx):
    del cfg, tables
    fresh = PB.sample_path(ctx, ctx.weights)
    front = state.cache[:, 0]
    have = front >= 0
    path = torch.where(have, front, fresh)
    popped = torch.cat([state.cache[:, 1:],
                        torch.full_like(state.cache[:, :1], -1)], dim=1)
    pop = have & ctx.active
    cache = torch.where(pop[:, None], popped, state.cache)
    # recycled packets are not "sampled" for the network ECN estimate
    return path, ~have, RepsState(cache=cache)


def _on_feedback(state: RepsState, cfg: RepsConfig,
                 tables: PB.PolicyTables, ctx: PB.FeedbackCtx) -> RepsState:
    del cfg, tables
    evc = ctx.ev          # the engine passes a valid path index (0 if none)
    recycle = ctx.fb_type == ACK_OK
    invalidate = (ctx.fb_type == NACK) | (ctx.fb_type == TIMEOUT)
    cache = _buffer_push_back(state.cache, evc, recycle)
    cache = _buffer_remove(cache, evc, invalidate)
    return RepsState(cache=cache.to(torch.int32))


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (REPS,)"""
    (reps,) = codes
    return (PB.PolicyDef(
        name="reps", code=reps, family=FAMILY, make_cfg=_make_cfg,
        choose_path=_choose_path, on_feedback=_on_feedback,
        init_state=_init_state,
        uniform_weights=True, failover=True,
        # flow level: keep the path while its ACKs stay clean (recycled
        # entropy), redraw fresh uniform entropy when it crosses a hot
        # link (the ECN mark that stops a recycle) or a failed port
        flow_level=PB.FlowLevelRule("recycle", n_cands=1),
        doc="REPS: recycle clean-ACK entropies, fresh on ECN/NACK/RTO"),)
