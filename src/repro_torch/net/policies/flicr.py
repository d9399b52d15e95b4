"""FLICR (sender-side approximation): ECN-count-triggered weighted path
moves (DESIGN.md §9).

Port of ``repro.net.policies.flicr``.  The flow stays on its current
path until enough negative feedback accrues (``marks >= move_marks``;
NACKs and timeouts count 8x), then re-samples a weighted fresh path and
resets the counter.  The move happens for every flow over the threshold
on the executed tick, whether it sends or not, as in the reference;
marks only change on feedback, so event-free ticks are the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.net.policies import base as PB

FAMILY = "flicr"


class FlicrConfig(NamedTuple):
    move_marks: int = 8      # marks on the current path before moving


class FlicrState(NamedTuple):
    cur: torch.Tensor        # [F] i32 current path index
    marks: torch.Tensor      # [F] i32 accrued negative feedback


def _make_cfg(spec) -> FlicrConfig:
    return FlicrConfig(move_marks=spec.flicr_ecn_move)


def _init_state(weights: torch.Tensor, static_path: torch.Tensor
                ) -> FlicrState:
    del weights
    return FlicrState(cur=static_path.to(torch.int32).clone(),
                      marks=torch.zeros(static_path.shape[0],
                                        dtype=torch.int32,
                                        device=static_path.device))


def _choose_path(state: FlicrState, cfg: FlicrConfig,
                 tables: PB.PolicyTables, ctx: PB.SendCtx):
    del tables
    fresh = PB.sample_path(ctx, ctx.weights)
    move = state.marks >= cfg.move_marks
    cur = torch.where(move, fresh, state.cur)
    new_state = FlicrState(cur=cur, marks=torch.where(move, 0, state.marks))
    return cur, PB.all_explored(cur), new_state


def _on_feedback(state: FlicrState, cfg: FlicrConfig,
                 tables: PB.PolicyTables, ctx: PB.FeedbackCtx) -> FlicrState:
    del cfg, tables
    return state._replace(marks=(state.marks + ctx.n_mark
                                 + 8 * (ctx.n_nack + ctx.n_to)
                                 ).to(torch.int32))


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (FLICR_W,)"""
    (flicr_w,) = codes
    return (PB.PolicyDef(
        name="flicr_w", code=flicr_w, family=FAMILY, make_cfg=_make_cfg,
        choose_path=_choose_path, on_feedback=_on_feedback,
        init_state=_init_state,
        # single weighted candidate, move on any improvement: the flowlet
        # move has no Spritz-style hysteresis
        flow_level=PB.FlowLevelRule("evict", init="weighted",
                                    cands="eq1_scaled", n_cands=1,
                                    hysteresis=1.0),
        doc="FLICR: ECN-triggered weighted path moves (flowlet approx.)"),)
