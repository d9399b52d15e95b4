"""UGAL-L: per-packet choice between the minimal route and a Valiant
candidate by comparing (local queue occupancy x hop count) at the first
hop — the switch-local UGAL approximation the paper benchmarks against.

Port of ``repro.net.policies.ugal``: the candidate comes from the
Valiant weights through the tick's one shared path draw, and the
comparison is in f32 as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.net.policies import base as PB


def _no_cfg(spec):
    del spec
    return None


def _choose_path(state, cfg, tables: PB.PolicyTables, ctx: PB.SendCtx):
    del state, cfg
    cand = PB.sample_path(ctx, tables.valiant_w)
    fidx = torch.arange(tables.min_path.shape[0], device=cand.device)
    first_min = tables.path_ports[fidx, tables.min_path, 0]
    first_val = tables.path_ports[fidx, cand, 0]
    q_min = ctx.occ[first_min].float()
    q_val = ctx.occ[first_val].float()
    h_min = tables.path_len[fidx, tables.min_path].float()
    h_val = tables.path_len[fidx, cand].float()
    pick_min = q_min * h_min <= q_val * h_val
    path = torch.where(pick_min, tables.min_path, cand)
    return path, PB.all_explored(path), None


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (UGAL_L,)"""
    (ugal_l,) = codes
    return (PB.PolicyDef(
        name="ugal_l", code=ugal_l, family=None, make_cfg=_no_cfg,
        choose_path=_choose_path,
        flow_level=PB.FlowLevelRule("ugal", init="weighted", n_cands=1),
        doc="UGAL-L: minimal vs Valiant by local queue x hops"),)
