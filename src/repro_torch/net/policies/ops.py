"""Oblivious packet spraying: OPS(u) uniform / OPS(w) Eq.-1 weighted.

Port of ``repro.net.policies.ops``.  Stateless per-packet weighted
sampling over the lane's weights; the uniform-vs-weighted distinction is
the host lane rule ``uniform_weights`` alone, so both schemes share one
``choose_path``.
"""
from __future__ import annotations

from repro_torch.net.policies import base as PB


def _no_cfg(spec):
    del spec
    return None


def _choose_path(state, cfg, tables: PB.PolicyTables, ctx: PB.SendCtx):
    del state, cfg, tables
    path = PB.sample_path(ctx, ctx.weights)
    return path, PB.all_explored(path), None


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (OPS_U, OPS_W)"""
    ops_u, ops_w = codes
    return (
        PB.PolicyDef(
            name="ops_u", code=ops_u, family=None, make_cfg=_no_cfg,
            choose_path=_choose_path, uniform_weights=True, failover=True,
            flow_level=PB.FlowLevelRule("respray"),
            doc="oblivious packet spraying, uniform over live paths"),
        PB.PolicyDef(
            name="ops_w", code=ops_w, family=None, make_cfg=_no_cfg,
            choose_path=_choose_path, failover=True,
            flow_level=PB.FlowLevelRule("respray", init="weighted",
                                        cands="eq1_scaled"),
            doc="oblivious packet spraying, Eq.-1 weighted"),
    )
