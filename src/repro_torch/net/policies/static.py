"""Static / oblivious sender policies: MINIMAL, ECMP, VALIANT.

Port of ``repro.net.policies.static``.  MINIMAL and ECMP share one
stateless ``choose_path`` (the lane's static path) and differ only in
the host lane rule; VALIANT samples a random intermediate per packet
from the per-hop-uniform Valiant weights.
"""
from __future__ import annotations

from repro_torch.net.policies import base as PB


def _no_cfg(spec):
    del spec
    return None


def _choose_static(state, cfg, tables: PB.PolicyTables, ctx: PB.SendCtx):
    del state, cfg, tables
    return ctx.static_path, PB.all_explored(ctx.static_path), None


def _choose_valiant(state, cfg, tables: PB.PolicyTables, ctx: PB.SendCtx):
    del state, cfg
    path = PB.sample_path(ctx, tables.valiant_w)
    return path, PB.all_explored(path), None


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (MINIMAL, ECMP, VALIANT) integer scheme ids."""
    minimal, ecmp, valiant = codes
    return (
        PB.PolicyDef(
            name="minimal", code=minimal, family=None, make_cfg=_no_cfg,
            choose_path=_choose_static, pin_minimal=True,
            flow_level=PB.FlowLevelRule("static", init="minimal"),
            doc="shortest-path routing pinned to the minimal route"),
        PB.PolicyDef(
            name="ecmp", code=ecmp, family=None, make_cfg=_no_cfg,
            choose_path=_choose_static,
            flow_level=PB.FlowLevelRule("static"),
            doc="per-flow static hash onto one equal-cost path"),
        PB.PolicyDef(
            name="valiant", code=valiant, family=None, make_cfg=_no_cfg,
            choose_path=_choose_valiant, failover=True,
            flow_level=PB.FlowLevelRule("static"),
            doc="per-packet random intermediate (Valiant) routing"),
    )
