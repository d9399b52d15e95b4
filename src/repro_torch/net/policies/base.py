"""Sender-policy protocol (DESIGN.md §11), on torch tensors.

Port of ``repro.net.policies.base``.  A load-balancing scheme is a
*policy*: plain functions over a per-flow state ``NamedTuple`` of
tensors, registered in ``repro_torch.net.policies.registry``.  The engine
never names a scheme; it calls the registered functions.

    init_state(weights, static_path, device) -> state      (once)
    choose_path(state, cfg, tables, ctx) -> (path, explored, state)
    on_feedback(state, cfg, tables, ctx) -> state

``choose_path`` may only change state for ``ctx.active`` flows and
``on_feedback`` must be the identity where ``ctx.fb_type == FB_NONE``:
that is what keeps the event-horizon jump exact (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import _parity as PAR
from repro_torch.kernels import ops as KOPS


class PolicyTables(NamedTuple):
    """Static per-spec tensors every policy may consult."""

    path_ports: torch.Tensor   # [F, P, H] global port id per hop (-1 pad)
    path_len: torch.Tensor     # [F, P] hops incl. delivery port
    path_lat: torch.Tensor     # [F, P] f32 path latency (Scout's sort key)
    valiant_w: torch.Tensor    # [F, P] per-hop-uniform Valiant weights
    min_path: torch.Tensor     # [F] index of the minimal/static route


class SendCtx(NamedTuple):
    """Per-tick dynamic inputs to ``choose_path``.  The tick's path draw
    is ``u``, or, with the engine's kernels on, made inside the sampler's
    launch from ``rng`` and ``t`` (``u`` is then None): use
    :func:`sample_path`."""

    u: torch.Tensor | None     # [F, 1] f32 the tick's one path draw,
    #                            uniform(fold_in(base, t) -> k_path, (F, 1))
    t: torch.Tensor            # current tick, 0-d int32 on the device
    active: torch.Tensor       # [F] bool — flows that emit a packet this tick
    occ: torch.Tensor          # [n_ports] i32 analytic queue occupancy
    weights: torch.Tensor      # [F, P] lane sampling weights for this scheme
    static_path: torch.Tensor  # [F] lane ECMP/minimal static choice
    rng: torch.Tensor          # [2] int64 the carry's base key (uint32 words)


class FeedbackCtx(NamedTuple):
    """Per-tick feedback inputs to ``on_feedback``: the representative
    event per flow (priority TO > NACK > ECN > clean ACK, DESIGN.md §9)
    plus the exact per-class counts of this tick."""

    t: torch.Tensor            # current tick, 0-d int32 on the device
    ev: torch.Tensor           # [F] path index the feedback refers to
    fb_type: torch.Tensor      # [F] FB_* code (FB_NONE = no event this tick)
    ecn_rate: torch.Tensor     # [F] f32 running ECN rate over sampled packets
    n_mark: torch.Tensor       # [F] i32 ECN-marked ACKs this tick
    n_nack: torch.Tensor       # [F] i32 NACKs (trims) this tick
    n_to: torch.Tensor         # [F] i32 RTO timeouts this tick


@dataclasses.dataclass(frozen=True)
class FlowLevelRule:
    """Flow-level re-selection abstraction of a scheme (DESIGN.md §12);
    a host-side record, copied from the reference's registry so that the
    port's registry table is complete.  ``kind`` is one of ``static``,
    ``respray``, ``ugal``, ``evict`` or ``recycle``; ``init`` one of
    ``minimal``, ``uniform`` or ``weighted``; ``cands`` one of
    ``uniform``, ``eq1`` or ``eq1_scaled``."""

    kind: str
    init: str = "uniform"
    cands: str = "uniform"
    n_cands: int = 4
    hysteresis: float = 0.8
    latency_pref: bool = False

    def __post_init__(self):
        if self.kind not in ("static", "respray", "ugal", "evict", "recycle"):
            raise ValueError(f"unknown flow-level kind {self.kind!r}")
        if self.init not in ("minimal", "uniform", "weighted"):
            raise ValueError(f"unknown flow-level init {self.init!r}")
        if self.cands not in ("uniform", "eq1", "eq1_scaled"):
            raise ValueError(f"unknown flow-level cands {self.cands!r}")


@dataclasses.dataclass(frozen=True)
class PolicyDef:
    """One registered scheme.  ``family`` keys the scheme's substate in
    the engine's policy dict; ``uniform_weights`` / ``pin_minimal`` are
    the host lane rules ``build_spec`` and ``lane_arrays`` read."""

    name: str
    code: int
    family: str | None
    make_cfg: Callable[[Any], Any]
    choose_path: Callable[..., tuple]
    on_feedback: Callable[..., Any] | None = None
    init_state: Callable[..., Any] | None = None
    uniform_weights: bool = False
    pin_minimal: bool = False
    failover: bool = False
    flow_level: FlowLevelRule | None = None
    doc: str = ""


def weighted_sample_rows(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-row weighted index sample from the tick's ONE shared path draw
    ``u`` ([F, 1], ``SendCtx.u``), which every policy of the reference
    draws identically.  Rows with all-zero weights fall back to index 0."""
    csum = PAR.xla_cumsum_f32(w)
    uu = u * csum[:, -1:].clamp_min(PAR.f32(1e-30))
    return (csum < uu).sum(-1).clamp_max(w.shape[-1] - 1).to(torch.int32)


def sample_path(ctx: SendCtx, w: torch.Tensor) -> torch.Tensor:
    """``weighted_sample_rows`` of the tick's path draw over ``w`` [F,
    P]: one ``weighted_sample`` launch that draws ``u`` itself when the
    engine's kernels are on (``ctx.u`` is None), else the torch form on
    ``ctx.u``.  Bit-equal either way."""
    if ctx.u is None:
        return KOPS.weighted_sample(w, ctx.rng, ctx.t)
    return weighted_sample_rows(ctx.u, w)


def all_explored(ref: torch.Tensor) -> torch.Tensor:
    """Default ``explored`` flags: every packet counts as sampled."""
    return torch.ones(ref.shape[0], dtype=torch.bool, device=ref.device)
