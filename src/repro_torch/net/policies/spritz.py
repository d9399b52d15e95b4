"""Spritz sender-based load balancing (paper §IV, Algorithms 1-3).

Port of ``repro.net.policies.spritz`` on torch tensors, batched over
flows:

  w            [F, P]  sampling weights (Eq. 1 init; 0 = temporarily blocked)
  w_orig       [F, P]  pristine weights (timer restore target)
  ecn_counts   [F, P]  per-path ECN counters (Scout)
  buffer       [F, B]  cached good-path EV ids, -1 = empty slot (B = 8)
  packet_count [F]     packets since last forced exploration
  blocked_until[F, P]  tick at which a timeout-blocked path is re-enabled

SCOUT keeps the buffer front until negative feedback evicts it; SPRAY
pops the front on every use.  Every f32 constant is the f32 value the
reference's weakly typed Python floats become, so the float steps match
bit for bit.  With ``use_kernels`` the selection core of Algorithm 1
runs through ``kernels.ops.spritz_select``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import _parity as PAR
from repro_torch.kernels import ops as KOPS
from repro_torch.net.policies import base as PB

SCOUT = 0
SPRAY = 1

BUF_SLOTS = 8  # paper: "fixed size buffer_paths with 8 positions"


class SpritzConfig(NamedTuple):
    explore_threshold: int = 44     # packets (0.5 * BDP, Table II)
    ecn_threshold: int = 8          # marked ACKs per path  (~0.1 * BDP)
    ecn_rate_bias: float = 0.9      # ecn_rate above which we bias minimal
    min_bias_factor: float = 8.0    # w[0] override under uniform congestion
    block_ticks: int = 1 << 18      # timeout-block duration (§IV-C)
    insert_cooldown: int = 2048     # Scout: an evicted EV may not re-enter
    #   buffer_paths for this many ticks (the reference's DESIGN §9 deviation)
    variant: int = SCOUT
    weight_update: bool = True      # §IV ❸-1 weight update (Scout)
    w_down: float = 0.5
    w_up: float = 1.25
    w_floor: float = 0.05
    use_kernels: bool = True        # Algorithm 1 through ops.spritz_select


class SpritzState(NamedTuple):
    w: torch.Tensor              # [F, P] float32
    w_orig: torch.Tensor         # [F, P] float32
    ecn_counts: torch.Tensor     # [F, P] int32
    buffer: torch.Tensor         # [F, B] int32 (EV ids, -1 empty)
    packet_count: torch.Tensor   # [F] int32
    blocked_until: torch.Tensor  # [F, P] int32
    no_insert_until: torch.Tensor  # [F, P] i32 (Scout eviction cooldown)


def init_state(weights: torch.Tensor) -> SpritzState:
    """weights: [F, P] Eq.-1 weights (0 beyond each flow's n_paths).
    ``w`` and ``w_orig`` are distinct tensors."""
    F, P = weights.shape
    dev = weights.device
    zi = dict(dtype=torch.int32, device=dev)
    return SpritzState(
        w=weights.float().clone(),
        w_orig=weights.float().clone(),
        ecn_counts=torch.zeros((F, P), **zi),
        buffer=torch.full((F, BUF_SLOTS), -1, **zi),
        packet_count=torch.zeros((F,), **zi),
        blocked_until=torch.zeros((F, P), **zi),
        no_insert_until=torch.zeros((F, P), **zi),
    )


def effective_weights(state: SpritzState, t: torch.Tensor) -> torch.Tensor:
    """Blocked paths contribute 0; expired blocks are (lazily) restored
    to their original Eq.-1 weight."""
    blocked = t < state.blocked_until
    restored = torch.where(state.w == 0.0, state.w_orig, state.w)
    return torch.where(blocked, 0.0, restored)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[f, idx[f]]`` per row."""
    return torch.gather(a, 1, idx.long()[:, None])[:, 0]


# --------------------------------------------------------------------- send
def send_logic(state: SpritzState, cfg: SpritzConfig, u: torch.Tensor | None,
               t: torch.Tensor, active: torch.Tensor, rng=None
               ) -> tuple[SpritzState, torch.Tensor, torch.Tensor]:
    """Algorithm 1 for every flow at once; ``u`` is the tick's [F, 1]
    path draw, or None with ``cfg.use_kernels``: then the kernel draws
    it from ``rng`` (the carry's key) at tick ``t``.  State only changes
    for ``active`` flows.  Returns (new_state, ev_index[F],
    explored[F])."""
    w_eff = effective_weights(state, t)
    explore = state.packet_count >= cfg.explore_threshold
    buf_front = state.buffer[:, 0]
    buf_nonempty = buf_front >= 0
    # a buffered EV whose timeout-block is still running is not reused
    front_blocked = buf_nonempty & (
        _take(state.blocked_until, buf_front.clamp_min(0)) > t)

    if cfg.use_kernels:
        # the kernel fuses sampling + explore counter + front selection; a
        # blocked front is passed as -1 (empty), which gives the
        # use_buffer = ~explore & nonempty & ~blocked rule exactly
        front_eff = torch.where(front_blocked, -1, buf_front)
        draw = dict(rng=rng, t=t) if u is None else {}
        ev, _, use_buffer = KOPS.spritz_select(
            w_eff, None if u is None else u[:, 0], front_eff,
            state.packet_count, explore_threshold=cfg.explore_threshold,
            **draw)
    else:
        if u is None:
            raise ValueError("send_logic: the torch form needs the path "
                             "draw u")
        sampled = PB.weighted_sample_rows(u, w_eff)
        use_buffer = ~explore & buf_nonempty & ~front_blocked
        ev = torch.where(use_buffer, buf_front, sampled)

    # Spray consumes the front slot whenever the walk consults the buffer
    popped = torch.cat([state.buffer[:, 1:],
                        torch.full_like(state.buffer[:, :1], -1)], dim=1)
    pop = ~explore & buf_nonempty & (cfg.variant == SPRAY) & active
    new_buffer = torch.where(pop[:, None], popped, state.buffer)

    new_count = torch.where(explore, 0, state.packet_count + 1)
    new_count = torch.where(active, new_count, state.packet_count)

    return (state._replace(buffer=new_buffer,
                           packet_count=new_count.to(torch.int32)),
            ev, ~use_buffer)


# ----------------------------------------------------------------- feedback
ACK_OK, ACK_ECN, NACK, TIMEOUT, NO_FB = 0, 1, 2, 3, 4


def _slots(buffer: torch.Tensor) -> torch.Tensor:
    return torch.arange(buffer.shape[1], dtype=torch.int32,
                        device=buffer.device)[None, :]


def _buffer_remove(buffer: torch.Tensor, ev: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Remove (all occurrences of) ev from each masked row, compacting left."""
    B = buffer.shape[1]
    hit = (buffer == ev[:, None]) & mask[:, None]
    kept = torch.where(hit, -1, buffer)
    idx = _slots(buffer)
    key = torch.where(kept < 0, B + idx, idx)   # unique per row
    order = torch.argsort(key, dim=1, stable=True)
    return torch.gather(kept, 1, order)


def _buffer_insert_sorted(buffer: torch.Tensor, ev: torch.Tensor,
                          lat: torch.Tensor, path_lat: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Scout: insert ev by ascending latency into rows where mask holds,
    only if not already present and a free slot exists."""
    B = buffer.shape[1]
    present = (buffer == ev[:, None]).any(1)
    size = (buffer >= 0).sum(1)
    do = mask & ~present & (size < B) & (ev >= 0)
    buf_lat = torch.where(
        buffer >= 0, torch.gather(path_lat, 1, buffer.clamp_min(0).long()),
        PAR.f32(3.4e38))
    pos = (buf_lat <= lat[:, None]).sum(1)[:, None]
    idx = _slots(buffer)
    shifted = torch.cat([buffer[:, :1], buffer[:, :-1]], dim=1)
    inserted = torch.where(idx < pos, buffer,
                           torch.where(idx == pos, ev[:, None], shifted))
    return torch.where(do[:, None], inserted, buffer)


def _buffer_push_back(buffer: torch.Tensor, ev: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Spray: append ev (duplicates allowed) if a slot is free."""
    B = buffer.shape[1]
    size = (buffer >= 0).sum(1)
    do = mask & (size < B) & (ev >= 0)
    appended = torch.where(_slots(buffer) == size[:, None], ev[:, None],
                           buffer)
    return torch.where(do[:, None], appended, buffer)


def feedback_logic(state: SpritzState, cfg: SpritzConfig, ev: torch.Tensor,
                   fb_type: torch.Tensor, ecn_rate: torch.Tensor,
                   path_lat: torch.Tensor, t: torch.Tensor) -> SpritzState:
    """Algorithms 2 (Scout) / 3 (Spray), batched over flows."""
    P = state.w.shape[1]
    evc = ev.clamp(0, P - 1).to(torch.int32)
    lat = _take(path_lat, evc)
    sel = evc[:, None] == torch.arange(P, dtype=torch.int32,
                                       device=ev.device)[None, :]

    is_ok = fb_type == ACK_OK
    is_ecn = fb_type == ACK_ECN
    is_nack = fb_type == NACK
    is_to = fb_type == TIMEOUT

    buffer = state.buffer
    ecn_counts = state.ecn_counts
    w = state.w
    blocked_until = state.blocked_until
    no_insert_until = state.no_insert_until
    if cfg.variant == SCOUT:
        if cfg.weight_update:
            bad = (is_ecn | is_nack)[:, None] & sel
            good = is_ok[:, None] & sel
            w = torch.where(bad & (w > 0),
                            (w * PAR.f32(cfg.w_down)).clamp_min(
                                PAR.f32(cfg.w_floor)), w)
            w = torch.where(good & (w > 0),
                            torch.minimum(w * PAR.f32(cfg.w_up),
                                          state.w_orig), w)
        in_cooldown = _take(no_insert_until, evc) > t
        buffer = _buffer_insert_sorted(buffer, evc, lat, path_lat,
                                       is_ok & ~in_cooldown)
        ecn_counts = ecn_counts + (sel & is_ecn[:, None]).to(torch.int32)
        over = (_take(ecn_counts, evc) > cfg.ecn_threshold) & is_ecn
        evict = over | is_nack | is_to
        ecn_counts = torch.where(evict[:, None] & sel, 0, ecn_counts)
        buffer = _buffer_remove(buffer, evc, evict)
        no_insert_until = torch.where(evict[:, None] & sel,
                                      t + cfg.insert_cooldown,
                                      no_insert_until)
    else:  # SPRAY: only positive feedback refills; ECN/NACK ignored.
        buffer = _buffer_push_back(buffer, evc, is_ok)

    # Timeout: temporarily block the path (both variants).
    blocked_until = torch.where(is_to[:, None] & sel, t + cfg.block_ticks,
                                blocked_until)
    w = torch.where(is_to[:, None] & sel, 0.0, w)

    # Uniformly high congestion: bias toward the minimal path (index 0).
    bias = (ecn_rate > PAR.f32(cfg.ecn_rate_bias)) & (fb_type != NO_FB)
    w = torch.cat([torch.where(bias, PAR.f32(cfg.min_bias_factor), w[:, 0])
                   [:, None], w[:, 1:]], dim=1)

    return state._replace(w=w, ecn_counts=ecn_counts.to(torch.int32),
                          buffer=buffer.to(torch.int32),
                          blocked_until=blocked_until.to(torch.int32),
                          no_insert_until=no_insert_until.to(torch.int32))


# ------------------------------------------------- policy layer adapters --
FAMILY = "spritz"


def _make_cfg(variant):
    def make_cfg(spec) -> SpritzConfig:
        return SpritzConfig(
            variant=variant,
            explore_threshold=spec.explore_threshold,
            ecn_threshold=spec.ecn_threshold,
            min_bias_factor=spec.min_bias_factor,
            block_ticks=spec.block_ticks,
            use_kernels=spec.use_kernels is not False,
        )
    return make_cfg


def _init_state(weights: torch.Tensor, static_path: torch.Tensor
                ) -> SpritzState:
    del static_path
    return init_state(weights)


def _choose_path(state: SpritzState, cfg: SpritzConfig,
                 tables: PB.PolicyTables, ctx: PB.SendCtx):
    state, ev, explored = send_logic(state, cfg, ctx.u, ctx.t, ctx.active,
                                     ctx.rng)
    return ev, explored, state


def _on_feedback(state: SpritzState, cfg: SpritzConfig,
                 tables: PB.PolicyTables, ctx: PB.FeedbackCtx) -> SpritzState:
    return feedback_logic(state, cfg, ctx.ev, ctx.fb_type, ctx.ecn_rate,
                          tables.path_lat, ctx.t)


def _policy(name: str, code: int, variant: int, *, uniform: bool,
            flow_level: PB.FlowLevelRule, doc: str) -> PB.PolicyDef:
    return PB.PolicyDef(
        name=name, code=code, family=FAMILY,
        make_cfg=_make_cfg(variant),
        choose_path=_choose_path, on_feedback=_on_feedback,
        init_state=_init_state,
        uniform_weights=uniform, failover=True, flow_level=flow_level,
        doc=doc)


def make_policies(codes) -> tuple[PB.PolicyDef, ...]:
    """codes: (SCOUT, SPRAY_U, SPRAY_W) integer scheme ids."""
    scout, spray_u, spray_w = codes
    return (
        _policy("spritz_scout", scout, SCOUT, uniform=False,
                flow_level=PB.FlowLevelRule("evict", init="weighted",
                                            cands="eq1_scaled",
                                            latency_pref=True),
                doc="Spritz-Scout: latency-sorted good-path cache (Alg. 2)"),
        _policy("spritz_spray_u", spray_u, SPRAY, uniform=True,
                flow_level=PB.FlowLevelRule("evict", cands="eq1"),
                doc="Spritz-Spray, uniform weights (Alg. 3)"),
        _policy("spritz_spray_w", spray_w, SPRAY, uniform=False,
                flow_level=PB.FlowLevelRule("evict", init="weighted",
                                            cands="eq1_scaled"),
                doc="Spritz-Spray, Eq.-1 weights (Alg. 3)"),
    )
