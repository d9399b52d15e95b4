"""Packet-level network simulator with event-horizon time compression,
on torch tensors.

Port of ``repro.net.sim.engine`` (every registered scheme, static
networks, failure and capacity timelines, segmented runs, solo runs and
scheme x seed sweeps).  The model is the reference's (DESIGN.md
§3-§4): the in-flight packet table is a fixed-shape structure of
arrays, per-port FIFO order is kept analytically with one service-slot
counter per port,

    depart(pkt) = max(tail[port], t) + (rank_within_tick + 1) * ivl[port]

(``ivl`` is 1 at full rate) and time jumps to the next event tick
(``build_horizon``), which is exact because every skipped tick would
have been the identity.  Each step applies one ``build_tick``
transition, phases A0 (failure and capacity events), A (feedback, CC,
policy feedback), B (service, the rate audit), C (propagation), D
(injection with the policy's path choice) and E (enqueue: compaction,
FIFO rank, RED/ECN, trim).

Every operation reproduces the reference's arithmetic, so a run is
bit-identical to ``repro.net.sim.engine.run`` on the same spec and seed:
the random draws use the same threefry stream (``_parity``), f32 sums
and fused steps follow XLA's order, and integer scatters are exact in
any order.  With ``use_kernels`` (the default) the tick's dense phases
go through ``kernels.ops``: the CUDA kernels on the card, their plain
versions on the CPU.

The run loop is the reference's device-side loop: one gated step
(``_Loop``) keeps the loop tick, the next event tick and the stop flag on
the device, so on the card it is captured once in a CUDA graph and
replayed, with one host read of the stop flag per ``STEPS_PER_READ``
steps; on the CPU the same step runs eagerly.  ``run(until_tick=...)``
stops a segment between steps and ``run(resume=checkpoint(res, state))``
continues it, bit-identical to one unsegmented run; a checkpoint's state
is the nested-NumPy form both packages emit, so it resumes in either.
``run_batch`` runs a scheme x seed sweep, each lane through the solo
loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import _parity as PAR
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.net.policies import base as PB
from repro_torch.net.policies import registry as REG
from repro_torch.net.sim.types import (FB_NACK, FB_NONE, FB_TIMEOUT,
                                       P_ACKWAIT, P_FREE, P_LOST,
                                       P_NACKWAIT, P_PROP, P_QUEUED,
                                       SimResult, SimSpec, enqueue_bound)

INF_TICK = 1 << 30
_NEVER_SVC = -(1 << 30)   # last_svc sentinel: first service always legal
_I32 = torch.int32

# one-hot intermediates ([M, n_ports] rank histogram, [N, n_flows] flow-sum
# product) are used while they stay under this many cells; beyond it the
# rank falls back to a stable argsort over the compacted enqueue set and
# the per-flow sums to a segment scatter-add (the reference's switch).
_ONEHOT_CELLS = 1 << 22


class Carry(NamedTuple):
    rng: torch.Tensor          # [2] int64: base key (uint32 words)
    q_tail: torch.Tensor       # [n_ports] i32
    port_up: torch.Tensor      # [n_ports] bool
    port_ivl: torch.Tensor     # [n_ports] i32 live service interval
    last_svc: torch.Tensor     # [n_ports] i32 last service tick
    fail_idx: torch.Tensor     # [] i32 first unapplied timeline event
    viol: torch.Tensor         # [] i32 services across a down port (== 0)
    rviol: torch.Tensor        # [] i32 services above scheduled rate (== 0)
    # packet table
    pstate: torch.Tensor       # [N] i32
    pflow: torch.Tensor        # [N] i32
    ppath: torch.Tensor        # [N] i32
    phop: torch.Tensor         # [N] i32
    pevent: torch.Tensor       # [N] i32
    pecn: torch.Tensor         # [N] bool
    pexp: torch.Tensor         # [N] bool (exploration/sampled packet)
    psent: torch.Tensor        # [N] i32
    ppsn: torch.Tensor         # [N] i32
    # flow state
    next_seq: torch.Tensor     # [F] i32
    acked: torch.Tensor
    retx_pend: torch.Tensor
    inflight: torch.Tensor
    inj_cnt: torch.Tensor
    exp_psn: torch.Tensor
    cwnd: torch.Tensor         # [F] f32
    alpha: torch.Tensor
    exp_alpha: torch.Tensor    # [F] f32 ECN rate over exploration packets
    round_acks: torch.Tensor
    round_marks: torch.Tensor
    round_nacks: torch.Tensor
    round_size: torch.Tensor
    policy: dict               # {family: substate} (DESIGN.md §11)
    # stats
    fct: torch.Tensor
    delivered: torch.Tensor
    trims: torch.Tensor
    timeouts: torch.Tensor
    ooo: torch.Tensor
    retx: torch.Tensor


def _event_ivls(spec: SimSpec) -> np.ndarray:
    """Per-event service intervals (ticks/packet, 0 = down).  A spec with
    an empty ``fail_event_ivl`` gets the binary encoding (up -> 1, down
    -> 0) from ``fail_event_up``."""
    if len(spec.fail_event_ivl) == len(spec.fail_event_tick):
        return np.asarray(spec.fail_event_ivl, np.int32)
    return np.where(spec.fail_event_up, 1, 0).astype(np.int32)


def _ceildiv(a: torch.Tensor, b) -> torch.Tensor:
    """``(a + b - 1) // b`` in int32 with floor division, as XLA computes
    it (products before it wrap in int32 on both devices)."""
    return torch.div(a + b - 1, b, rounding_mode="floor")


def _use_kernels(spec: SimSpec) -> bool:
    return spec.use_kernels is not False


def _padded(a: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([a, torch.full((1,), fill, dtype=a.dtype,
                                    device=a.device)])


def _scatter_at(base: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``base.at[idx].set(val)`` on a copy; ``idx`` is int64, ``val`` a
    scalar or a tensor that broadcasts to it."""
    out = base.clone()
    if isinstance(val, torch.Tensor):
        return out.scatter_(0, idx, val.to(base.dtype).expand(idx.shape))
    return out.scatter_(0, idx, val)


def _scatter_add(size: int, idx: torch.Tensor, src: torch.Tensor):
    out = torch.zeros(size, dtype=src.dtype, device=src.device)
    return out.scatter_add_(0, idx, src)


def sorted_rank(cport: torch.Tensor, ar_m: torch.Tensor) -> torch.Tensor:
    """The engine's torch form of the FIFO rank for large shapes: a
    stable sort, each run's start by ``cummax``, scattered back.
    ``ar_m`` is ``arange(M)`` in int32 on ``cport``'s device."""
    order = torch.argsort(cport, stable=True)
    sorted_port = cport[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=cport.device),
                          sorted_port[1:] != sorted_port[:-1]])
    seg_start = torch.cummax(torch.where(is_start, ar_m, 0), 0).values
    return torch.zeros_like(cport).scatter_(0, order,
                                            (ar_m - seg_start).to(_I32))


def build_tick(spec: SimSpec, device=None):
    """Returns the transition ``tick(carry, t) -> carry`` for ``spec``
    (its scheme fixed) on ``device`` (default ``"cuda"``).  ``t`` is a
    0-d int32 tensor on that device (or an int, copied there): nothing
    in the tick reads a value back to the host, so a CUDA graph can
    capture it."""
    dev = resolve_device(device)
    F = spec.n_flows
    N = spec.n_pkt
    NP_ = spec.n_ports

    def tens(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    path_ports = tens(spec.path_ports, _I32)          # [F,P,H]
    path_len = tens(spec.path_len, _I32)              # [F,P]
    path_lat = tens(spec.path_lat_ns, torch.float32)  # [F,P]
    weights = tens(spec.weights, torch.float32)
    valiant_w = tens(spec.valiant_w, torch.float32)
    static_path = tens(spec.static_path, _I32)
    min_path = tens(spec.min_path, _I32)
    ret_ticks = tens(spec.ret_ticks, _I32)            # [F,P]
    rem_ticks = tens(spec.rem_ticks, _I32)            # [F,P,H]
    H_REM = rem_ticks.shape[2]
    port_lat = tens(spec.port_lat, _I32)              # [ports]
    src_ep = tens(spec.src_ep, torch.int64)
    size_pkts = tens(spec.size_pkts, _I32)
    start_tick = tens(spec.start_tick, _I32)
    dep = tens(spec.dep, torch.int64)
    bg_mask = tens(spec.bg_mask, torch.bool)
    has_dep = bool((spec.dep >= 0).any())
    has_bg = bool(spec.bg_mask.any())

    # failure timeline (DESIGN.md §10); E_EV == 0 (a static network)
    # leaves phase A0 out
    E_EV = len(spec.fail_event_tick)
    fev_tick = tens(spec.fail_event_tick, _I32)           # [E]
    fev_port = tens(spec.fail_event_port, _I32)           # [E]
    fev_up = tens(spec.fail_event_up, torch.bool)         # [E]
    fev_ivl_np = _event_ivls(spec)
    fev_ivl = tens(fev_ivl_np, _I32)                      # [E]
    eidx = torch.arange(E_EV, dtype=_I32, device=dev)
    # the rate machinery runs only for plans with degraded intervals, as
    # the reference traces it only for them: a binary plan runs the same
    # operations (and launches) as before
    HAS_RATE = bool((fev_ivl_np > 1).any())

    n_eps = int(spec.src_ep.max()) + 1 if len(spec.src_ep) else 1
    M = enqueue_bound(N, NP_, n_eps)
    use_kernels = _use_kernels(spec)
    use_onehot_rank = M * NP_ <= _ONEHOT_CELLS
    use_gemm_sums = N * F <= _ONEHOT_CELLS

    ar_f = torch.arange(F, dtype=_I32, device=dev)
    ar_n = torch.arange(N, dtype=_I32, device=dev)
    ar_m = torch.arange(M, dtype=_I32, device=dev)
    prio_f = torch.arange(F, dtype=_I32, device=dev) * 9973
    key_tie = F - 1 - ar_f
    ar_np = torch.arange(NP_, dtype=_I32, device=dev)

    # CC constants: the reference mixes Python floats into f32 math, which
    # XLA evaluates with their f32 values
    g = spec.dctcp_g
    G_F32, ONE_MINUS_G = PAR.f32(g), PAR.f32(1 - g)
    CWND_MAX = PAR.f32(spec.cwnd_max)
    KMIN, RECIP = PAR.f32(spec.kmin), PAR.red_recip(spec.kmin, spec.kmax)

    tables = PB.PolicyTables(path_ports=path_ports, path_len=path_len,
                             path_lat=path_lat, valiant_w=valiant_w,
                             min_path=min_path)
    pol = REG.device_policy(spec.scheme)
    cfg = pol.make_cfg(spec)

    # ------------------------------------------------------- tick phases --
    def apply_failure_events(c: Carry, t: torch.Tensor):
        """A0 (DESIGN.md §10): apply every timeline event with tick <= t
        past the cursor; the last event per port wins (a scatter-max
        over the event index).  A port going down turns its queued
        packets into NACKs (counted as trims) and its packets on the wire
        into losses, and caps its queue tail at t."""
        if not E_EV:
            return (c.port_up, c.port_ivl, c.last_svc, c.fail_idx,
                    c.q_tail, c.pstate, c.pevent, c.trims)
        due = (eidx >= c.fail_idx) & (fev_tick <= t)
        last = torch.full((NP_ + 1,), -1, dtype=_I32, device=dev)
        last = last.scatter_reduce(
            0, torch.where(due, fev_port, NP_).long(),
            torch.where(due, eidx, -1), "amax")[:NP_]
        new_up = torch.where(last >= 0, fev_up[last.clamp_min(0)],
                             c.port_up)
        went_down = c.port_up & ~new_up
        fail_idx = (c.fail_idx + due.sum()).to(_I32)
        cur0 = path_ports[c.pflow, c.ppath, c.phop]
        cur_s = cur0.clamp(0, NP_ - 1)
        hit = went_down[cur_s]
        killq = (c.pstate == P_QUEUED) & hit
        killp = (c.pstate == P_PROP) & hit
        nack_at0 = t + rem_ticks[c.pflow, c.ppath,
                                 c.phop.clamp_max(H_REM - 1)]
        pstate0 = torch.where(killq, P_NACKWAIT,
                              torch.where(killp, P_LOST, c.pstate))
        pevent0 = torch.where(killq, nack_at0, c.pevent)
        trims0 = c.trims + _scatter_add(
            F + 1, torch.where(killq, c.pflow, F).long(),
            torch.ones(N, dtype=_I32, device=dev))[:F]
        q_tail0 = torch.where(went_down, torch.minimum(c.q_tail, t),
                              c.q_tail)
        if not HAS_RATE:
            return (new_up, c.port_ivl, c.last_svc, fail_idx, q_tail0,
                    pstate0, pevent0, trims0)
        # rate events: only up-events (ivl > 0) change the live interval
        # (a down port keeps its pre-outage one).  On a live port whose
        # interval changes, the backlog rescales so the k-th queued
        # packet's slot moves from t + k*old to t + k*new; last_svc is
        # reset to t - new_ivl so a service at the event tick is legal.
        applied = last >= 0
        ivl_ev = fev_ivl[last.clamp_min(0)]
        new_ivl = torch.where(applied & (ivl_ev > 0), ivl_ev, c.port_ivl)
        resc = applied & new_up & (new_ivl != c.port_ivl)
        backlog = (q_tail0 - t).clamp_min(0)
        q_tail0 = torch.where(
            resc, t + _ceildiv(backlog * new_ivl, c.port_ivl), q_tail0)
        presc = (pstate0 == P_QUEUED) & resc[cur_s]
        rel = (pevent0 - t).clamp_min(0)
        pevent0 = torch.where(
            presc, t + _ceildiv(rel * new_ivl[cur_s], c.port_ivl[cur_s]),
            pevent0)
        last_svc = torch.where(applied, t - new_ivl, c.last_svc)
        return (new_up, new_ivl, last_svc.to(_I32), fail_idx,
                q_tail0.to(_I32), pstate0, pevent0.to(_I32), trims0)

    if use_kernels:
        def flow_sums_fn(pflow):
            def flow_sums(rows):        # [K,N] int32 or bool -> [K,F] int32
                return KOPS.flow_agg(rows, pflow, n_flows=F)
            return flow_sums
    elif use_gemm_sums:
        def flow_sums_fn(pflow):
            flow_oh = (pflow[:, None] == ar_f[None, :]).float()   # [N, F]

            def flow_sums(rows):
                return (rows.float() @ flow_oh).to(_I32)
            return flow_sums
    else:
        def flow_sums_fn(pflow):
            idx = pflow.long()[:, None]

            def flow_sums(rows):
                # one scatter pass over all K columns (integer adds are
                # order-independent: bit-identical to the product)
                src = rows.to(_I32).T
                out = torch.zeros((F, src.shape[1]), dtype=_I32, device=dev)
                return out.scatter_add_(0, idx.expand_as(src), src).T
            return flow_sums

    def enqueue_rank(cport):
        """FIFO rank among same-tick enqueues per port, in compacted
        space (the same rank for valid entries in every form; the
        kernels' form is fused with RED/ECN in phase E)."""
        if use_onehot_rank:
            oh = cport[:, None] == ar_np[None, :]
            pos = torch.cumsum(oh.to(_I32), 0, dtype=_I32) * oh
            return (pos.sum(-1) - 1).clamp_min(0).to(_I32)
        return sorted_rank(cport, ar_m)

    def collect_feedback(c: Carry, pstate0, pevent0, t, flow_sums):
        """A: feedback arrivals + timeouts -> per-flow counts and the
        representative event per flow (priority TO > NACK > ECN > OK;
        min packet index within the winning class) via one composite
        scatter-min over key = (3 - class) * N + index."""
        ack_m = (pstate0 == P_ACKWAIT) & (pevent0 == t)
        nack_m = (pstate0 == P_NACKWAIT) & (pevent0 == t)
        inflight_states = ((pstate0 == P_QUEUED) | (pstate0 == P_PROP)
                           | (pstate0 == P_LOST))
        to_m = inflight_states & (t - c.psent > spec.rto_ticks)

        ecn_ack = ack_m & c.pecn
        sums = flow_sums(torch.stack([
            ack_m, ecn_ack, nack_m, to_m,
            (ack_m | nack_m) & c.pexp,
            (ecn_ack | nack_m) & c.pexp,
        ]))                                                  # [6, F]

        fb_m = ack_m | nack_m | to_m
        fb_cat = torch.where(to_m, FB_TIMEOUT,
                             torch.where(nack_m, FB_NACK,
                                         ecn_ack.to(_I32)))
        ckey = (FB_TIMEOUT - fb_cat) * N + ar_n
        BIGK = (FB_TIMEOUT + 1) * N
        kmin = torch.full((F + 1,), BIGK, dtype=_I32, device=dev)
        kmin = kmin.scatter_reduce(
            0, torch.where(fb_m, c.pflow, F).long(),
            torch.where(fb_m, ckey, BIGK).to(_I32), "amin")[:F]
        has_fb = kmin < BIGK
        rep_idx = torch.where(has_fb, kmin % N, N)
        fb_type = torch.where(has_fb, FB_TIMEOUT - kmin // N, FB_NONE)
        fb_ev = torch.where(has_fb, _padded(c.ppath, 0)[rep_idx.clamp_max(N)],
                            0)
        return ack_m, nack_m, to_m, sums, fb_ev.to(_I32), fb_type.to(_I32)

    def cc_round(c: Carry, n_ack, n_mark, n_nack, n_to):
        """CC: DCTCP alpha + SMaRTT-style QuickAdapt/FastIncrease, the
        reference's ``cc_round`` step for step."""
        cwnd, alpha = c.cwnd, c.alpha
        r_acks = c.round_acks + n_ack + n_nack
        r_marks = c.round_marks + n_mark + n_nack
        r_nacks = c.round_nacks + n_nack
        round_thr = torch.minimum(c.round_size, cwnd.to(_I32)).clamp_min(1)
        round_done = r_acks >= round_thr
        denom = r_acks.clamp_min(1)
        frac = r_marks / denom
        frac_trim = r_nacks / denom
        # (1 - g) * alpha + g * frac: inside the reference's while-loop XLA
        # CPU leaves this line unfused (each product rounds to f32, then
        # the sum), where it contracts exp_alpha below into an fma
        alpha_new = alpha * ONE_MINUS_G + frac * G_F32
        alpha = torch.where(round_done, alpha_new, alpha)
        cw_cut = (cwnd * (1 - alpha / 2)).clamp_min(1.0)
        cw_qa = (r_acks - r_nacks).float().clamp_min(1.0)
        cw_fi = (cwnd * 1.25).clamp_max(CWND_MAX)
        cw_round = torch.where(
            (frac_trim > 0.5) & spec.quick_adapt, torch.minimum(cw_qa, cw_cut),
            torch.where(r_marks > 0, cw_cut,
                        cw_fi if spec.fast_increase else cwnd))
        cwnd = torch.where(round_done, cw_round, cwnd)
        r_size = torch.where(round_done, cwnd.to(_I32).clamp_min(1),
                             c.round_size)
        r_acks = torch.where(round_done, 0, r_acks)
        r_marks = torch.where(round_done, 0, r_marks)
        r_nacks = torch.where(round_done, 0, r_nacks)
        # additive increase per clean ACK; hard reset only on timeout
        cwnd = (cwnd + n_ack / cwnd.clamp_min(1.0)).clamp_max(CWND_MAX)
        cwnd = torch.where(n_to > 0, 1.0, cwnd)
        return (cwnd, alpha, r_acks.to(_I32), r_marks.to(_I32),
                r_nacks.to(_I32), r_size.to(_I32))

    def tick(c: Carry, t) -> Carry:
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(int(t), dtype=_I32, device=dev)
        # the tick's two draws (the policies' path draw and the RED draw)
        # from positional per-tick keys, so skipping a tick leaves the
        # stream intact.  Under use_kernels the launches that read them
        # draw them in place from c.rng and t (the samplers, the fused
        # phase-E launch), so u_path stays None; only a capacity plan's
        # torch RED math needs unif drawn here.  Else tensor threefry.
        u_path = unif = None
        if not use_kernels:
            u_path, unif = KREF.tick_draws_reference(c.rng, t, n_flows=F,
                                                     n_cand=M)
        elif HAS_RATE:
            unif = KOPS.tick_draws(c.rng, t, n_flows=0, n_cand=M)[1]

        # ------------- A0. failure timeline events (DESIGN.md §10) ----------
        (port_up, port_ivl, last_svc, fail_idx, q_tail0, pstate0,
         pevent0, trims0) = apply_failure_events(c, t)
        # load signal for the policies: ticks to drain, so a degraded port
        # advertises proportionally more load for the same backlog
        occ = (q_tail0 - t).clamp_min(0)

        # ---------------- A. feedback arrivals + timeouts -------------------
        flow_sums = flow_sums_fn(c.pflow)
        ack_m, nack_m, to_m, sums, fb_ev, fb_type = collect_feedback(
            c, pstate0, pevent0, t, flow_sums)
        n_ack, n_mark, n_nack, n_to, n_exp, n_exp_bad = sums
        # (1 - g2) * exp_alpha + g2 * n_exp_bad / max(n_exp, 1), contracted
        exp_alpha = torch.where(
            n_exp > 0,
            PAR.fma_f32(torch.full_like(c.exp_alpha, ONE_MINUS_G),
                        c.exp_alpha,
                        (n_exp_bad * G_F32) / n_exp.clamp_min(1)),
            c.exp_alpha)

        cwnd, alpha, r_acks, r_marks, r_nacks, r_size = cc_round(
            c, n_ack, n_mark, n_nack, n_to)

        policy = c.policy
        if pol.family and pol.on_feedback is not None:
            fb_ctx = PB.FeedbackCtx(t=t, ev=fb_ev, fb_type=fb_type,
                                    ecn_rate=exp_alpha, n_mark=n_mark,
                                    n_nack=n_nack, n_to=n_to)
            policy = {**policy, pol.family: pol.on_feedback(
                policy[pol.family], cfg, tables, fb_ctx)}

        acked = c.acked + n_ack
        inflight = c.inflight - n_ack - n_nack - n_to
        retx_pend = c.retx_pend + n_nack + n_to
        done_now = (acked >= size_pkts) & (c.fct < 0)
        fct = torch.where(done_now, t - start_tick, c.fct)

        # free finished packet slots
        pstate = torch.where(ack_m | nack_m | to_m, P_FREE, pstate0)

        # ---------------- B. service (dequeue) ------------------------------
        svc = (pstate == P_QUEUED) & (pevent0 == t)
        cur_port = path_ports[c.pflow, c.ppath, c.phop]
        plen = path_len[c.pflow, c.ppath]
        at_delivery = c.phop == plen - 1
        deliver = svc & at_delivery
        forward = svc & ~at_delivery

        # OOO accounting at delivery (<= 1 delivery per flow per tick)
        dsums = flow_sums(torch.stack([
            torch.where(deliver, c.ppsn, 0), deliver.to(_I32)]))
        dpsn, has_del = dsums[0], dsums[1] > 0
        is_ooo = has_del & (dpsn != c.exp_psn)
        ooo = c.ooo + is_ooo.to(_I32)
        exp_psn = torch.where(has_del, torch.maximum(c.exp_psn, dpsn + 1),
                              c.exp_psn)

        # conformance counter: a service never crosses a down port
        cur_s = cur_port.clamp(0, NP_ - 1)
        viol = c.viol + (svc & ~port_up[cur_s]).sum().to(_I32)
        rviol = c.rviol
        if HAS_RATE:
            # rate audit: services on one port are >= its interval apart
            rviol = rviol + (svc & (t - last_svc[cur_s] < port_ivl[cur_s])
                             ).sum().to(_I32)
            last_svc = _padded(last_svc, _NEVER_SVC).scatter_reduce(
                0, torch.where(svc, cur_port, NP_).long(), t.expand(N),
                "amax")[:NP_]

        ret = ret_ticks[c.pflow, c.ppath]
        pevent = torch.where(deliver, t + ret, pevent0)
        pstate = torch.where(deliver, P_ACKWAIT, pstate)
        pevent = torch.where(forward, t + port_lat[cur_port], pevent)
        pstate = torch.where(forward, P_PROP, pstate)

        # ---------------- C. propagation arrivals ---------------------------
        arrive = (pstate == P_PROP) & (pevent == t)
        phop = torch.where(arrive, c.phop + 1, c.phop)

        # ---------------- D. injection --------------------------------------
        work_left = (c.next_seq < size_pkts) | (retx_pend > 0)
        eligible = ((t >= start_tick) & (acked < size_pkts) & work_left
                    & (inflight < torch.floor(cwnd).to(_I32)) & (c.fct < 0))
        if has_dep:
            fct_x = _padded(fct, 0)
            dep_done = (dep < 0) | (fct_x[dep.clamp_min(-1)] >= 0)
            eligible = eligible & dep_done
        # endpoint arbitration: one flow per source endpoint per tick, from
        # the low 16 bits of t * 40503 + f * 9973 wrapped in int32, as the
        # reference computes it
        prio = ((t * 40503 + prio_f) & 0xFFFF) + 1
        prio = torch.where(eligible, prio, 0)
        key = prio * F + key_tie                              # unique
        ep_best = torch.zeros(n_eps, dtype=_I32, device=dev).scatter_reduce(
            0, src_ep, key, "amax")
        win = eligible & (key == ep_best[src_ep])

        # free-slot allocation: k-th winner takes the k-th free slot
        free_m = pstate == P_FREE
        n_free = torch.cumsum(free_m.to(_I32), 0, dtype=_I32)
        win_rank = torch.cumsum(win.to(_I32), 0, dtype=_I32) - 1
        have_slot = win & (win_rank < n_free[-1])
        flow_slot = torch.searchsorted(n_free, win_rank.clamp_min(0) + 1,
                                       side="left", out_int32=True)

        # path choice through the scheme's registered policy
        send_ctx = PB.SendCtx(u=u_path, t=t, active=have_slot, occ=occ,
                              weights=weights, static_path=static_path,
                              rng=c.rng)
        path_sel, explored, sub2 = pol.choose_path(
            policy.get(pol.family) if pol.family else None, cfg, tables,
            send_ctx)
        if pol.family:
            policy = {**policy, pol.family: sub2}
        path_sel = path_sel.to(_I32)
        if has_bg:  # background jobs stay on static ECMP paths (paper §V-B)
            path_sel = torch.where(bg_mask, static_path, path_sel)

        # write new packets (scatter via trash row N)
        tgt = torch.where(have_slot, flow_slot, N).long()

        def scatter_new(arr, val):
            return _scatter_at(_padded(arr, 0), tgt, val)[:N]

        pflow = scatter_new(c.pflow, ar_f)
        ppath = scatter_new(c.ppath, path_sel)
        phop = scatter_new(phop, 0)
        psent = scatter_new(c.psent, t)
        ppsn = scatter_new(c.ppsn, c.inj_cnt)
        pecn = scatter_new(c.pecn, False)
        pexp = scatter_new(c.pexp, explored)
        pstate = scatter_new(pstate, P_PROP)   # placeholder
        pevent = scatter_new(pevent, t)
        # injected packets "arrive" at the hop-0 port this tick
        injected_pkt = scatter_new(torch.zeros(N, dtype=torch.bool,
                                               device=dev), True)

        is_retx = have_slot & (retx_pend > 0)
        retx_pend = retx_pend - is_retx.to(_I32)
        next_seq = c.next_seq + (have_slot & ~is_retx).to(_I32)
        inj_cnt = c.inj_cnt + have_slot.to(_I32)
        inflight = inflight + have_slot.to(_I32)
        retx_stat = c.retx + is_retx.to(_I32)

        # ---------------- E. enqueue (arrivals + injections) ----------------
        enq0 = arrive | injected_pkt
        eport_n = torch.where(enq0, path_ports[pflow, ppath, phop], NP_)
        failed = enq0 & (eport_n < NP_) & \
            ~port_up[eport_n.clamp_max(NP_ - 1)]
        enq = enq0 & ~failed
        pstate = torch.where(failed, P_LOST, pstate)

        # compact the <= M enqueues of this tick
        n_enq = torch.cumsum(enq.to(_I32), 0, dtype=_I32)
        cidx = torch.searchsorted(n_enq, ar_m + 1, side="left",
                                  out_int32=True)     # == N past the last
        valid = cidx < N
        cidx_s = cidx.clamp_max(N)
        cflow = _padded(pflow, F)[cidx_s]
        cpath = _padded(ppath, 0)[cidx_s]
        chop = _padded(phop, 0)[cidx_s]
        cport = _padded(eport_n, NP_)[cidx_s]

        # FIFO rank among same-tick arrivals per port (compacted), then
        # RED/ECN marking and trim on it
        ivl_e = None
        if use_kernels and not HAS_RATE:
            # one launch: rank, RED draw, RED/ECN, trim and slot (full
            # rate only)
            trim, mark, slot = KOPS.tick_rank_red_ecn(
                cport, valid, q_tail=q_tail0, t=t, rng=c.rng,
                qsize=spec.qsize, kmin=spec.kmin, kmax=spec.kmax,
                n_ports=NP_)
        else:
            rank = (KOPS.tick_rank(cport, n_ports=NP_) if use_kernels
                    else enqueue_rank(cport))
            cport_s = cport.clamp_max(NP_ - 1)
            tail_e = q_tail0[cport_s]
            if HAS_RATE:
                # backlog in packets: ticks to drain over the interval
                ivl_e = port_ivl[cport_s]
                occ_at = _ceildiv((tail_e - t).clamp_min(0), ivl_e) + rank
            else:
                occ_at = (tail_e - t).clamp_min(0) + rank
            trim = valid & (occ_at >= spec.qsize)
            # RED / ECN marking probability between kmin..kmax
            pr = ((occ_at.float() - KMIN) * RECIP).clamp(0.0, 1.0)
            mark = valid & ~trim & (unif < pr)
            if HAS_RATE:
                # rank-k accept departs at max(tail, t) + (k+1)*ivl
                slot = torch.maximum(tail_e, t) + (rank + 1) * ivl_e
            else:
                slot = torch.maximum(tail_e, t) + rank + 1
        accept = valid & ~trim
        pecn = pecn | _scatter_at(
            torch.zeros(N + 1, dtype=torch.bool, device=dev),
            torch.where(mark, cidx_s, N).long(), True)[:N]
        # trimmed: header continues + NACK returns (priority, prop-only)
        nack_at = t + rem_ticks[cflow.clamp_max(F - 1), cpath,
                                chop.clamp_max(H_REM - 1)]
        new_state = torch.where(trim, P_NACKWAIT, P_QUEUED)
        new_event = torch.where(trim, nack_at, slot)
        ctgt = torch.where(valid, cidx_s, N).long()
        pstate = _scatter_at(_padded(pstate, 0), ctgt,
                             torch.where(valid, new_state, 0))[:N]
        pevent = _scatter_at(_padded(pevent, 0), ctgt,
                             torch.where(valid, new_event, 0))[:N]

        trims = trims0 + _scatter_add(
            F + 1, torch.where(trim, cflow, F).long(),
            torch.ones(M, dtype=_I32, device=dev))[:F]
        timeouts = c.timeouts + n_to
        delivered = c.delivered + n_ack

        # q_tail advances by the interval per accepted packet (1 at full
        # rate)
        n_acc = _scatter_add(
            NP_ + 1, torch.where(accept, cport, NP_).long(),
            torch.ones(M, dtype=_I32, device=dev) if ivl_e is None
            else ivl_e.to(_I32))[:NP_]
        q_tail = torch.where(n_acc > 0, torch.maximum(q_tail0, t) + n_acc,
                             q_tail0)

        return Carry(
            rng=c.rng, q_tail=q_tail.to(_I32),
            port_up=port_up, port_ivl=port_ivl, last_svc=last_svc,
            fail_idx=fail_idx, viol=viol, rviol=rviol,
            pstate=pstate.to(_I32), pflow=pflow, ppath=ppath, phop=phop,
            pevent=pevent.to(_I32), pecn=pecn, pexp=pexp, psent=psent,
            ppsn=ppsn, next_seq=next_seq, acked=acked, retx_pend=retx_pend,
            inflight=inflight, inj_cnt=inj_cnt, exp_psn=exp_psn,
            cwnd=cwnd, alpha=alpha, exp_alpha=exp_alpha,
            round_acks=r_acks, round_marks=r_marks, round_nacks=r_nacks,
            round_size=r_size, policy=policy,
            fct=fct.to(_I32), delivered=delivered, trims=trims,
            timeouts=timeouts, ooo=ooo, retx=retx_stat,
        )

    return tick


def build_horizon(spec: SimSpec, device=None):
    """Returns ``horizon(carry, t) -> next event tick > t`` as a 0-d i32
    tensor (DESIGN.md §4): the min over scheduled packet events, RTO
    deadlines, injection eligibility (gated on a free table slot) and
    deferred CC round closure, and the next unapplied timeline event.
    Every tick strictly inside the jump is a no-op of the transition.
    ``device`` defaults to ``"cuda"``; ``t`` is a 0-d int32 tensor there
    (or an int)."""
    dev = resolve_device(device)
    size_pkts = torch.as_tensor(spec.size_pkts, dtype=_I32, device=dev)
    start_tick = torch.as_tensor(spec.start_tick, dtype=_I32, device=dev)
    dep = torch.as_tensor(spec.dep, dtype=torch.int64, device=dev)
    has_dep = bool((spec.dep >= 0).any())
    rto1 = spec.rto_ticks + 1
    # the next unapplied timeline event is an event: never jump over it
    E_EV = len(spec.fail_event_tick)
    fev_tick_x = torch.as_tensor(
        np.append(np.asarray(spec.fail_event_tick, np.int32), INF_TICK)
        .astype(np.int32), device=dev)

    def horizon(c: Carry, t) -> torch.Tensor:
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(int(t), dtype=_I32, device=dev)
        live = ((c.pstate == P_QUEUED) | (c.pstate == P_PROP)
                | (c.pstate == P_ACKWAIT) | (c.pstate == P_NACKWAIT))
        ev_pkt = torch.where(live, c.pevent, INF_TICK).min()
        to_states = ((c.pstate == P_QUEUED) | (c.pstate == P_PROP)
                     | (c.pstate == P_LOST))
        ev_rto = torch.where(to_states, c.psent + rto1, INF_TICK).min()
        # an eligible flow with a free table slot injects at every tick
        work_left = (c.next_seq < size_pkts) | (c.retx_pend > 0)
        elig = ((c.acked < size_pkts) & work_left & (c.fct < 0)
                & (c.inflight < torch.floor(c.cwnd).to(_I32)))
        if has_dep:
            fct_x = _padded(c.fct, 0)
            elig = elig & ((dep < 0) | (fct_x[dep.clamp_min(-1)] >= 0))
        any_free = (c.pstate == P_FREE).any()
        ev_inj = torch.where(
            any_free,
            torch.where(elig, torch.maximum(start_tick, t + 1),
                        INF_TICK).min(),
            INF_TICK)
        # deferred CC round closure
        round_thr = torch.minimum(c.round_size,
                                  c.cwnd.to(_I32)).clamp_min(1)
        pend_round = ((c.round_acks >= round_thr) & (c.fct < 0)).any()
        ev_cc = torch.where(pend_round, t + 1, INF_TICK)
        h = torch.minimum(torch.minimum(ev_pkt, ev_rto),
                          torch.minimum(ev_inj, ev_cc))
        if E_EV:
            # a gather: indexing by a 0-d tensor would read it to the host
            nxt = fev_tick_x.index_select(
                0, c.fail_idx.clamp_max(E_EV).reshape(1)).reshape(())
            h = torch.minimum(h, nxt)
        return torch.maximum(h, t + 1).to(_I32)

    return horizon


def init_carry(spec: SimSpec, seed: int = 0, device=None,
               weights: np.ndarray | None = None,
               static_path: np.ndarray | None = None) -> Carry:
    """The initial carry of ``spec`` on ``device`` (default ``"cuda"``).
    Timeline events at tick <= 0 are initial conditions: they are folded
    into ``port_up`` / ``port_ivl`` here, so a plan whose events all fire
    at t = 0 runs like the static ``failed_links`` build."""
    dev = resolve_device(device)
    F, N, NP_ = spec.n_flows, spec.n_pkt, spec.n_ports
    w = spec.weights if weights is None else weights
    sp = spec.static_path if static_path is None else static_path
    port_up0 = ~np.asarray(spec.port_failed, bool)
    port_ivl0 = np.ones(NP_, np.int32)
    ivl0 = _event_ivls(spec)
    n0 = int(np.searchsorted(spec.fail_event_tick, 0, side="right"))
    for i in range(n0):
        port_up0[spec.fail_event_port[i]] = bool(spec.fail_event_up[i])
        if ivl0[i] > 0:
            port_ivl0[spec.fail_event_port[i]] = int(ivl0[i])

    def zi(n):
        return torch.zeros(n, dtype=_I32, device=dev)

    def zb(n):
        return torch.zeros(n, dtype=torch.bool, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=_I32, device=dev)

    return Carry(
        rng=torch.tensor(PAR.prng_key(seed), dtype=torch.int64, device=dev),
        q_tail=zi(NP_),
        port_up=torch.as_tensor(port_up0, device=dev),
        port_ivl=torch.as_tensor(port_ivl0, device=dev),
        last_svc=torch.full((NP_,), _NEVER_SVC, dtype=_I32, device=dev),
        fail_idx=scalar(n0), viol=scalar(0), rviol=scalar(0),
        pstate=zi(N), pflow=zi(N), ppath=zi(N), phop=zi(N), pevent=zi(N),
        pecn=zb(N), pexp=zb(N), psent=zi(N), ppsn=zi(N),
        next_seq=zi(F), acked=zi(F), retx_pend=zi(F), inflight=zi(F),
        inj_cnt=zi(F), exp_psn=zi(F),
        cwnd=torch.full((F,), PAR.f32(spec.cwnd_init), dtype=torch.float32,
                        device=dev),
        alpha=torch.zeros(F, dtype=torch.float32, device=dev),
        exp_alpha=torch.zeros(F, dtype=torch.float32, device=dev),
        round_acks=zi(F), round_marks=zi(F), round_nacks=zi(F),
        round_size=torch.full((F,), max(int(spec.cwnd_init), 1), dtype=_I32,
                              device=dev),
        policy=REG.init_state(w, sp, dev),
        fct=torch.full((F,), -1, dtype=_I32, device=dev), delivered=zi(F),
        trims=zi(F), timeouts=zi(F), ooo=zi(F), retx=zi(F),
    )


def carry_from_state(spec: SimSpec, state: dict, device=None) -> Carry:
    """A carry on ``device`` (default ``"cuda"``) from the nested-NumPy
    state form (``carry_state`` here, ``_carry_state`` in the reference
    engine).  Shapes must match ``spec``."""
    tmpl = init_carry(spec, 0, device)

    def leaf(arr, ref):
        a = np.array(arr)                     # an owned, writable copy
        if a.shape != tuple(ref.shape):
            raise ValueError(f"state leaf shape {a.shape} != spec's "
                             f"{tuple(ref.shape)}: resume requires the "
                             "identical SimSpec")
        if ref.dtype == torch.int64:          # the rng's uint32 words
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=ref.device).to(ref.dtype)

    vals = {}
    for k in Carry._fields:
        ref = getattr(tmpl, k)
        if k == "policy":
            vals[k] = {fam: type(sub)(**{f: leaf(state["policy"][fam][f],
                                                 getattr(sub, f))
                                         for f in sub._fields})
                       for fam, sub in ref.items()}
        else:
            vals[k] = leaf(state[k], ref)
    return Carry(**vals)


def carry_state(carry: Carry) -> dict:
    """The carry as nested NumPy dicts in the reference's dtypes (the rng
    as uint32 words); ``"spritz"`` aliases the Spritz substate as in the
    reference."""
    def arr(x):
        a = _host(x)
        return a.astype(np.uint32) if x.dtype == torch.int64 else a

    state: dict = {}
    for k, v in carry._asdict().items():
        if k == "policy":
            state["policy"] = {fam: {f: arr(x) for f, x in
                                     sub._asdict().items()}
                               for fam, sub in v.items()}
        else:
            state[k] = arr(v)
    state["spritz"] = state["policy"]["spritz"]
    return state


def _host(x: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``x`` (never a view: the loop's state buffers are
    reused by the next run)."""
    return x.detach().to("cpu", copy=True).numpy()


def _result(carry: Carry, t: int, steps: int) -> SimResult:
    fct = _host(carry.fct)
    return SimResult(
        fct_ticks=fct,
        delivered=_host(carry.delivered),
        trims=_host(carry.trims),
        timeouts=_host(carry.timeouts),
        ooo=_host(carry.ooo),
        retx=_host(carry.retx),
        done=fct >= 0,
        ticks_simulated=int(t),
        steps_executed=int(steps),
        down_violations=int(carry.viol),
        rate_violations=int(carry.rviol),
    )


class Checkpoint(NamedTuple):
    """A resumable engine snapshot: the nested-NumPy carry state (the
    form ``return_carry=True`` emits, here and in the reference engine)
    and the loop counters.  ``run(spec, resume=cp)`` continues the loop
    from exactly this state."""

    state: dict   # nested numpy carry (incl. the stacked policy dict)
    t: int        # ticks simulated so far (the loop's current tick)
    steps: int    # horizon steps executed so far


def checkpoint(res: SimResult, state: dict) -> Checkpoint:
    """Pair a ``return_carry=True`` result with its carry state."""
    return Checkpoint(state=state, t=int(res.ticks_simulated),
                      steps=int(res.steps_executed))


def _flatten(c: Carry) -> list[torch.Tensor]:
    """The carry's leaves in a fixed order (policy families in the dict's
    order, each substate's fields in order)."""
    out = []
    for k in Carry._fields:
        v = getattr(c, k)
        if k == "policy":
            for sub in v.values():
                out.extend(sub)
        else:
            out.append(v)
    return out


def _unflatten(tmpl: Carry, leaves) -> Carry:
    """A carry of ``tmpl``'s structure over ``leaves`` (:func:`_flatten`'s
    order)."""
    it = iter(leaves)
    vals = {}
    for k in Carry._fields:
        v = getattr(tmpl, k)
        if k == "policy":
            vals[k] = {fam: type(sub)(*(next(it) for _ in sub))
                       for fam, sub in v.items()}
        else:
            vals[k] = next(it)
    return Carry(**vals)


def live_carry_bytes(carry: Carry) -> int:
    """Bytes of live carry state (the sum over its leaves).  The carry is
    occupancy-bounded (packet table + per-flow/per-port vectors, DESIGN.md
    §14): no leaf scales with n_ports x n_flows.  The rng's two uint32
    words are held in int64 here, 8 bytes more than the reference's."""
    return int(sum(x.numel() * x.element_size() for x in _flatten(carry)))


# Gated steps between two reads of the stop flag on the card; the CPU
# reads it after every step (a read costs nothing there, and a step past
# the stop costs a whole eager tick).
STEPS_PER_READ = 32


class _Loop:
    """The reference's device-side while-loop (``_make_loop``) for one
    spec on one device: one gated step over static state buffers,
    captured in a CUDA graph on the card and run eagerly on the CPU.

    The state is the carry's leaves, the loop tick ``t``, ``steps``, the
    segment ``limit``, the ``watch`` mask, and two values the step keeps
    for the next one: ``h``, the next tick (the event horizon, or ``t +
    1`` when ``dense``) capped at ``n_ticks``, and ``run``, the loop
    condition.  A step with ``run`` false changes nothing, so steps
    replayed past the stop are harmless and ``steps`` stays exact.

    The reference's last body, which jumps ``t`` to ``n_ticks`` without
    a transition, is folded into the step before it: ``run`` is true
    only when the next step applies a transition, so every step replayed
    before the stop is one of ``steps_executed``."""

    def __init__(self, spec: SimSpec, dev: torch.device, dense: bool):
        self.dev = dev
        self.n = spec.n_ticks
        self.tick = build_tick(spec, dev)
        self.hor = None if dense else build_horizon(spec, dev)
        self.tmpl = init_carry(spec, 0, dev)
        self.leaves = [x.clone() for x in _flatten(self.tmpl)]
        self.carry = _unflatten(self.tmpl, self.leaves)

        def i32(v):
            return torch.tensor(v, dtype=_I32, device=dev)
        self.t, self.steps, self.h = i32(-1), i32(0), i32(0)
        self.limit, self.n_t, self.n1_t = i32(self.n), i32(self.n), \
            i32(self.n - 1)
        self.run = torch.zeros((), dtype=torch.bool, device=dev)
        self.watch = torch.ones(spec.n_flows, dtype=torch.bool, device=dev)
        self.graph = None
        self.per_replay = None      # launch counts one replay makes

    def _refresh(self) -> None:
        """``h`` and ``run`` for the state as it stands; a state whose
        next tick reaches ``n_ticks`` jumps there (the reference's body
        without a transition) and stops."""
        c, t = self.carry, self.t
        h = t + 1 if self.hor is None else self.hor(c, t)
        h = torch.minimum(h, self.n_t)
        done = torch.where(self.watch, c.fct >= 0, True).all()
        alive = (t < self.n_t) & (t < self.limit) & ~done
        torch.where(alive & (h >= self.n_t), self.n_t, t, out=t)
        torch.logical_and(alive, h < self.n_t, out=self.run)
        self.h.copy_(h)

    def _step(self) -> None:
        """One gated step: the transition to ``h``, kept where ``run``."""
        c2 = self.tick(self.carry, torch.minimum(self.h, self.n1_t))
        for buf, new in zip(self.leaves, _flatten(c2)):
            if new is not buf:
                torch.where(self.run, new, buf, out=buf)
        torch.where(self.run, self.h, self.t, out=self.t)
        self.steps.add_(self.run.to(_I32))
        self._refresh()

    def load(self, carry: Carry, t: int, steps: int, watch: np.ndarray,
             limit: int) -> None:
        for buf, x in zip(self.leaves, _flatten(carry)):
            buf.copy_(x)
        self.t.fill_(t)
        self.steps.fill_(steps)
        self.limit.fill_(limit)
        self.watch.copy_(torch.as_tensor(watch))
        self._refresh()

    def _capture(self) -> None:
        """Warm the step up on a side stream (the kernels build, the
        allocator and the sorts' scratch settle), put the state back, and
        capture one step.  The wrappers' calls in both make no launch of
        the run: their counts are put back, and each replay is credited
        with what the capture recorded."""
        state = self.leaves + [self.t, self.steps, self.h, self.run]
        saved = [x.clone() for x in state]
        counts = KOPS.launch_counts()
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        # a host sync in the step raises here, naming its op (the mode is
        # process-wide: only the main thread sets it)
        debug = threading.current_thread() is threading.main_thread()
        with torch.cuda.stream(side):
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(2):
                    self._step()
            except RuntimeError as e:
                KOPS.set_launch_counts(counts)
                raise RuntimeError(f"the engine's step cannot be captured in "
                                   f"a CUDA graph: {e} (the traceback "
                                   f"names the op)") from e
            finally:
                if debug:
                    torch.cuda.set_sync_debug_mode("default")
        torch.cuda.current_stream(self.dev).wait_stream(side)
        for x, v in zip(state, saved):
            x.copy_(v)
        KOPS.set_launch_counts(counts)
        graph = torch.cuda.CUDAGraph()
        try:
            # the capture stream is this device's (torch's default one
            # belongs to the device current when it was first made)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self._step()
        except Exception as e:
            KOPS.set_launch_counts(counts)
            raise RuntimeError(f"capturing the engine's step in a CUDA "
                               f"graph failed: {e}") from e
        after = KOPS.launch_counts()
        self.per_replay = {name: {k: n - counts[name][k]
                                  for k, n in table.items()}
                           for name, table in after.items()}
        KOPS.set_launch_counts(counts)
        self.graph = graph

    def drive(self, k: int | None = None, capture: bool | None = None
              ) -> int:
        """Step until ``run`` is false, reading it once per ``k`` steps.
        ``capture`` (the default on the card) replays the captured step,
        by default :data:`STEPS_PER_READ` of them a read; otherwise the
        step runs eagerly, by default one a read.  Returns the number of
        steps run."""
        if capture is None:
            capture = self.dev.type == "cuda"
        if capture:
            if self.graph is None:
                with _COUNT_LOCK:
                    self._capture()
            k, advance = k or STEPS_PER_READ, self.graph.replay
        else:
            k, advance = k or 1, self._step
        replays = 0
        while bool(self.run):
            for _ in range(k):
                advance()
            replays += k
        if capture and replays:
            with _COUNT_LOCK:
                KOPS.add_launches(self.per_replay, replays)
        return replays

    def result(self, replays: int, return_carry: bool):
        res = _result(self.carry, int(self.t), int(self.steps))._replace(
            replays=replays)
        return (res, carry_state(self.carry)) if return_carry else res


_COUNT_LOCK = threading.RLock()
_LOOPS: dict = {}
_LOOPS_MAX = 32


def _spec_key(spec: SimSpec) -> tuple:
    """Content fingerprint of a spec: identical specs share one loop (and
    its captured graph)."""
    h = hashlib.blake2b(digest_size=16)
    scalars = []
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if isinstance(v, np.ndarray):
            h.update(f.name.encode())
            h.update(str(v.shape).encode() + str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif f.name != "name":
            scalars.append((f.name, v))
    return (tuple(scalars), h.hexdigest())


def _loop(spec: SimSpec, dev: torch.device, dense: bool) -> _Loop:
    # _ONEHOT_CELLS keys the cache too: tests patch the threshold to force
    # the fallback forms without changing the spec
    key = (_spec_key(spec), dense, str(dev), _ONEHOT_CELLS)
    with _COUNT_LOCK:
        loop = _LOOPS.get(key)
        if loop is None:
            if len(_LOOPS) >= _LOOPS_MAX:
                _LOOPS.pop(next(iter(_LOOPS)))
            loop = _LOOPS[key] = _Loop(spec, dev, dense)
    return loop


def _watch_mask(spec: SimSpec, stop_flows) -> np.ndarray:
    if stop_flows is None:
        return np.ones(spec.n_flows, bool)
    m = np.zeros(spec.n_flows, bool)
    m[np.asarray(stop_flows)] = True
    return m


def _run_lane(spec: SimSpec, dev: torch.device, dense: bool, carry: Carry,
              t0: int, steps0: int, watch: np.ndarray, limit: int,
              return_carry: bool):
    loop = _loop(spec, dev, dense)
    with _on(dev):
        loop.load(carry, t0, steps0, watch, limit)
        return loop.result(loop.drive(), return_carry)


def _on(dev: torch.device):
    """The device context of a card (kernels launch on the current
    device's stream); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _eager_run(spec: SimSpec, seed: int = 0, *, device=None,
               dense: bool = False, k: int = 1, return_carry: bool = False):
    """The gated loop run eagerly, without a graph: each step's wrappers
    launch their kernels as they are called.  ``chip_smoke.py`` holds the
    graph loop against it on the card; ``k`` is the steps between two
    reads of the stop flag."""
    dev = resolve_device(device)
    loop = _Loop(spec, dev, dense)
    with _on(dev):
        loop.load(init_carry(spec, seed, dev), -1, 0,
                  _watch_mask(spec, None), spec.n_ticks)
        return loop.result(loop.drive(k, capture=False), return_carry)


def run(spec: SimSpec, seed: int = 0, chunk: int | None = None,
        stop_flows: np.ndarray | None = None, reference: bool = False,
        return_carry: bool = False, until_tick: int | None = None,
        resume: Checkpoint | None = None, *, device=None):
    """Run the simulation for up to ``spec.n_ticks`` virtual ticks on
    ``device`` (default ``"cuda"``; raises if there is no CUDA device).

    The driver is the reference's device-side loop: one gated step,
    captured in a CUDA graph on the card and replayed with one read of
    the stop flag per :data:`STEPS_PER_READ` steps.  It stops as soon
    as every flow — or every flow in ``stop_flows`` — completed.
    ``reference=True`` selects the dense tick-by-tick stepper.
    ``chunk`` is accepted for compatibility with the reference and
    ignored.  ``return_carry=True`` also returns the final carry as
    nested NumPy dicts (:func:`carry_state`).  The result's ``replays``
    counts the steps the loop ran, those past the stop included.

    ``until_tick`` stops the segment once the loop's tick reaches it;
    ``resume`` continues from a :class:`Checkpoint` (or the reference's)
    taken over the same spec.  Segmenting is bit-identical to one
    unsegmented run::

        res, st = run(spec, seed, until_tick=W, return_carry=True)
        res = run(spec, resume=checkpoint(res, st))
    """
    del chunk
    dev = resolve_device(device)
    if resume is not None:
        carry = carry_from_state(spec, resume.state, dev)
        t0, steps0 = int(resume.t), int(resume.steps)
    else:
        carry, t0, steps0 = init_carry(spec, seed, dev), -1, 0
    limit = spec.n_ticks if until_tick is None else int(until_tick)
    return _run_lane(spec, dev, reference, carry, t0, steps0,
                     _watch_mask(spec, stop_flows), limit, return_carry)


run_reference = partial(run, reference=True)


def lane_arrays(spec: SimSpec, scheme) -> tuple[np.ndarray, np.ndarray]:
    """A scheme lane's (weights, static_path) derived from a base spec,
    by the registry's host lane rules (DESIGN.md §5/§11):
    ``uniform_weights`` schemes sample uniformly over each flow's paths,
    ``pin_minimal`` schemes pin foreground flows to the minimal route,
    every other scheme reuses the base spec's weights and ECMP draw.  The
    base spec must therefore be built with a weighted scheme."""
    return REG.lane_arrays(spec, scheme)


def run_batch(spec: SimSpec | Sequence[SimSpec],
              schemes: Sequence[int | str] | None = None,
              seeds: Sequence[int] = (0,),
              stop_flows: np.ndarray | None = None,
              reference: bool = False,
              return_carry: bool = False,
              shard: bool | None = None,
              until_tick: int | None = None,
              resume: Sequence[Checkpoint] | None = None, *, device=None):
    """A scheme x seed sweep, as the reference's ``run_batch``.

    Either pass one base ``spec`` plus ``schemes`` (registry names or
    integer codes; lane weights/static paths from :func:`lane_arrays`),
    or a sequence of per-scheme specs that share every static field
    except scheme/weights/static_path.  Results come back as a flat list
    of ``SimResult`` of length ``len(schemes) * len(seeds)``, in
    scheme-major, seed-minor order (:func:`batch_lanes`);
    ``return_carry=True`` returns ``(results, states)`` with one
    nested-NumPy carry dict per lane.

    A lane computes what a solo :func:`run` of its spec computes, so each
    lane runs through the solo loop; the lanes of one spec share its
    captured graph.  ``shard=None`` spreads the lanes round-robin over
    the visible cards when there are more than one card and more than one
    lane, ``False`` keeps them on ``device``; results are the same either
    way.  ``until_tick`` bounds the segment for every lane; ``resume``
    takes one :class:`Checkpoint` per lane, in the same order, from a
    previous segmented call with the identical spec/schemes/seeds.
    """
    if isinstance(spec, SimSpec):
        if schemes is None:
            schemes = [spec.scheme]
        codes = [REG.as_code(s) for s in schemes]
        base = spec
        lane_specs = []
        for s in codes:
            if s == base.scheme:
                lane_specs.append((s, np.asarray(base.weights, np.float32),
                                   np.asarray(base.static_path, np.int32)))
            else:
                w, sp = lane_arrays(base, s)
                lane_specs.append((s, w, sp))
    else:
        specs = list(spec)
        if schemes is not None:
            raise ValueError("pass schemes only with a single base spec")
        base = specs[0]
        for s in specs[1:]:
            if (s.n_pkt, s.n_ports, s.n_flows, s.n_ticks) != \
               (base.n_pkt, base.n_ports, base.n_flows, base.n_ticks):
                raise ValueError("lane specs must share static shapes")
        lane_specs = [(s.scheme, np.asarray(s.weights, np.float32),
                       np.asarray(s.static_path, np.int32)) for s in specs]

    lanes = [(dataclasses.replace(base, scheme=s, weights=w,
                                  static_path=p), seed)
             for (s, w, p) in lane_specs for seed in seeds]
    n_lanes = len(lanes)
    if resume is not None and len(resume) != n_lanes:
        raise ValueError(f"resume needs one Checkpoint per lane: got "
                         f"{len(resume)} for {n_lanes} lanes")
    dev = resolve_device(device)
    devices = [dev]
    if dev.type == "cuda":
        ndev = torch.cuda.device_count()
        if shard is None:
            shard = ndev > 1 and n_lanes > 1
        if shard and ndev > 1:
            devices = [torch.device("cuda", i) for i in range(ndev)]
    watch = _watch_mask(base, stop_flows)
    limit = base.n_ticks if until_tick is None else int(until_tick)

    def lane(i: int):
        lspec, seed = lanes[i]
        d = devices[i % len(devices)]
        if resume is not None:
            carry = carry_from_state(base, resume[i].state, d)
            t0, steps0 = int(resume[i].t), int(resume[i].steps)
        else:
            carry, t0, steps0 = init_carry(lspec, seed, d), -1, 0
        return _run_lane(lspec, d, reference, carry, t0, steps0, watch,
                         limit, return_carry)

    if len(devices) > 1:
        # one thread a card, each running its lanes in order: lanes never
        # exchange data
        def shard_lanes(j: int):
            return [(i, lane(i)) for i in range(j, n_lanes, len(devices))]
        with ThreadPoolExecutor(len(devices)) as pool:
            done = dict(kv for part in pool.map(shard_lanes,
                                                range(len(devices)))
                        for kv in part)
        outs = [done[i] for i in range(n_lanes)]
    else:
        outs = [lane(i) for i in range(n_lanes)]
    if return_carry:
        return [r for r, _ in outs], [st for _, st in outs]
    return outs


def batch_lanes(schemes: Sequence[int | str], seeds: Sequence[int]
                ) -> list[tuple[int | str, int]]:
    """The (scheme, seed) order ``run_batch`` returns results in."""
    return [(s, seed) for s in schemes for seed in seeds]
