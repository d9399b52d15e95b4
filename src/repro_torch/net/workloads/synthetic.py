"""Synthetic traffic patterns from the paper's evaluation (§V-B a).

All generators return ``list[Flow]``; flow sizes are in packets (4 KiB each).
Port of ``repro.net.workloads.synthetic``: the same rng call order, so the
same seed gives the same flows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.sim.build import Flow
from repro_torch.net.topology.base import Topology


def _ep_group(topo: Topology, ep: int) -> int:
    return int(topo.sw_group[topo.ep_switch(ep)])


def _perm_ok(topo: Topology, eps: list[int], perm, off_group: bool) -> bool:
    """Derangement + (unless single-group) off-group receiver rule."""
    single = len(set(_ep_group(topo, e) for e in eps)) == 1
    return all(
        s != d and (not off_group or single
                    or _ep_group(topo, s) != _ep_group(topo, d))
        for s, d in zip(eps, perm))


def _offgroup_shift(topo: Topology, eps: list[int],
                    off_group: bool) -> list[int]:
    """Deterministic fallback when rejection sampling fails: the first
    cyclic shift of ``eps`` satisfying the constraints.  Raises if no
    shift works (e.g. an endpoint set where one group holds more than
    half the endpoints — no off-group derangement can exist there
    either, so silently returning an invalid pairing would corrupt the
    scenario)."""
    L = len(eps)
    for shift in range(1, L):
        perm = [eps[(i + shift) % L] for i in range(L)]
        if _perm_ok(topo, eps, perm, off_group):
            return perm
    raise ValueError(
        f"no off-group derangement exists for this endpoint set "
        f"({L} endpoints over "
        f"{len(set(_ep_group(topo, e) for e in eps))} groups)")


def permutation(topo: Topology, size_pkts: int, seed: int = 0,
                off_group: bool = True, endpoints: list[int] | None = None,
                bg: bool = False) -> list[Flow]:
    """Random one-to-one permutation; receivers forced outside the sender's
    group (paper: 'prioritize the receiver to be outside the local group').

    Each round shuffles and then *repairs* invalid positions by
    randomized swaps — a bare rejection sample of a full off-group
    derangement succeeds with probability ~e^-p per round (p endpoints
    per group), so the pre-fix code nearly always fell through its 200
    rounds and silently used the last *invalid* draw (self-sends,
    in-group receivers).  If sampling still fails, fall back to a
    deterministic cyclic shift; raise when even that cannot satisfy the
    constraint (no valid assignment exists)."""
    rng = np.random.default_rng(seed)
    eps = list(endpoints) if endpoints is not None else list(range(topo.n_endpoints))
    single = len(set(_ep_group(topo, e) for e in eps)) == 1

    def pair_ok(s: int, d: int) -> bool:
        return s != d and (not off_group or single
                           or _ep_group(topo, s) != _ep_group(topo, d))

    n = len(eps)
    perm = None
    for _ in range(200):
        cand = [int(x) for x in rng.permutation(eps)]
        for _sweep in range(4):   # randomized swap repair
            bad = [i for i in range(n) if not pair_ok(eps[i], cand[i])]
            if not bad:
                break
            for i in bad:
                for j in rng.integers(0, n, size=16):
                    j = int(j)
                    if pair_ok(eps[i], cand[j]) and pair_ok(eps[j], cand[i]):
                        cand[i], cand[j] = cand[j], cand[i]
                        break
        if _perm_ok(topo, eps, cand, off_group):
            perm = cand
            break
    if perm is None:
        perm = _offgroup_shift(topo, eps, off_group)
    assert all(int(s) != int(d) for s, d in zip(eps, perm))
    return [Flow(int(s), int(d), size_pkts, bg=bg) for s, d in zip(eps, perm)]


def adversarial(topo: Topology, size_pkts: int, seed: int = 0) -> list[Flow]:
    """Topology-specific worst case for minimal routing.

    Dragonfly: classic ADV+1 — every endpoint in group g sends to the peer
    endpoint in group g+1; all minimal traffic between two groups shares the
    single g->g+1 global link.  Slim Fly: every endpoint in (switch-)group g
    sends to the endpoint with the same offset in group g+1 — minimal paths
    concentrate on the few inter-group links between the two columns.
    """
    rng = np.random.default_rng(seed)
    g = topo.n_groups
    sw_per_g = topo.n_switches // g
    p = topo.eps_per_switch
    flows = []
    for gi in range(g):
        gj = (gi + 1) % g
        for si in range(sw_per_g):
            for pi in range(p):
                src = (gi * sw_per_g + si) * p + pi
                # same switch offset, shifted endpoint to avoid self-symmetry
                dst = (gj * sw_per_g + si) * p + (pi + 1) % p
                flows.append(Flow(src, dst, size_pkts))
    rng.shuffle(flows)
    return flows


def motivational(topo: Topology, monitored_pkts: int, bg_pkts: int,
                 n_free_groups: int = 2, seed: int = 0,
                 bg_flows_per_ep: int = 5,
                 solo: bool = False, warmup_ticks: int = 512
                 ) -> tuple[list[Flow], int]:
    """Fig. 5 scenario: one monitored flow; nearly all groups *heavily*
    congested by many background flows crossing each group's global link
    toward the destination group; a few groups stay free.

    The background is the scenario's environment, not a scheme under test:
    it is pinned to static ECMP paths (``Flow.bg``), mirroring §V-B's
    background-permutation methodology.  ``bg_flows_per_ep`` flows per
    source endpoint keep each congested gateway queue pegged even at
    DCTCP's per-flow cwnd floor — the paper's "significant queue buildup"
    regime, in which congested-path ACKs are ECN-marked ~always and only
    free-group paths return clean feedback.

    Returns (flows, monitored_flow_index).
    """
    rng = np.random.default_rng(seed)
    g = topo.n_groups
    sw_per_g = topo.n_switches // g
    p = topo.eps_per_switch

    dst_group = g - 1
    src_group = 0
    src_ep = src_group * sw_per_g * p
    dst_ep = dst_group * sw_per_g * p + 1
    flows = [Flow(src_ep, dst_ep, monitored_pkts,
                  start_tick=0 if solo else warmup_ticks)]
    if solo:
        return flows, 0

    free = set(int(x) for x in rng.choice(
        [x for x in range(g) if x not in (dst_group, src_group)],
        size=n_free_groups, replace=False))

    def gateway_entry(gc: int):
        """(gateway, entry): gateway = switch in gc owning a global link into
        dst_group; entry = the dst_group-side switch of that link."""
        for si in range(sw_per_g):
            s = gc * sw_per_g + si
            for r in range(topo.radix):
                t = int(topo.nbr[s, r])
                if (t >= 0 and topo.sw_group[t] == dst_group
                        and topo.nbr_type[s, r]):  # global link
                    return s, t
        return None

    # Background flows cross the single gc -> dst_group global link and
    # deliver to endpoints behind its entry switch: the global link (not the
    # receivers) is the bottleneck, so its queue stays built up — exactly the
    # transit congestion the monitored flow runs into (Fig. 5 ②).
    for gc in range(g):
        if gc in free or gc == dst_group:
            continue
        ge = gateway_entry(gc)
        if ge is None:
            continue
        gw, entry = ge
        cands = [e for e in range(gc * sw_per_g * p, (gc + 1) * sw_per_g * p)
                 if e != src_ep]
        rng.shuffle(cands)
        for rep in range(bg_flows_per_ep):
            for i, s in enumerate(cands):
                dst_bg = entry * p + (i + rep) % p
                if dst_bg == dst_ep:
                    dst_bg = entry * p + (i + rep + 1) % p
                flows.append(Flow(int(s), int(dst_bg), bg_pkts, bg=True,
                                  pin_minimal=True))
    return flows, 0


def incast_bystanders(topo: Topology, n_senders: int, size_pkts: int,
                      seed: int = 0) -> tuple[list[Flow], np.ndarray]:
    """Fig. 8: synchronized incast hotspot + disjoint one-to-one permutation
    bystanders, all starting at t=0.  Returns (flows, bystander_mask).

    The hotspot receiver is excluded from the sender set (the pre-fix
    ``range(n_senders)`` could include it once ``n_senders`` passed the
    receiver's endpoint id, producing a self-flow whose 'sender' was
    also the hotspot) and from the bystander pairing."""
    rng = np.random.default_rng(seed)
    n = topo.n_endpoints
    if not 0 < n_senders <= n - 1:
        raise ValueError(f"n_senders must be in [1, {n - 1}], got {n_senders}")
    receiver = min(160, n - 1)
    senders = [e for e in range(n) if e != receiver][:n_senders]
    flows = [Flow(s, receiver, size_pkts) for s in senders]
    sender_set = set(senders)
    rest = [e for e in range(n) if e not in sender_set and e != receiver]
    perm = rng.permutation(rest)
    for s, d in zip(rest, perm):
        if s != d:
            flows.append(Flow(int(s), int(d), size_pkts))
    assert all(fl.src_ep != fl.dst_ep for fl in flows)
    assert receiver not in sender_set
    mask = np.zeros(len(flows), bool)
    mask[n_senders:] = True
    return flows, mask
