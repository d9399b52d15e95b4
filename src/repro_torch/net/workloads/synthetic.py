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

