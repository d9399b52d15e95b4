"""Source-Guided Adaptive Routing path layer (paper §III).

The source controls the first two hops via (EV1, EV2); from the resulting
intermediate location the packet follows the single static minimal forwarding
table.  The achievable path set between a (src switch, dst switch) pair is

    { [n1] + [n2] + static_route(n2 -> dst) : n1 in nbr(src), n2 in nbr(n1) }
      ∪ { static/minimal variants }

filtered to *bounded simple paths*: simple (no repeated switch), and within
the topology's hop-class bounds (Dragonfly: <=3 local and <=2 global hops;
Slim Fly: <=4 hops — all Valiant paths, paper Table I).

Latency model (Table I, reproduced exactly): every switch->switch hop costs
link_latency + 83.2 ns serialization; e.g. DF (3L,2G) = 3*108.2 + 2*583.2
= 1491.0 ns.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.net.topology.base import (GLOBAL, LOCAL, TICK_NS, Topology,
                                     link_latency_ns)

SER_NS = TICK_NS  # 83.2


def hop_latency_ns(link_type: int) -> float:
    return link_latency_ns(link_type) + SER_NS


def path_class(topo: Topology, hops: list[int], src: int) -> tuple[int, int]:
    """(n_local, n_global) hop counts of a path src -> hops[-1]."""
    nl = ng = 0
    u = src
    for v in hops:
        r = topo.slot_of_edge[(u, v)]
        if topo.nbr_type[u, r] == LOCAL:
            nl += 1
        else:
            ng += 1
        u = v
    return nl, ng


def path_latency_ns(topo: Topology, hops: list[int], src: int) -> float:
    nl, ng = path_class(topo, hops, src)
    return nl * hop_latency_ns(LOCAL) + ng * hop_latency_ns(GLOBAL)


def within_bounds(topo: Topology, nl: int, ng: int) -> bool:
    if topo.name.startswith("dragonfly"):
        return nl <= 3 and ng <= 2
    # Slim Fly: all Valiant paths — up to 2 hops to the intermediate switch
    # plus up to 2 minimal hops on (diameter-2 graph): <= 4 hops total.
    return nl + ng <= 4


def enumerate_paths(topo: Topology, src: int, dst: int,
                    with_mult: bool = False):
    """All bounded simple SGAR-reachable paths (hop lists, excluding src).

    Deduplicated: several (EV1, EV2) pairs can induce the same switch path;
    the endpoint table stores unique paths (paper treats each stored EV as a
    unique path).  With ``with_mult`` also returns the number of (EV1, EV2)
    choices inducing each path — i.e. the probability mass an independent
    per-switch uniform choice (the paper's Valiant implementation) puts on it.
    """
    if src == dst:
        return ([[]], [1]) if with_mult else [[]]
    seen: dict[tuple[int, ...], int] = {}
    out: list[list[int]] = []

    same_group_df = (
        topo.name.startswith("dragonfly")
        and topo.sw_group[src] == topo.sw_group[dst]
    )

    def consider(hops: list[int]) -> None:
        if hops[-1] != dst:
            return
        walk = [src] + hops
        if len(set(walk)) != len(walk):  # simple paths only
            return
        nl, ng = path_class(topo, hops, src)
        if not within_bounds(topo, nl, ng):
            return
        if same_group_df and ng > 0:  # §III-B: never misroute out of the group
            return
        key = tuple(hops)
        if key not in seen:
            seen[key] = 0
            out.append(hops)
        seen[key] += 1

    # EV-reachable set: first hop n1, second hop n2, then static minimal.
    nbrs_src = [int(v) for v in topo.nbr[src] if v >= 0]
    consider(topo.static_route(src, dst))  # pure-minimal default route
    for n1 in nbrs_src:
        if n1 == dst:
            consider([n1])
            continue
        consider([n1] + topo.static_route(n1, dst))  # EV2 follows minimal
        for n2 in (int(v) for v in topo.nbr[n1] if v >= 0):
            if n2 == src:
                continue
            if n2 == dst:
                consider([n1, n2])
            else:
                consider([n1, n2] + topo.static_route(n2, dst))
    if with_mult:
        return out, [seen[tuple(h)] for h in out]
    return out


@dataclasses.dataclass
class EVTable:
    """EV entry list for one (src switch, dst switch) pair (paper §III-C).

    Paths are sorted by latency ascending; index in the sorted list is the
    EV id the sender places in the packet header (fine-grained variant).
    """

    src_sw: int
    dst_sw: int
    hops: list[list[int]]          # per EV: switch hop list (excl. src)
    latency_ns: np.ndarray         # [n_paths]
    n_local: np.ndarray            # [n_paths]
    n_global: np.ndarray           # [n_paths]
    mult: np.ndarray               # [n_paths] (EV1,EV2) multiplicity (Valiant mass)

    @property
    def n_paths(self) -> int:
        return len(self.hops)

    def weights(self, w_scale: float = 1.0) -> np.ndarray:
        """Eq. 1 latency weights, optionally scaled (longest stays at 1.0)."""
        w = self.latency_ns.max() / np.maximum(self.latency_ns, 1e-9)
        if self.latency_ns.max() <= 0:  # degenerate same-switch case
            w = np.ones_like(self.latency_ns)
        return (w - 1.0) * w_scale + 1.0



def build_ev_table(topo: Topology, src_sw: int, dst_sw: int,
                   max_paths: int | None = None) -> EVTable:
    paths, mult = enumerate_paths(topo, src_sw, dst_sw, with_mult=True)
    lats, nls, ngs = [], [], []
    for h in paths:
        nl, ng = path_class(topo, h, src_sw) if h else (0, 0)
        lats.append(nl * hop_latency_ns(LOCAL) + ng * hop_latency_ns(GLOBAL))
        nls.append(nl)
        ngs.append(ng)
    order = np.argsort(np.asarray(lats), kind="stable")
    if max_paths is not None and len(order) > max_paths:
        # Keep all minimal paths, subsample the non-minimal tail uniformly
        # (FatPaths-style subset selection, §III-C).
        d = np.asarray(nls) + np.asarray(ngs)
        dmin = d[order].min()
        keep = [i for i in order if d[i] == dmin][:max_paths]
        rest = [i for i in order if d[i] != dmin]
        if len(keep) < max_paths and rest:
            idx = np.linspace(0, len(rest) - 1, max_paths - len(keep)).astype(int)
            keep += [rest[i] for i in idx]
        order = np.asarray(sorted(keep, key=lambda i: lats[i]))
    return EVTable(
        src_sw=src_sw,
        dst_sw=dst_sw,
        hops=[paths[i] for i in order],
        latency_ns=np.asarray([lats[i] for i in order], dtype=np.float64),
        n_local=np.asarray([nls[i] for i in order], dtype=np.int32),
        n_global=np.asarray([ngs[i] for i in order], dtype=np.int32),
        mult=np.asarray([mult[i] for i in order], dtype=np.float64),
    )


def max_path_latency_ns(topo: Topology) -> float:
    """Longest bounded-path latency (drives BDP/queue sizing, Table II)."""
    if topo.name.startswith("dragonfly"):
        nl, ng = 3, 2
    else:
        nl, ng = 0, 4
    return nl * hop_latency_ns(LOCAL) + ng * hop_latency_ns(GLOBAL)


def endpoint_table_bytes(topo: Topology, max_paths_seen: int) -> float:
    """Fig. 3 memory model: (16+8 bits)=3 B per EV entry, one list per dest
    switch, per endpoint."""
    return topo.n_switches * max_paths_seen * 3.0
