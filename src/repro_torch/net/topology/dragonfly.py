"""Canonical Dragonfly topology (Kim et al., ISCA'08) with all-to-all
intra-group connectivity and one global link per group pair (consecutive
allocation).

Parameters (paper Table II): a=8 switches/group, h=4 global links/switch,
p=4 endpoints/switch -> g = a*h + 1 = 33 groups, 264 switches, 1056 endpoints.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.topology.base import GLOBAL, LOCAL, Topology


def make_dragonfly(a: int = 8, h: int = 4, p: int = 4) -> Topology:
    g = a * h + 1                       # number of groups
    n_sw = g * a
    radix = (a - 1) + h                 # local + global slots
    nbr = np.full((n_sw, radix), -1, dtype=np.int32)
    typ = np.zeros((n_sw, radix), dtype=np.int8)
    grp = np.repeat(np.arange(g, dtype=np.int32), a)

    def sw(gi: int, si: int) -> int:
        return gi * a + si

    for gi in range(g):
        for si in range(a):
            s = sw(gi, si)
            # local all-to-all: slots [0, a-2]
            slot = 0
            for sj in range(a):
                if sj == si:
                    continue
                nbr[s, slot] = sw(gi, sj)
                typ[s, slot] = LOCAL
                slot += 1
            # global links: slots [a-1, a-1+h)
            # consecutive allocation: group gi's global port e in [0, a*h)
            # connects to group (gi + e + 1) mod g; the peer group gj sees the
            # link on its port e' = (g - 1) - (e + 1) ... derived from offset.
            for t in range(h):
                e = si * h + t          # this group's global port index
                gj = (gi + e + 1) % g
                d_back = (gi - gj) % g  # offset of gi as seen from gj
                e_back = d_back - 1
                sj = e_back // h
                nbr[s, a - 1 + t] = sw(gj, sj)
                typ[s, a - 1 + t] = GLOBAL

    topo = Topology(
        name=f"dragonfly_a{a}_h{h}_p{p}",
        n_switches=n_sw,
        eps_per_switch=p,
        nbr=nbr,
        nbr_type=typ,
        sw_group=grp,
        params=dict(a=a, h=h, p=p, g=g),
    )
    if (a, h, p) == (8, 4, 4):
        topo.params["bdp_override"] = 88  # paper Table II
    topo.validate()
    return topo
