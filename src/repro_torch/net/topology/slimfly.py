"""Slim Fly MMS topology (Besta & Hoefler, SC'14), diameter 2.

Construction for prime power q = 4w + 1 (delta = 1), the case covering the
paper's q=9 (162 switches, k'=13, p=7, 1134 endpoints) and our reduced q=5.

Switches live in two blocks of q^2:
  A = (0, x, y),  B = (1, m, c),  x, y, m, c in GF(q)
Edges:
  (0,x,y) ~ (0,x,y')  iff  y - y' in X   (even powers of primitive elem, |X|=(q-1)/2)
  (1,m,c) ~ (1,m,c')  iff  c - c' in X'  (odd powers)
  (0,x,y) ~ (1,m,c)   iff  y = m*x + c   (q cross links per switch)

"Groups" (for the local/global latency classes of the paper) are the 2q
columns of q switches sharing (block, x|m): intra-column Cayley links are
local (short cables), cross-block links are global (long cables).

Port of ``repro.net.topology.slimfly``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.topology.base import GLOBAL, LOCAL, Topology
from repro_torch.net.topology.gf import GF


def make_slimfly(q: int = 9, p: int | None = None) -> Topology:
    if q % 4 != 1:
        raise NotImplementedError("MMS construction implemented for q = 4w+1")
    gf = GF(q)
    xi = gf.primitive
    half = (q - 1) // 2
    X = sorted({gf.pow(xi, 2 * i) for i in range(half)})        # even powers
    Xp = sorted({gf.pow(xi, 2 * i + 1) for i in range(half)})   # odd powers
    assert len(X) == half and len(Xp) == half

    n_sw = 2 * q * q
    net_radix = half + q                # k' = (3q-1)/2
    if p is None:
        p = int(np.ceil(net_radix / 2))  # endpoints per switch (SF paper rule)

    def sid(block: int, u: int, v: int) -> int:
        return block * q * q + u * q + v

    nbr = np.full((n_sw, net_radix), -1, dtype=np.int32)
    typ = np.zeros((n_sw, net_radix), dtype=np.int8)
    grp = np.zeros(n_sw, dtype=np.int32)

    for block in (0, 1):
        gen = X if block == 0 else Xp
        for u in range(q):              # x (block 0) or m (block 1)
            for v in range(q):          # y (block 0) or c (block 1)
                s = sid(block, u, v)
                grp[s] = block * q + u  # 2q groups of q switches
                slot = 0
                # local Cayley links within the column
                for d in gen:
                    v2 = gf.add(v, d)
                    nbr[s, slot] = sid(block, u, v2)
                    typ[s, slot] = LOCAL
                    slot += 1
                # global cross-block links
                if block == 0:
                    x, y = u, v
                    for m in range(q):
                        # y = m*x + c  =>  c = y - m*x
                        c = gf.sub(y, gf.mul(m, x))
                        nbr[s, slot] = sid(1, m, c)
                        typ[s, slot] = GLOBAL
                        slot += 1
                else:
                    m, c = u, v
                    for x in range(q):
                        y = gf.add(gf.mul(m, x), c)
                        nbr[s, slot] = sid(0, x, y)
                        typ[s, slot] = GLOBAL
                        slot += 1

    topo = Topology(
        name=f"slimfly_q{q}_p{p}",
        n_switches=n_sw,
        eps_per_switch=p,
        nbr=nbr,
        nbr_type=typ,
        sw_group=grp,
        params=dict(q=q, p=p, net_radix=net_radix),
    )
    if q == 9:
        topo.params["bdp_override"] = 92  # paper Table II
    topo.validate()
    assert topo.diameter == 2, f"Slim Fly must have diameter 2, got {topo.diameter}"
    return topo
