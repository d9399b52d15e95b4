"""Common topology representation used by paths, routing and the simulator.

A topology is a directed multigraph over switches.  Each switch has `radix`
neighbor slots (padded with -1).  Every directed switch->switch link owns an
output-port queue; switch->endpoint delivery links own ports too (incast
bottleneck lives there).  All arrays are NumPy (host-side setup); the engine
converts what it needs to torch tensors.  Port of ``repro.net.topology.base``.

Link classes follow the paper's latency model (Table I / Table II):
  local link : 25 ns      global link : 500 ns      switch     : 500 ns
  serialization of a 64B+4096B packet @ 400 Gb/s = 83.2 ns  (= 1 sim tick)
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

LOCAL, GLOBAL = 0, 1

# --- paper constants (Table II) ---
PKT_HEADER_B = 64
PKT_PAYLOAD_B = 4096
PKT_BYTES = PKT_HEADER_B + PKT_PAYLOAD_B
LINK_GBPS = 400.0
TICK_NS = PKT_BYTES * 8 / LINK_GBPS  # 83.2 ns
LOCAL_NS = 25.0
GLOBAL_NS = 500.0
SWITCH_NS = 500.0
ECN_KMIN_FRAC = 0.2
ECN_KMAX_FRAC = 0.8


# One tick serializes exactly one wire packet: PKT_BYTES (header+payload)
# bytes cross a 400 Gb/s link per 83.2 ns.  Every byte <-> packet <-> tick
# conversion in the repo (flow-level byte-times, the fabric bridge's packet
# lowering, trace arrival sizing) must route through these helpers: mixing
# the payload constant (4096) with the wire constant (4160) skews starts
# against sizes by ~1.6%.
BYTES_PER_TICK = PKT_BYTES
BYTES_PER_US = LINK_GBPS / 8 * 1e3    # wire bytes per us at link rate


def bytes_to_pkts(payload_bytes):
    """Payload bytes -> packet count (PKT_PAYLOAD_B payload each, min 1)."""
    return np.maximum(1, np.ceil(np.asarray(payload_bytes, np.float64)
                                 / PKT_PAYLOAD_B)).astype(np.int64)


def wire_bytes(payload_bytes):
    """Payload bytes -> bytes on the wire (every packet adds PKT_HEADER_B)."""
    return bytes_to_pkts(payload_bytes) * PKT_BYTES


def link_latency_ns(link_type: int) -> float:
    return LOCAL_NS if link_type == LOCAL else GLOBAL_NS


@dataclasses.dataclass
class Topology:
    """Fixed-shape switch graph + endpoint attachment."""

    name: str
    n_switches: int
    eps_per_switch: int                  # p — endpoints per switch
    nbr: np.ndarray                      # [n_sw, radix] neighbor switch id or -1
    nbr_type: np.ndarray                 # [n_sw, radix] LOCAL/GLOBAL (undef where -1)
    sw_group: np.ndarray                 # [n_sw] group id
    params: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ sizes
    @property
    def radix(self) -> int:
        return self.nbr.shape[1]

    @property
    def n_endpoints(self) -> int:
        return self.n_switches * self.eps_per_switch

    @property
    def n_groups(self) -> int:
        return int(self.sw_group.max()) + 1

    def ep_switch(self, ep: int):
        return ep // self.eps_per_switch

    # ------------------------------------------------------------- port table
    # Ports: one per directed switch->switch link, plus one delivery port per
    # endpoint (dest switch -> endpoint NIC).  Injection (endpoint -> switch)
    # is window/tick-limited at the sender and needs no queue.
    @cached_property
    def n_sw_ports(self) -> int:
        return self.n_switches * self.radix

    @property
    def n_ports(self) -> int:
        return self.n_sw_ports + self.n_endpoints

    def port_id(self, sw: int, slot: int) -> int:
        return sw * self.radix + slot

    def delivery_port(self, ep: int) -> int:
        return self.n_sw_ports + ep

    @cached_property
    def port_latency_ticks(self) -> np.ndarray:
        """Propagation+switch latency in ticks for each port's link (ceil)."""
        lat = np.zeros(self.n_ports, dtype=np.int32)
        for s in range(self.n_switches):
            for r in range(self.radix):
                if self.nbr[s, r] < 0:
                    lat[self.port_id(s, r)] = 1
                else:
                    ns = link_latency_ns(int(self.nbr_type[s, r])) + SWITCH_NS
                    lat[self.port_id(s, r)] = max(1, int(np.ceil(ns / TICK_NS)))
        # delivery links: local-class host link
        host = max(1, int(np.ceil((LOCAL_NS + SWITCH_NS) / TICK_NS)))
        lat[self.n_sw_ports:] = host
        return lat

    @cached_property
    def slot_of_edge(self) -> dict:
        """(u, v) -> neighbor slot index r with nbr[u, r] == v."""
        out = {}
        for s in range(self.n_switches):
            for r in range(self.radix):
                t = int(self.nbr[s, r])
                if t >= 0:
                    out[(s, t)] = r
        return out

    # ---------------------------------------------------------------- routing
    @cached_property
    def dist(self) -> np.ndarray:
        """All-pairs switch hop distance (BFS; graphs are small)."""
        n = self.n_switches
        d = np.full((n, n), 127, dtype=np.int8)
        adj = [self.nbr[s][self.nbr[s] >= 0] for s in range(n)]
        for s in range(n):
            d[s, s] = 0
            frontier = [s]
            depth = 0
            seen = {s}
            while frontier:
                depth += 1
                nxt = []
                for u in frontier:
                    for v in adj[u]:
                        v = int(v)
                        if v not in seen:
                            seen.add(v)
                            d[s, v] = depth
                            nxt.append(v)
                frontier = nxt
        return d

    @cached_property
    def static_next(self) -> np.ndarray:
        """Deterministic default-forwarding next-slot: [n_sw, n_sw] -> slot.

        Lowest-slot tie-break — models the single static minimal forwarding
        table every switch carries (paper §III-A).
        """
        n = self.n_switches
        nxt = np.full((n, n), -1, dtype=np.int16)
        d = self.dist
        for s in range(n):
            for t in range(n):
                if s == t:
                    continue
                for r in range(self.radix):
                    v = int(self.nbr[s, r])
                    if v >= 0 and d[v, t] == d[s, t] - 1:
                        nxt[s, t] = r
                        break
        return nxt

    def static_route(self, s: int, t: int) -> list:
        """Hop list (switch ids after s, ending at t) via default forwarding."""
        hops = []
        u = s
        while u != t:
            r = int(self.static_next[u, t])
            u = int(self.nbr[u, r])
            hops.append(u)
        return hops

    # ----------------------------------------------------------------- checks
    def validate(self) -> None:
        # symmetric adjacency
        for s in range(self.n_switches):
            for r in range(self.radix):
                t = int(self.nbr[s, r])
                if t >= 0:
                    assert (t, s) in self.slot_of_edge or (s, t) in self.slot_of_edge
                    assert any(self.nbr[t] == s), f"asymmetric link {s}->{t}"

    def bdp_packets(self) -> int:
        """Bandwidth-delay product of the longest bounded path, in packets.

        Includes per-hop switch latency and the two host links.  For the
        paper-scale instances the factory pins Table II's values (DF 88,
        SF 92) via ``params['bdp_override']``.
        """
        if "bdp_override" in self.params:
            return int(self.params["bdp_override"])
        from repro_torch.net import paths as _p  # lazy; avoids cycle

        lat = _p.max_path_latency_ns(self)
        max_hops = 5 if self.name.startswith("dragonfly") else 4
        one_way = lat + max_hops * SWITCH_NS + 2 * (LOCAL_NS + TICK_NS)
        return max(4, int(np.ceil(2 * one_way / TICK_NS)))
