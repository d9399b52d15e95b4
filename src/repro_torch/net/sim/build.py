"""SimSpec construction: host-side assembly of per-flow path/port tables.

EV tables are cached per (src switch, dst switch) pair — multiple flows (and
all endpoints behind the same switch pair, the paper's static compression)
share one table.  Port of ``repro.net.sim.build`` (numpy only): the same
spec, field for field, from the same topology, flows and seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.net import paths as P
from repro_torch.net.policies import registry as REG
from repro_torch.net.sim.types import FailurePlan, SimSpec
from repro_torch.net.topology.base import TICK_NS, Topology

H_MAX = 7  # max switch hops (6) + delivery port


@dataclasses.dataclass
class Flow:
    src_ep: int
    dst_ep: int
    size_pkts: int
    start_tick: int = 0
    dep: int = -1       # flow index that must complete before this one starts
    bg: bool = False    # background job: pinned to its static ECMP path
    pin_minimal: bool = False  # bg refinement: static path = minimal route
    #   (motivational scenario: environment flows must congest *their own*
    #   group's gateway link, not spread over the network)


def build_spec(
    topo: Topology,
    flows: list[Flow],
    scheme: int | str,
    *,
    name: str = "",
    w_scale: float = 3.0,
    max_paths: int = 64,
    n_ticks: int = 1 << 20,
    failed_links: list[tuple[int, int]] | None = None,
    failure_plan=None,
    seed: int = 0,
    n_pkt_cap: int = 1 << 16,
    explore_threshold: int | None = None,
    ecn_threshold: int | None = None,
    block_ticks: int | None = None,
    use_kernels: bool | None = None,
) -> SimSpec:
    # scheme may be a registry name or an integer code (deprecation shim);
    # per-scheme weight/static-path rules come from the policy registry
    # (DESIGN.md §11), not from integer if-ladders.
    policy = REG.resolve(scheme)
    scheme = policy.code
    rng = np.random.default_rng(seed)
    F = len(flows)
    bdp = topo.bdp_packets()
    qsize = bdp
    cwnd_max = 1.5 * bdp

    ev_cache: dict[tuple[int, int], P.EVTable] = {}

    def table(ssw: int, dsw: int) -> P.EVTable:
        key = (ssw, dsw)
        if key not in ev_cache:
            ev_cache[key] = P.build_ev_table(topo, ssw, dsw, max_paths=max_paths)
        return ev_cache[key]

    P_MAX = 1
    tabs = []
    for fl in flows:
        tb = table(topo.ep_switch(fl.src_ep), topo.ep_switch(fl.dst_ep))
        tabs.append(tb)
        P_MAX = max(P_MAX, tb.n_paths)

    path_ports = np.full((F, P_MAX, H_MAX), -1, dtype=np.int32)
    path_len = np.ones((F, P_MAX), dtype=np.int32)
    path_lat = np.zeros((F, P_MAX), dtype=np.float32)
    n_paths = np.zeros(F, dtype=np.int32)
    weights = np.zeros((F, P_MAX), dtype=np.float32)
    valiant_w = np.zeros((F, P_MAX), dtype=np.float32)
    static_path = np.zeros(F, dtype=np.int32)
    min_path = np.zeros(F, dtype=np.int32)
    ret_ticks = np.ones((F, P_MAX), dtype=np.int32)
    rem_ticks = np.zeros((F, P_MAX, H_MAX), dtype=np.int32)

    port_lat = topo.port_latency_ticks.astype(np.int32)

    for fi, (fl, tb) in enumerate(zip(flows, tabs)):
        ssw = topo.ep_switch(fl.src_ep)
        n_paths[fi] = tb.n_paths
        if policy.uniform_weights:
            weights[fi, : tb.n_paths] = 1.0
        else:
            weights[fi, : tb.n_paths] = tb.weights(w_scale)
        valiant_w[fi, : tb.n_paths] = tb.mult / tb.mult.sum()
        path_lat[fi, : tb.n_paths] = tb.latency_ns
        # static/default route = the pure-minimal forwarding path; it is the
        # first (lowest-latency) entry unless subsampling reordered ties.
        static_hops = topo.static_route(ssw, topo.ep_switch(fl.dst_ep))
        mp = 0
        for pi, hops in enumerate(tb.hops):
            u = ssw
            ports, lat_sum = [], 0
            for v in hops:
                r = topo.slot_of_edge[(u, v)]
                pid = topo.port_id(u, r)
                ports.append(pid)
                u = v
            ports.append(topo.delivery_port(fl.dst_ep))
            L = len(ports)
            path_len[fi, pi] = L
            path_ports[fi, pi, :L] = ports
            prop = int(sum(port_lat[p] for p in ports))
            ret_ticks[fi, pi] = max(1, prop)  # ACK: prop-only reverse path
            # remaining fwd latency from hop h (incl. serialization per hop)
            tail_cost = 0
            for h in range(L - 1, -1, -1):
                tail_cost += int(port_lat[ports[h]]) + 1
                rem_ticks[fi, pi, h] = tail_cost + ret_ticks[fi, pi]
            if hops == static_hops:
                mp = pi
        min_path[fi] = mp
        # ECMP-style static assignment (5-tuple hash ~ per-hop-uniform draw);
        # foreground MINIMAL flows pin the default minimal route instead.
        if fl.pin_minimal or (policy.pin_minimal and not fl.bg):
            static_path[fi] = mp
        else:
            static_path[fi] = int(
                rng.choice(tb.n_paths, p=valiant_w[fi, : tb.n_paths]
                           / valiant_w[fi, : tb.n_paths].sum()))

    port_failed = np.zeros(topo.n_ports, dtype=bool)
    for (u, v) in failed_links or []:
        port_failed[topo.port_id(u, topo.slot_of_edge[(u, v)])] = True
        port_failed[topo.port_id(v, topo.slot_of_edge[(v, u)])] = True

    # failure timeline (DESIGN.md §10): accept a compiled FailurePlan or any
    # schedule with a ``compile()``; validate ports against this topology.
    if failure_plan is None:
        plan = FailurePlan(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, bool))
    else:
        plan = (failure_plan.compile() if hasattr(failure_plan, "compile")
                else failure_plan)
        if plan.n_events and int(plan.port_id.max()) >= topo.n_ports:
            raise ValueError("failure plan references ports outside topology")

    n_pkt = int(min(
        n_pkt_cap,
        sum(min(fl.size_pkts, int(cwnd_max) + 4) for fl in flows) + 64,
    ))
    max_len = int(path_len.max())
    rto = int(2.5 * (qsize * max_len + ret_ticks.max()))

    return SimSpec(
        name=name or f"{topo.name}_{scheme}",
        scheme=scheme,
        n_ports=topo.n_ports,
        qsize=qsize,
        kmin=0.2 * qsize,
        kmax=0.8 * qsize,
        n_ticks=n_ticks,
        n_pkt=n_pkt,
        rto_ticks=rto,
        cwnd_init=cwnd_max,
        cwnd_max=cwnd_max,
        src_ep=np.asarray([f.src_ep for f in flows], np.int32),
        dst_ep=np.asarray([f.dst_ep for f in flows], np.int32),
        size_pkts=np.asarray([f.size_pkts for f in flows], np.int32),
        start_tick=np.asarray([f.start_tick for f in flows], np.int32),
        dep=np.asarray([f.dep for f in flows], np.int32),
        bg_mask=np.asarray([f.bg for f in flows], bool),
        path_ports=path_ports,
        path_len=path_len,
        path_lat_ns=path_lat,
        n_paths=n_paths,
        weights=weights,
        valiant_w=valiant_w,
        static_path=static_path,
        min_path=min_path,
        ret_ticks=ret_ticks,
        rem_ticks=rem_ticks,
        port_lat=port_lat,
        port_failed=port_failed,
        fail_event_tick=plan.event_tick,
        fail_event_port=plan.port_id,
        fail_event_up=plan.port_up,
        fail_event_ivl=plan.event_ivl,
        explore_threshold=(explore_threshold if explore_threshold is not None
                           else max(4, bdp // 2)),
        ecn_threshold=(ecn_threshold if ecn_threshold is not None
                       else max(2, bdp // 10)),
        use_kernels=use_kernels,
        **({} if block_ticks is None else dict(block_ticks=block_ticks)),
    )


def respec_scheme(spec: SimSpec, scheme: int | str) -> SimSpec:
    """Clone a built spec for a different scheme WITHOUT rebuilding the
    (host-expensive) EV path tables.

    Mirrors ``build_spec``'s per-scheme rules via the registry's host
    lane rules (DESIGN.md §5/§11): ``uniform_weights`` schemes get
    uniform weights over live paths, ``pin_minimal`` schemes pin
    foreground flows to the minimal route, everything else inherits the
    base spec's weights/static draw.  The base spec must be built with a
    weighted scheme (e.g. SPRAY_W).  ``scheme`` may be a registry name
    or an integer code.
    """
    scheme = REG.as_code(scheme)
    if scheme == spec.scheme:
        return spec
    w, sp = REG.lane_arrays(spec, scheme)
    return dataclasses.replace(spec, scheme=scheme, weights=w,
                               static_path=sp, name=f"{spec.name}:s{scheme}")


def mib_to_pkts(mib: float) -> int:
    return int(np.ceil(mib * (1 << 20) / 4096))


def ticks_to_us(ticks) -> np.ndarray:
    return np.asarray(ticks, np.float64) * TICK_NS / 1000.0
