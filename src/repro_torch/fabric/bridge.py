"""Trainer-to-fabric bridge: lower an (arch x mesh) cell's collective
traffic onto Dragonfly / Slim Fly and compare load-balancing schemes at
full paper scale (1056 / 1134 endpoints).  Port of ``repro.fabric.bridge``:
both simulation levels run on ``device``, the card by default.

This is the integration point between the two halves of the framework:
the dry-run's compiled HLO gives per-step collective bytes per chip
(the reference's ``repro.launch.hlo_analysis``); this module embeds the
production mesh onto a low-diameter fabric, expands the dominant
collectives into flow sets (ring all-reduce / butterfly / MoE
all-to-all), and runs the flow-level simulator
(repro_torch.fabric.flowsim) per scheme.  Output: estimated collective
completion time under any registry scheme name — i.e. *the paper's
technique applied to the framework's own traffic*, refining the analytic
``collective_bytes / link_bw`` roofline term with topology contention.

Schemes are sender-policy registry names (DESIGN.md §11/§12): the
flow-level sweep routes through ``flowsim.simulate_batch`` (one shared
path table, one lane per scheme) and the packet-level refinement lowers
the same flow set onto ``engine.run_batch``.  Byte <-> packet <-> tick
conversions all use the wire constants in
``repro_torch.net.topology.base``
(``BYTES_PER_TICK`` / ``bytes_to_pkts``): collective payload bytes are
expanded to *wire* bytes once, so flow-level times, packet counts and
start ticks stay mutually consistent.

Embedding: mesh device (i, j) -> endpoint id round-robin over switches
(the 'model' axis lands intra-group where possible — TP traffic stays on
short local links, DP all-reduce rings cross groups, matching how a real
job would be placed on a Dragonfly).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fabric import flowsim as FS
from repro_torch.net.topology.base import (BYTES_PER_TICK, BYTES_PER_US,
                                           TICK_NS, Topology, wire_bytes)

DEFAULT_SCHEMES = ("ecmp", "ugal_l", "spritz_spray_w")


@dataclasses.dataclass
class CollectiveSpec:
    kind: str          # "allreduce_ring" | "allreduce_butterfly" | "alltoall"
    participants: list[int]     # endpoint ids
    bytes_per_rank: float       # payload bytes


def embed_mesh(topo: Topology, n_devices: int, tp: int) -> np.ndarray:
    """device id -> endpoint id; consecutive tp-blocks stay within a group
    (short local links for TP), groups round-robin for DP."""
    n_eps = topo.n_endpoints
    assert n_devices <= n_eps, (n_devices, n_eps)
    g = topo.n_groups
    per_group = n_eps // g
    out = np.zeros(n_devices, np.int64)
    blocks = n_devices // tp
    b_per_group = max(per_group // tp, 1)
    for b in range(blocks):
        grp = (b // b_per_group) % g
        slot = b % b_per_group
        base = grp * per_group + slot * tp
        for j in range(tp):
            out[b * tp + j] = base + j
    return out


def ring_flows(eps: list[int], bytes_per_rank: float) -> list[FS.FlowSpec]:
    """Bidirectional-ring all-reduce: 2(N-1)/N x data volume, modeled as
    each rank streaming its reduce-scatter+all-gather bytes to its ring
    successor (steady-state pipeline => one long flow per edge)."""
    n = len(eps)
    vol = float(wire_bytes(2.0 * (n - 1) / n * bytes_per_rank))
    return [FS.FlowSpec(eps[i], eps[(i + 1) % n], vol) for i in range(n)]


def butterfly_flows(eps: list[int], bytes_per_rank: float) -> list[FS.FlowSpec]:
    """Recursive-halving/doubling: log2(N) rounds, round k exchanges
    bytes/2^k with the partner at distance 2^k.  Flow-level model: all
    rounds' volumes as parallel flows (optimistic overlap; the packet sim
    covers the staged version via `dep`)."""
    n = len(eps)
    flows = []
    k = 0
    while (1 << k) < n:
        d = 1 << k
        vol = bytes_per_rank / (1 << k) if k else bytes_per_rank
        vol = float(wire_bytes(vol))
        for i in range(n):
            j = i ^ d
            if j < n:
                flows.append(FS.FlowSpec(eps[i], eps[j], vol))
        k += 1
    return flows


def alltoall_flows(eps: list[int], bytes_per_rank: float) -> list[FS.FlowSpec]:
    n = len(eps)
    per_pair = float(wire_bytes(bytes_per_rank / max(n - 1, 1)))
    out = []
    for i in range(n):
        for j in range(n):
            if i != j:
                out.append(FS.FlowSpec(eps[i], eps[j], per_pair))
    return out


_EXPAND = {"allreduce_ring": ring_flows,
           "allreduce_butterfly": butterfly_flows,
           "alltoall": alltoall_flows}

def collective_time_us(topo: Topology, spec: CollectiveSpec, scheme,
                       seed: int = 0, device=None) -> dict:
    """Simulate one collective; returns {fct_us, reselections}."""
    flows = _EXPAND[spec.kind]([int(e) for e in spec.participants],
                               spec.bytes_per_rank)
    res = FS.simulate(topo, flows, scheme, seed=seed, device=device)
    done = res.fct[res.fct >= 0]       # fct is relative to start; 0 is done
    # empty == the explicit -1.0 sentinel, never NaN: a sentinel FAILS
    # downstream guards, a NaN would silently pass them (steady.EMPTY)
    t_bytes = float(done.max()) if len(done) else -BYTES_PER_US
    return {"fct_us": t_bytes / BYTES_PER_US,
            "reselections": res.reselections,
            "epochs": res.epochs}


def cell_collectives(topo: Topology, kind: str, shard_bytes: float,
                     n_chips: int = 256, tp: int = 16,
                     embedding: np.ndarray | None = None
                     ) -> list[CollectiveSpec]:
    """Derive the dominant collective flow set for a cell.

    ``shard_bytes``: the per-chip gradient/activation shard size (for train,
    the DP all-reduce payload per model-rank; ring volume 2(N-1)/N x is
    applied by the expander).  One ring per model rank j over its dp peers —
    all tp rings run concurrently, which is exactly the cross-group traffic
    a Dragonfly placement produces."""
    emb = embedding if embedding is not None else embed_mesh(topo, n_chips, tp)
    dp = n_chips // tp
    specs = []
    if kind == "train":
        for j in range(tp):
            eps = [int(emb[b * tp + j]) for b in range(dp)]
            specs.append(CollectiveSpec("allreduce_ring", eps, shard_bytes))
    else:
        for j in range(tp):
            eps = [int(emb[b * tp + j]) for b in range(dp)]
            specs.append(CollectiveSpec("alltoall", eps, shard_bytes))
    return specs


def cell_flows(topo: Topology, kind: str, shard_bytes: float,
               n_chips: int = 256, tp: int = 16) -> list[FS.FlowSpec]:
    """Embed + expand one cell's concurrent collectives into a flow set."""
    emb = embed_mesh(topo, n_chips, tp)
    specs = cell_collectives(topo, kind, shard_bytes, n_chips, tp, emb)
    flows: list[FS.FlowSpec] = []
    for sp in specs:
        flows.extend(_EXPAND[sp.kind](sp.participants, sp.bytes_per_rank))
    return flows


def fabric_report(topo: Topology, kind: str, shard_bytes: float,
                  schemes=DEFAULT_SCHEMES,
                  n_chips: int = 256, tp: int = 16, seed: int = 0,
                  packet_level: bool = False,
                  n_ticks: int = 1 << 18,
                  failure_plan=None, max_paths: int = 64,
                  device=None) -> dict:
    """Full bridge: embed, expand, simulate each scheme on ``device``;
    returns {scheme_name: {fct_us, ...}} for the concurrent collective
    union.

    Flow-level (default) routes through ``flowsim.simulate_batch`` —
    one shared path table, one lane per registry scheme name, optional
    ``failure_plan`` (a ``FailureSchedule``/``FailurePlan`` in ticks).

    ``packet_level=True`` lowers the collective flow set onto the exact
    packet simulator instead and runs the whole scheme sweep as ONE
    batched device program via ``engine.run_batch`` (compiles once; see
    DESIGN.md §5) — use it at reduced topology scales.
    """
    flows = cell_flows(topo, kind, shard_bytes, n_chips, tp)
    if packet_level:
        return _packet_report(topo, flows, schemes, seed, n_ticks,
                              failure_plan, max_paths, device)
    out = {}
    sweep = FS.simulate_batch(topo, flows, schemes, seeds=[seed],
                              failure_plan=failure_plan,
                              max_paths=max_paths, device=device)
    for name, (res,) in sweep.items():
        done = res.fct[res.fct >= 0]
        # -1.0 sentinel, never NaN (see collective_time_us)
        t_bytes = float(done.max()) if len(done) else -BYTES_PER_US
        out[name] = {
            "fct_us": t_bytes / BYTES_PER_US,
            "done_frac": float((res.fct >= 0).mean()),
            "reselections": res.reselections,
            "forced": res.forced,
            "epochs": res.epochs,
            "rate_violations": res.rate_violations}
    return out


def to_packet_flows(flows: list[FS.FlowSpec]) -> list:
    """Flow-level specs -> packet-engine flows, wire-consistently: sizes
    and start offsets both convert through ``BYTES_PER_TICK`` (one tick
    serializes one wire packet), so ``size_pkts * BYTES_PER_TICK``
    round-trips the wire volume exactly for expander-produced flows."""
    from repro_torch.net.sim import build as B
    return [B.Flow(f.src_ep, f.dst_ep,
                   max(1, int(np.ceil(f.size_bytes / BYTES_PER_TICK))),
                   start_tick=int(round(f.start / BYTES_PER_TICK)))
            for f in flows]


def _packet_report(topo: Topology, flows: list[FS.FlowSpec], schemes,
                   seed: int, n_ticks: int, failure_plan=None,
                   max_paths: int = 64, device=None) -> dict:
    """Exact packet-level scheme sweep over one collective flow set,
    batched through ``engine.run_batch``.  ``failure_plan``/``max_paths``
    forward to ``build_spec`` so both simulation levels see the same
    scenario."""
    from repro_torch.net.policies import registry as REG
    from repro_torch.net.sim import build as B
    from repro_torch.net.sim import engine as E
    from repro_torch.net.sim.types import SPRAY_W
    base = B.build_spec(topo, to_packet_flows(flows), SPRAY_W,
                        n_ticks=n_ticks, seed=seed,
                        failure_plan=failure_plan, max_paths=max_paths)
    results = E.run_batch(base, schemes=list(schemes), seeds=[seed],
                          device=device)
    out = {}
    for scheme, res in zip(schemes, results):
        done = res.fct_ticks[res.done]
        # -1.0 sentinel, never NaN (see collective_time_us)
        fct_us = (float(done.max()) * TICK_NS / 1e3) if len(done) else -1.0
        out[REG.resolve(scheme).name] = {
            "fct_us": fct_us,
            "done_frac": float(res.done.mean()),
            "trims": int(res.trims.sum()),
            "steps": res.steps_executed,
            "compression": round(res.compression, 2)}
    return out
