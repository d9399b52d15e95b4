"""Web-search datacenter trace (paper §V-B c).

Flow sizes follow the standard DCTCP web-search distribution (Alizadeh et
al., SIGCOMM'10 Fig. 5 — the same trace used by the paper via [11], [28]);
the CDF below is the widely used piecewise-linear form of that measurement.
Arrivals are Poisson at a configurable load; receivers are picked uniformly
with a cap on simultaneous senders per receiver (paper: 'randomly select
receivers while limiting the number of simultaneous senders per receiver').

Port of ``repro.net.workloads.trace``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.sim.build import Flow
from repro_torch.net.topology.base import (BYTES_PER_TICK, bytes_to_pkts,
                                           wire_bytes)

# (bytes, cdf) — DCTCP web-search flow-size distribution
_WEBSEARCH_CDF = [
    (6_000, 0.00), (10_000, 0.15), (13_000, 0.20), (19_000, 0.30),
    (33_000, 0.40), (53_000, 0.53), (133_000, 0.60), (667_000, 0.70),
    (1_333_000, 0.80), (3_333_000, 0.90), (6_667_000, 0.97),
    (20_000_000, 1.00),
]


def sample_websearch_bytes(rng: np.random.Generator, n: int) -> np.ndarray:
    u = rng.uniform(size=n)
    xs = np.array([b for b, _ in _WEBSEARCH_CDF], dtype=np.float64)
    cs = np.array([c for _, c in _WEBSEARCH_CDF], dtype=np.float64)
    return np.interp(u, cs, xs)


def mean_websearch_bytes() -> float:
    xs = np.array([b for b, _ in _WEBSEARCH_CDF])
    cs = np.array([c for _, c in _WEBSEARCH_CDF])
    mids = (xs[1:] + xs[:-1]) / 2
    return float((mids * np.diff(cs)).sum())


def mean_websearch_wire_bytes() -> float:
    """Mean *wire* bytes per flow (header per packet included) — the
    quantity arrival-rate sizing must use so realized link load matches
    the requested ``load``."""
    xs = np.array([b for b, _ in _WEBSEARCH_CDF])
    cs = np.array([c for _, c in _WEBSEARCH_CDF])
    mids = (xs[1:] + xs[:-1]) / 2
    return float((wire_bytes(mids) * np.diff(cs)).sum())


# serialization (size_pkts ticks at 1 pkt/tick) + a propagation/ACK
# allowance: the completion-time estimate the simultaneous-sender cap
# windows over
_EST_OVERHEAD_TICKS = 16


def websearch(topo, duration_ticks: int, load: float = 1.0, seed: int = 0,
              max_senders_per_recv: int = 4, max_flows: int | None = None
              ) -> list[Flow]:
    """Poisson arrivals sized to `load` x aggregate endpoint bandwidth.

    ``max_senders_per_recv`` caps *simultaneous* senders per receiver
    (paper wording): each receiver's window is the set of accepted flows
    whose estimated completion (start + serialization + overhead) lies
    after the candidate's start.  The pre-fix code enforced the cap over
    the whole trace lifetime and silently dropped flows after 8 failed
    receiver draws, biasing realized load below ``load``; now a flow
    whose random draws all land on busy receivers falls back to the
    least-busy receiver, so the flow count — and the realized load — is
    preserved exactly."""
    rng = np.random.default_rng(seed)
    n_eps = topo.n_endpoints
    # per-endpoint arrival rate lambda: load * linerate / mean flow size,
    # in wire bytes on both sides (BYTES_PER_TICK wire bytes per tick)
    lam_per_tick = load * BYTES_PER_TICK / mean_websearch_wire_bytes() * n_eps
    n_flows = int(lam_per_tick * duration_ticks)
    if max_flows is not None:
        n_flows = min(n_flows, max_flows)
    starts = np.sort(rng.uniform(0, duration_ticks, n_flows)).astype(np.int64)
    sizes = bytes_to_pkts(sample_websearch_bytes(rng, n_flows))
    srcs = rng.integers(0, n_eps, n_flows)
    busy_until: list[list[int]] = [[] for _ in range(n_eps)]
    flows = []

    def active(d: int, t0: int) -> int:
        busy_until[d] = [e for e in busy_until[d] if e > t0]
        return len(busy_until[d])

    for i in range(n_flows):
        t0 = int(starts[i])
        src = int(srcs[i])
        dst = -1
        for _ in range(8):
            d = int(rng.integers(0, n_eps))
            if d != src and active(d, t0) < max_senders_per_recv:
                dst = d
                break
        if dst < 0:  # redraw exhausted: least-busy receiver keeps the flow
            counts = [(active(d, t0), d) for d in range(n_eps) if d != src]
            dst = min(counts)[1]
        busy_until[dst].append(t0 + int(sizes[i]) + _EST_OVERHEAD_TICKS)
        flows.append(Flow(src, dst, int(sizes[i]), start_tick=t0))
    assert len(flows) == n_flows
    return flows
