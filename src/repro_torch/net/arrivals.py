"""Open-loop arrival processes (DESIGN.md §15).  Port of
``repro.net.arrivals``: the same substreams, so the same seed gives the
same arrivals.

Every closed-loop workload materializes a fixed flow set; this module
instead compiles a sustained **arrival process** — Poisson or
trace-driven per-endpoint flow arrivals — into the event-stream form the
packet engine already treats as first-class: its injection phase gates
on ``start_tick`` and its horizon treats pending starts as events
(DESIGN.md §4), so a compiled arrival stream rides the engine's loop
without host round-trips, and dense == compressed stays bit-exact.  (The
flow-level form, :meth:`ArrivalStream.to_flowspecs`, waits for the
port's flow engine.)

**Folded-PRNG discipline.**  Each endpoint draws its arrival times,
destinations and sizes from an independent substream seeded
``(seed, endpoint)``.  Endpoint streams therefore never interleave:
generating a subset of endpoints, or the whole fabric, yields
bit-identical arrivals per endpoint.

Loads are offered-load *fractions of per-endpoint line rate*: one tick
serializes one wire packet (``BYTES_PER_TICK``), so ``load=0.9`` means
each endpoint sources flows worth 0.9 wire packets per tick in
expectation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.net.topology.base import BYTES_PER_TICK, bytes_to_pkts
from repro_torch.net.workloads.trace import (_WEBSEARCH_CDF,
                                             mean_websearch_wire_bytes,
                                             sample_websearch_bytes)


@dataclasses.dataclass(frozen=True)
class ArrivalStream:
    """A compiled arrival event stream, sorted by start tick.

    ``size_pkts`` is the canonical size unit (one packet == one tick ==
    ``BYTES_PER_TICK`` wire bytes), so the packet- and flow-level
    materializations describe the identical wire volume.
    ``horizon_ticks`` is the covered horizon: every arrival up to and
    including it is present (a ``max_flows`` truncation shrinks it so
    the stream never *silently* under-offers load past its coverage).
    """

    src_ep: np.ndarray       # [F] int64
    dst_ep: np.ndarray       # [F] int64
    size_pkts: np.ndarray    # [F] int64
    start_tick: np.ndarray   # [F] int64, non-decreasing
    horizon_ticks: int
    load: float              # requested offered-load fraction
    truncated: bool = False  # max_flows cap shrank the horizon

    @property
    def n_flows(self) -> int:
        return len(self.start_tick)

    def offered_load(self, n_endpoints: int) -> float:
        """Realized offered load: injected wire bytes over aggregate
        endpoint capacity across the covered horizon."""
        if self.horizon_ticks <= 0 or n_endpoints <= 0:
            return 0.0
        return float(self.size_pkts.sum()
                     / (n_endpoints * self.horizon_ticks))

    def to_packet_flows(self) -> list:
        """Materialize as packet-engine flows (``start_tick`` gates
        injection; starts are horizon events, DESIGN.md §4)."""
        from repro_torch.net.sim.build import Flow
        return [Flow(int(s), int(d), int(z), start_tick=int(t))
                for s, d, z, t in zip(self.src_ep, self.dst_ep,
                                      self.size_pkts, self.start_tick)]

    def to_flowspecs(self) -> list:
        """Flow-engine specs in wire byte-times: not ported yet."""
        raise NotImplementedError(
            "ArrivalStream.to_flowspecs needs the flow-level engine, which "
            "the port does not have yet (ROADMAP.md queue 1, item 5)")


def _capped_websearch_mean_wire_bytes(cap_pkts: int) -> float:
    """Mean wire bytes of ``min(bytes_to_pkts(X), cap)`` under the
    web-search size law — rate sizing must use the *clipped* mean or
    capped streams under-offer load.  Integrated on a fine quantile
    grid of the exact sampler distribution (midpoints mis-handle
    segments the cap splits)."""
    xs = np.array([b for b, _ in _WEBSEARCH_CDF], np.float64)
    cs = np.array([c for _, c in _WEBSEARCH_CDF], np.float64)
    u = (np.arange(100_000) + 0.5) / 100_000
    pkts = np.minimum(bytes_to_pkts(np.interp(u, cs, xs)), int(cap_pkts))
    return float(pkts.mean() * BYTES_PER_TICK)


def _flow_rate_per_tick(load: float, size,
                        size_cap_pkts: int | None = None) -> float:
    """Per-endpoint Poisson rate (flows/tick) for an offered-load
    fraction, sized against the mean *wire* bytes of the (possibly
    capped) size law."""
    if size == "websearch":
        mean_wire = (mean_websearch_wire_bytes() if size_cap_pkts is None
                     else _capped_websearch_mean_wire_bytes(size_cap_pkts))
    else:
        pkts = float(int(size))
        if size_cap_pkts is not None:
            pkts = min(pkts, float(size_cap_pkts))
        mean_wire = pkts * BYTES_PER_TICK
    return load * BYTES_PER_TICK / mean_wire


def _endpoint_arrivals(rng: np.random.Generator, lam: float,
                       horizon_ticks: int, n_eps: int, ep: int, size,
                       size_cap_pkts: int | None):
    """One endpoint's arrival substream: exponential gaps at rate
    ``lam``, then a destination and a size per arrival — all from the
    endpoint's own folded generator."""
    # over-draw the gap block once (mean + 6 sigma), extend in the rare
    # tail case; draws stay sequential so the stream is deterministic
    est = lam * horizon_ticks
    n_draw = max(int(est + 6.0 * np.sqrt(est + 1.0)) + 4, 4)
    gaps = rng.exponential(1.0 / lam, n_draw)
    t = np.cumsum(gaps)
    while t[-1] <= horizon_ticks:
        more = rng.exponential(1.0 / lam, n_draw)
        t = np.concatenate([t, t[-1] + np.cumsum(more)])
    starts = t[t <= horizon_ticks]
    n = len(starts)
    # uniform destination excluding self
    dst = rng.integers(0, n_eps - 1, n)
    dst = np.where(dst >= ep, dst + 1, dst)
    if size == "websearch":
        sizes = bytes_to_pkts(sample_websearch_bytes(rng, n))
    else:
        sizes = np.full(n, int(size), np.int64)
    if size_cap_pkts is not None:
        sizes = np.minimum(sizes, int(size_cap_pkts))
    return starts.astype(np.int64), dst.astype(np.int64), sizes


def poisson_stream(topo, *, load: float, horizon_ticks: int, seed: int = 0,
                   size="websearch", size_cap_pkts: int | None = None,
                   max_flows: int | None = None,
                   endpoints=None) -> ArrivalStream:
    """Compile a Poisson open-loop arrival stream for ``topo``.

    ``size`` is ``"websearch"`` (DCTCP web-search flow sizes, the
    paper's datacenter trace) or a fixed packet count;
    ``size_cap_pkts`` optionally clips the size law (recorded in the
    cell spec when used — reduced-tier cells cap the elephant tail so
    the drain allowance stays bounded).  ``endpoints`` restricts
    generation to a subset; per-endpoint substreams are seeded
    ``(seed, ep)`` so a subset's arrivals are bit-identical to the same
    endpoints inside a full-fabric stream.  ``max_flows`` keeps the
    earliest arrivals and *shrinks* ``horizon_ticks`` to the last kept
    start, so coverage stays complete rather than silently thinning.
    """
    if not (0.0 < load):
        raise ValueError(f"load must be positive, got {load}")
    if horizon_ticks <= 0:
        raise ValueError(f"horizon_ticks must be positive, got "
                         f"{horizon_ticks}")
    n_eps = topo.n_endpoints
    eps = range(n_eps) if endpoints is None else list(endpoints)
    lam = _flow_rate_per_tick(load, size, size_cap_pkts)
    srcs, dsts, sizes, starts = [], [], [], []
    for ep in eps:
        rng = np.random.default_rng([int(seed), int(ep)])
        t, d, z = _endpoint_arrivals(rng, lam, horizon_ticks, n_eps,
                                     int(ep), size, size_cap_pkts)
        starts.append(t)
        dsts.append(d)
        sizes.append(z)
        srcs.append(np.full(len(t), int(ep), np.int64))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    zs = np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
    st = np.concatenate(starts) if starts else np.zeros(0, np.int64)
    order = np.lexsort((dst, src, st))     # fully deterministic order
    src, dst, zs, st = src[order], dst[order], zs[order], st[order]
    truncated = False
    horizon = int(horizon_ticks)
    if max_flows is not None and len(st) > max_flows:
        src, dst, zs, st = (a[:max_flows] for a in (src, dst, zs, st))
        horizon = int(st[-1])              # coverage complete through here
        truncated = True
    return ArrivalStream(src_ep=src, dst_ep=dst, size_pkts=zs,
                         start_tick=st, horizon_ticks=horizon,
                         load=float(load), truncated=truncated)


def trace_stream(src_ep, dst_ep, size_pkts, start_tick,
                 horizon_ticks: int | None = None) -> ArrivalStream:
    """Compile a trace-driven arrival stream from explicit per-flow
    arrays (e.g. a replayed datacenter trace).  Arrivals are sorted into
    the canonical deterministic order; ``horizon_ticks`` defaults to the
    last arrival."""
    src = np.asarray(src_ep, np.int64)
    dst = np.asarray(dst_ep, np.int64)
    zs = np.asarray(size_pkts, np.int64)
    st = np.asarray(start_tick, np.int64)
    if not (len(src) == len(dst) == len(zs) == len(st)):
        raise ValueError("trace arrays must share one length")
    if len(zs) and zs.min() <= 0:
        raise ValueError("trace sizes must be positive packet counts")
    order = np.lexsort((dst, src, st))
    src, dst, zs, st = src[order], dst[order], zs[order], st[order]
    horizon = int(horizon_ticks) if horizon_ticks is not None \
        else (int(st[-1]) if len(st) else 0)
    # requested-load bookkeeping is meaningless for a trace; record the
    # realized fraction per covered tick instead (0 when unknowable)
    return ArrivalStream(src_ep=src, dst_ep=dst, size_pkts=zs,
                         start_tick=st, horizon_ticks=horizon,
                         load=0.0, truncated=False)
