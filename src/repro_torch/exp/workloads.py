"""Packet-cell workload and failure-plan builders for the experiment
matrix (DESIGN.md §13).  Port of ``repro.exp.workloads``: the port's
host layer builds the same flows, masks and plans for the same cell.

Each builder is pure data-in/data-out: a cell names a builder plus a kw
dict, and the packet executor materializes flows, masks, stop sets and
failure plans from them.  The builders absorb what used to be inlined
in the nine ``benchmarks/bench_*`` modules, so a new scenario is one
matrix entry instead of a tenth script.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.sim import build as B
from repro_torch.net.sim.failures import (FailureSchedule, all_links,
                                          chaos_schedule, sample_links)
from repro_torch.net.topology.base import TICK_NS
from repro_torch.net.topology.dragonfly import make_dragonfly
from repro_torch.net.topology.slimfly import make_slimfly
from repro_torch.net.workloads import (adversarial, allreduce_butterfly,
                                       allreduce_ring, alltoall,
                                       incast_bystanders, motivational,
                                       permutation, websearch)


def make_topology(name: str, scale: str):
    """The matrix's topology table (EXPERIMENTS.md 'Scales')."""
    table = {
        ("dragonfly", "small"): lambda: make_dragonfly(4, 2, 2),
        ("dragonfly", "mid"): lambda: make_dragonfly(6, 3, 3),
        ("dragonfly", "full"): lambda: make_dragonfly(8, 4, 4),
        ("slimfly", "small"): lambda: make_slimfly(5, p=2),
        ("slimfly", "mid"): lambda: make_slimfly(5, p=3),
        ("slimfly", "full"): lambda: make_slimfly(9),
        ("dragonfly1056", "quick"): lambda: make_dragonfly(8, 4, 4),
        ("dragonfly1056", "full"): lambda: make_dragonfly(8, 4, 4),
        ("slimfly1134", "quick"): lambda: make_slimfly(9),
        ("slimfly1134", "full"): lambda: make_slimfly(9),
    }
    try:
        return table[(name, scale)]()
    except KeyError:
        raise ValueError(f"unknown topology/scale {name}/{scale}") from None


class Workload:
    """Materialized packet workload: flows plus the mask/stop metadata
    the executor needs to slice per-figure statistics."""

    def __init__(self, flows, masks=None, stop_flows=None,
                 collective=False):
        self.flows = flows
        self.masks = masks or {}
        self.stop_flows = stop_flows
        self.collective = collective


def _wl_permutation(topo, *, size_pkts: int, seed: int = 0) -> Workload:
    return Workload(permutation(topo, size_pkts=size_pkts, seed=seed))


def _wl_adversarial(topo, *, size_pkts: int, seed: int = 0) -> Workload:
    return Workload(adversarial(topo, size_pkts=size_pkts, seed=seed))


def _wl_motivational(topo, *, mon_mib: float = 4.0, bg_pkts: int = 1 << 14,
                     n_free_groups: int = 2, bg_flows_per_ep: int = 5,
                     warmup_ticks: int = 1024) -> Workload:
    mon = B.mib_to_pkts(mon_mib)
    flows, mi = motivational(topo, mon, bg_pkts=bg_pkts,
                             n_free_groups=n_free_groups,
                             bg_flows_per_ep=bg_flows_per_ep,
                             warmup_ticks=warmup_ticks)
    return Workload(flows, masks={"mon": np.arange(len(flows)) == mi},
                    stop_flows=np.array([mi]))


_COLLECTIVES = {"allreduce_ring": allreduce_ring,
                "allreduce_butterfly": allreduce_butterfly,
                "alltoall": alltoall}


def _wl_collective(topo, *, kind: str, m: int, total_mib: float,
                   bg_pkts: int = 256, seed: int = 2) -> Workload:
    flows, mask = _COLLECTIVES[kind](topo, m, B.mib_to_pkts(total_mib),
                                     seed=seed, with_background=True,
                                     bg_pkts=bg_pkts)
    return Workload(flows, masks={"coll": mask},
                    stop_flows=np.where(mask)[0], collective=True)


def _wl_incast(topo, *, n_senders: int, size_mib: float,
               seed: int = 3) -> Workload:
    flows, by = incast_bystanders(topo, n_senders, B.mib_to_pkts(size_mib),
                                  seed=seed)
    return Workload(flows, masks={"incast": ~by, "by": by})


def _wl_websearch(topo, *, dur_us: float, load: float = 1.0,
                  max_flows: int = 4000, seed: int = 4) -> Workload:
    ticks = int(dur_us * 1000 / TICK_NS)
    return Workload(websearch(topo, ticks, load=load, seed=seed,
                              max_flows=max_flows))


def _wl_probe(topo, *, dst_ep: int = 40, size_pkts: int = 64,
              start_tick: int = 2048) -> Workload:
    """bench_engine's deterministic compression probe: one flow with a
    long idle pre-start span + drain tail — the horizon driver covers it
    in a few hundred steps (DESIGN.md §4)."""
    return Workload([B.Flow(0, dst_ep, size_pkts, start_tick=start_tick)])


WORKLOADS = {
    "permutation": _wl_permutation,
    "adversarial": _wl_adversarial,
    "motivational": _wl_motivational,
    "collective": _wl_collective,
    "incast": _wl_incast,
    "websearch": _wl_websearch,
    "probe": _wl_probe,
}


def build_workload(cell, topo) -> Workload:
    try:
        fn = WORKLOADS[cell.workload]
    except KeyError:
        raise ValueError(f"{cell.cell_id}: unknown workload "
                         f"{cell.workload!r}") from None
    return fn(topo, **dict(cell.workload_kw))


# ---------------------------------------------------------- failure plans

def sampled_failed_links(topo, frac: float, seed: int):
    k = max(1, int(frac * len(all_links(topo))))
    return sample_links(topo, k, seed=seed)


def fail_window(size_pkts: int) -> tuple[int, int]:
    """(T_FAIL, T_RECOVER) scaled to the workload: a flow of S packets
    injects for >= S ticks, so failing at S/2 is guaranteed mid-flight;
    the outage spans several RTOs so senders actually react before the
    links heal."""
    t_fail = size_pkts // 2
    return t_fail, t_fail + 16 * size_pkts


class FailureCtx:
    """spec_kw additions + the post-failure tick the executor slices
    ``postfail_*`` statistics at (None for static plans)."""

    def __init__(self, spec_kw: dict, t_fail: int | None = None):
        self.spec_kw = spec_kw
        self.t_fail = t_fail


def _fp_static_links(topo, cell, *, frac: float = 0.02,
                     seed: int = 5) -> FailureCtx:
    return FailureCtx({"failed_links":
                       sampled_failed_links(topo, frac, seed)})


def _fp_midrun_links(topo, cell, *, frac: float = 0.02,
                     seed: int = 5) -> FailureCtx:
    size = int(cell.workload_kw["size_pkts"])
    t_fail, t_recover = fail_window(size)
    plan = (FailureSchedule(topo)
            .fail_links(t_fail, sampled_failed_links(topo, frac, seed))
            .recover(t_recover))
    # block ~ the outage scale: long enough that a dead EV is probed a
    # handful of times, short enough that recovery is re-discovered
    return FailureCtx({"failure_plan": plan, "block_ticks": 4 * size},
                      t_fail=t_fail)


def _fp_flap_links(topo, cell, *, frac: float = 0.02,
                   seed: int = 5) -> FailureCtx:
    size = int(cell.workload_kw["size_pkts"])
    t_fail, t_recover = fail_window(size)
    failed = sampled_failed_links(topo, frac, seed)
    plan = FailureSchedule(topo).flap(
        failed[: max(1, len(failed) // 2)], period=4 * size,
        at=t_fail, until=t_recover)
    return FailureCtx({"failure_plan": plan, "block_ticks": 2 * size},
                      t_fail=t_fail)


def _fp_degraded_links(topo, cell, *, frac: float = 0.05, rate: float = 0.25,
                       seed: int = 5) -> FailureCtx:
    """Brownout: sampled links drop to ``rate`` of line rate over the
    same mid-flight window the outage scenarios use, then heal.  Ports
    stay *up* throughout — adaptive schemes must steer away from slow
    (not dead) capacity via the load/ECN signal alone."""
    size = int(cell.workload_kw["size_pkts"])
    t_fail, t_recover = fail_window(size)
    plan = FailureSchedule(topo).degrade_links(
        t_fail, sampled_failed_links(topo, frac, seed), rate,
        until=t_recover)
    return FailureCtx({"failure_plan": plan, "block_ticks": 4 * size},
                      t_fail=t_fail)


def _fp_chaos(topo, cell, *, seed: int = 0, n_events: int = 4,
              max_links: int = 3, horizon_mult: int = 8) -> FailureCtx:
    """Seeded randomized capacity schedule (brownouts / outages /
    oversubscription / tenants / flaps / drains) via
    :func:`repro_torch.net.sim.failures.chaos_schedule`.  The seed lives in
    the cell's ``failure_kw`` and therefore in the result JSON's spec
    block — every chaos run is reproducible from its recorded seed.
    All events recover by ``settle_frac`` of the horizon, so graceful
    degradation (bounded FCT ratio, full completion) is a fair ask."""
    size = int(cell.workload_kw["size_pkts"])
    plan = chaos_schedule(topo, horizon=horizon_mult * size, seed=seed,
                          n_events=n_events, max_links=max_links)
    return FailureCtx({"failure_plan": plan, "block_ticks": 2 * size})


FAILURES = {
    "static_links": _fp_static_links,
    "midrun_links": _fp_midrun_links,
    "flap_links": _fp_flap_links,
    "degraded_links": _fp_degraded_links,
    "chaos": _fp_chaos,
}


def build_failure(cell, topo) -> FailureCtx:
    if cell.failure is None:
        return FailureCtx({})
    try:
        fn = FAILURES[cell.failure]
    except KeyError:
        raise ValueError(f"{cell.cell_id}: unknown failure plan "
                         f"{cell.failure!r}") from None
    return fn(topo, cell, **dict(cell.failure_kw))
