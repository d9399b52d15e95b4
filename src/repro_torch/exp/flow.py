"""Flow-level cell executor (DESIGN.md §12/§13).  Port of
``repro.exp.flow``.

Runs a matrix cell at paper scale through ``flowsim.simulate_batch`` on
``device`` (one shared :class:`FlowTable` per cell, every registry
scheme a lane) — the path the old ``bench_fabric --scale`` suite used,
now expressed as data.  Metrics are counters and ratios only; wall time is recorded
as informational ``wall_s`` / ``table_wall_s``.
"""
from __future__ import annotations

import time
from collections import Counter

from repro_torch.exp.workloads import make_topology
from repro_torch.fabric import bridge
from repro_torch.fabric import flowsim as FS
from repro_torch.net.sim.failures import FailureSchedule, chaos_schedule
from repro_torch.net.topology.base import BYTES_PER_TICK, BYTES_PER_US, GLOBAL

MAX_PATHS = 32   # FatPaths-style endpoint-table subset (paths.py §III-C)


def loaded_global_links(topo, flows, k):
    """The ``k`` global links most used by the flow set's minimal routes
    — failing *these* guarantees the outage intersects the workload (a
    uniformly sampled link set usually misses a sub-fabric cell
    entirely, and the failure scenario degenerates to a no-op)."""
    cnt = Counter()
    for f in flows:
        u = topo.ep_switch(f.src_ep)
        for v in topo.static_route(u, topo.ep_switch(f.dst_ep)):
            r = topo.slot_of_edge[(u, v)]
            if topo.nbr_type[u, r] == GLOBAL:
                cnt[(min(u, v), max(u, v))] += 1
            u = v
    return [link for link, _ in cnt.most_common(k)]


def _flows_for(cell, topo):
    kw = dict(cell.workload_kw)
    n_chips = kw.get("n_chips") or (topo.n_endpoints
                                    // kw["tp"]) * kw["tp"]
    return bridge.cell_flows(topo, cell.workload, kw["shard"],
                             n_chips=n_chips, tp=kw["tp"])


# per-process memo of (flows, FlowTable) per flow-set key: path
# enumeration dominates flow-level setup at paper scale, and e.g. the
# train and midrun_failure cells of one tier share the exact flow set
# (the old bench_fabric reused the train table for the same reason)
_TABLE_MEMO: dict = {}


def _flow_set(cell, topo):
    key = (cell.topology, cell.scale, cell.workload,
           tuple(sorted(dict(cell.workload_kw).items())))
    if key not in _TABLE_MEMO:
        flows = _flows_for(cell, topo)
        t0 = time.time()
        table = FS.build_flow_table(topo, flows, max_paths=MAX_PATHS)
        _TABLE_MEMO[key] = (flows, table, round(time.time() - t0, 2))
    return _TABLE_MEMO[key]


def _failure_plan(cell, topo, flows):
    """Flow-level failure/degradation scenarios over the *loaded*
    links (a uniformly sampled set usually misses a sub-fabric cell).

    ``loaded_midrun``: outage at 1/``fail_at_frac`` of the solo horizon,
    recovered at ``recover_mult``x — outliving contention slack, so
    static schemes measurably stall (DESIGN.md §12).
    ``loaded_degraded``: same window, but the links brown out to
    ``rate`` of line rate instead of dying — capacities masked via the
    compiled schedule, ports stay alive.
    ``chaos``: seeded randomized capacity schedule over the whole
    fabric (seed recorded in the cell's ``failure_kw``)."""
    if cell.failure is None:
        return None
    kw = dict(cell.failure_kw)
    horizon = int(max(f.size_bytes for f in flows) / BYTES_PER_TICK)
    if cell.failure == "chaos":
        return chaos_schedule(
            topo, horizon=horizon * int(kw.get("horizon_mult", 4)),
            seed=int(kw.get("seed", 0)),
            n_events=int(kw.get("n_events", 4)),
            max_links=int(kw.get("max_links", 3)))
    if cell.failure not in ("loaded_midrun", "loaded_degraded"):
        raise ValueError(f"{cell.cell_id}: unknown flow failure plan "
                         f"{cell.failure!r}")
    n_links = int(kw.get("n_links", 8))
    fail_at = max(1, horizon // int(kw.get("fail_at_frac", 4)))
    recover_at = horizon * int(kw.get("recover_mult", 16))
    links = loaded_global_links(topo, flows, n_links)
    if cell.failure == "loaded_degraded":
        return FailureSchedule(topo).degrade_links(
            fail_at, links, float(kw.get("rate", 0.25)), until=recover_at)
    return (FailureSchedule(topo)
            .fail_links(at=fail_at, links=links)
            .recover(at=recover_at))


def run_flow_cell(cell, schemes, seeds, verbose=True,
                  device=None) -> list[dict]:
    """Materialize + execute one flow-level cell on ``device``; flat
    metric rows."""
    topo = make_topology(cell.topology, cell.scale)
    flows, table, table_wall = _flow_set(cell, topo)
    plan = _failure_plan(cell, topo, flows)
    if verbose:
        print(f"[exp/{cell.cell_id}] {len(flows)} flows, "
              f"{len(schemes)} schemes x {len(seeds)} seeds", flush=True)
    rows = []
    per_seed_ecmp: dict[int, float] = {}
    for name in schemes:
        t0 = time.time()
        per_seed = FS.simulate_batch(topo, flows, [name], seeds=list(seeds),
                                     failure_plan=plan, table=table,
                                     max_paths=MAX_PATHS,
                                     device=device)[name]
        wall = time.time() - t0
        for seed, res in zip(seeds, per_seed):
            done = res.fct >= 0
            row = {"topology": cell.topology, "workload": cell.workload,
                   "scheme": name, "seed": int(seed),
                   "fct_us": round(float(res.fct[done].max())
                                   / BYTES_PER_US, 1) if done.any() else -1.0,
                   "fct_mean_us": round(float(res.fct[done].mean())
                                        / BYTES_PER_US, 1)
                   if done.any() else -1.0,
                   "done_frac": round(float(done.mean()), 4),
                   "reselections": int(res.reselections),
                   "forced": int(res.forced),
                   "epochs": int(res.epochs),
                   "rate_violations": int(res.rate_violations),
                   "wall_s": round(wall / max(len(per_seed), 1), 2),
                   "table_wall_s": table_wall}
            if name == "ecmp" and row["fct_us"] > 0:
                per_seed_ecmp[int(seed)] = row["fct_us"]
            rows.append(row)
            if verbose:
                print("   ", row, flush=True)
    # ratio column only exists when the ecmp reference was part of the
    # run (guards legitimately skip it otherwise); within such a run a
    # non-computable ratio is the explicit -1.0 sentinel — a collapsed
    # lane must FAIL a baseline guard, never silently drop out of it
    if "ecmp" in schemes:
        for row in rows:
            ecmp = per_seed_ecmp.get(row["seed"], -1.0)
            if ecmp > 0 and row["fct_us"] > 0:
                row["fct_ratio_vs_ecmp"] = round(row["fct_us"] / ecmp, 3)
            else:
                row["fct_ratio_vs_ecmp"] = -1.0
    if cell.failure:
        for row in rows:
            row["scenario"] = cell.failure
    return rows
