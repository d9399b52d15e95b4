"""THE experiment matrix (DESIGN.md §13): every paper figure/table cell
as data, across tiers ``smoke`` / ``ci`` / ``chaos`` / ``full``.  A
copy of ``repro.exp.matrix``, whole: the port registers every cell, the
flow-level ones too, so the cell list stays one list
(``tests/test_torch_exp.py`` holds it equal to the reference's).

* ``smoke`` — the per-PR CI gate: a handful of minutes-scale cells
  spanning both engines, both topologies and a mid-run failure plan,
  with hard ratio/counter guards (the old four ad-hoc bench smoke
  steps).
* ``ci`` — the nightly matrix: every figure at reduced scale, all
  registered schemes, both topologies, guarded against the checked-in
  baselines.
* ``chaos`` — seeded randomized capacity schedules (DESIGN.md §10):
  brownouts, drains, oversubscription, tenants, flaps.  Guards assert
  graceful degradation for the adaptive schemes — bounded
  ``degrade_ratio`` vs an in-session healthy baseline, zero
  ``down_violations`` / ``rate_violations`` — while static schemes run
  unguarded (they are allowed to collapse).  Nightly re-rolls extra
  seeds via ``--chaos-seeds``; each lands in the result JSON's spec.
* ``full`` — the paper-scale reproduction (slow; refreshes the numbers
  EXPERIMENTS.md reports).

Adding the next scenario = appending one :class:`~repro_torch.exp.spec.Cell`
here and in the reference's matrix; it joins ``python -m repro_torch.exp
run`` and the tier-enumeration tests.
"""
from __future__ import annotations

from repro_torch.exp.spec import Cell

# registry scheme-name shorthands (validated against the policy registry
# by tests/test_torch_exp.py — the matrix itself is plain data).
SPRITZ_W = "spritz_spray_w"
FAILOVER_SCHEMES = ("valiant", "ops_u", "ops_w", "spritz_scout",
                    "spritz_spray_u", SPRITZ_W, "reps")
SMOKE_SCHEMES = ("ecmp", "ugal_l", "ops_u", SPRITZ_W, "reps")
FLOW_SMOKE_SCHEMES = ("ecmp", "ops_u", SPRITZ_W)
# chaos cells mix static schemes (may collapse, unguarded) with the
# adaptive set that must degrade gracefully
CHAOS_STATIC = ("minimal", "ecmp")
CHAOS_ADAPTIVE = ("ops_u", "spritz_scout", SPRITZ_W, "reps")
CHAOS_SCHEMES = CHAOS_STATIC + CHAOS_ADAPTIVE

_G_NO_DOWN = {"kind": "counter", "metric": "down_violations",
              "op": "==", "value": 0}
_G_NO_RATE = {"kind": "counter", "metric": "rate_violations",
              "op": "==", "value": 0}


def _g_counter(metric, op, value, scheme=None, where=None):
    g = {"kind": "counter", "metric": metric, "op": op, "value": value}
    if scheme:
        g["scheme"] = scheme
    if where:
        g["where"] = where
    return g


def _g_ratio(metric, num, den, value, op="<=", where=None):
    g = {"kind": "ratio", "metric": metric, "num": num, "den": den,
         "op": op, "value": value}
    if where:
        g["where"] = where
    return g


def _g_fabric_baseline(topo, cell, metric, **kw):
    return {"kind": "baseline_schemes", "file": "BENCH_fabric.json",
            "path": f"quick_cells.{topo}.{cell}.schemes",
            "metric": metric, **kw}


def _g_graceful(ratio_bound, done_min=0.99):
    """Graceful-degradation guard set for the adaptive schemes: every
    adaptive lane finishes its flows and stays within ``ratio_bound`` x
    its own healthy-baseline mean FCT.  Static lanes are unguarded."""
    gs = [_G_NO_DOWN, _G_NO_RATE]
    for s in CHAOS_ADAPTIVE:
        gs.append(_g_counter("done_frac", ">=", done_min, scheme=s))
        gs.append(_g_counter("degrade_ratio", "<=", ratio_bound, scheme=s))
    return tuple(gs)


def _cells() -> list[Cell]:
    cells: list[Cell] = []

    # ---------------------------------------------------- smoke tier
    cells += [
        Cell(
            cell_id="micro.dragonfly.adversarial.smoke",
            figure="fig6", bench="micro", engine="packet",
            topology="dragonfly", scale="small", workload="adversarial",
            workload_kw={"size_pkts": 512, "seed": 1},
            schemes=SMOKE_SCHEMES, n_ticks=1 << 17,
            spec_kw={"n_pkt_cap": 1 << 17}, tiers=("smoke",),
            guards=(_G_NO_DOWN,
                    _g_counter("done_frac", ">=", 0.99),
                    _g_ratio("fct_mean_us", SPRITZ_W, "ecmp", 1.0)),
        ),
        Cell(
            cell_id="failures.dragonfly.midrun.smoke",
            figure="fig9", bench="failures", engine="packet",
            topology="dragonfly", scale="small", workload="permutation",
            workload_kw={"size_pkts": 256, "seed": 6},
            schemes=FAILOVER_SCHEMES,
            failure="midrun_links", failure_kw={"frac": 0.02, "seed": 5},
            n_ticks=1 << 18, spec_kw={"n_pkt_cap": 1 << 17},
            tiers=("smoke",),
            guards=(_G_NO_DOWN, _G_NO_RATE,
                    _g_ratio("postfail_fct_mean_us", "spritz_scout",
                             "ops_u", 1.0),
                    _g_ratio("postfail_fct_mean_us", "spritz_spray_u",
                             "ops_u", 1.0),
                    _g_ratio("postfail_fct_mean_us", SPRITZ_W,
                             "ops_u", 1.0)),
        ),
        Cell(
            cell_id="collectives.slimfly.alltoall.smoke",
            figure="fig7", bench="collectives", engine="packet",
            topology="slimfly", scale="small", workload="collective",
            workload_kw={"kind": "alltoall", "m": 16, "total_mib": 1.0,
                         "bg_pkts": 256, "seed": 2},
            schemes=("ecmp", "ugal_l", "ops_w", SPRITZ_W),
            n_ticks=1 << 18, spec_kw={"n_pkt_cap": 1 << 17},
            tiers=("smoke",),
            guards=(_G_NO_DOWN,
                    _g_counter("coll_done_frac", ">=", 0.99)),
        ),
        # the BENCH_engine.json guard as a matrix cell: the horizon
        # driver's compression on the deterministic dead-time probe —
        # steps_executed is exact, so any decay fires the baseline guard
        Cell(
            cell_id="engine.dragonfly.probe.smoke",
            figure="engine_perf", bench="engine", engine="packet",
            topology="dragonfly", scale="small", workload="probe",
            workload_kw={}, schemes=("ecmp",), n_ticks=1 << 13,
            tiers=("smoke", "ci"),
            guards=(_g_counter("compression", ">=", 8.0),
                    {"kind": "baseline", "file": "BENCH_engine.json",
                     "path": "compression_probe.steps_executed",
                     "metric": "steps", "scheme": "ecmp",
                     "tol": 0.25, "dir": "max"}),
        ),
        # seeded chaos smoke cell (also the ci.yml chaos step): one
        # fixed recorded seed, randomized only across ``--chaos-seeds``
        Cell(
            cell_id="chaos.dragonfly.s7.smoke",
            figure="chaos_tier", bench="failures", engine="packet",
            topology="dragonfly", scale="small", workload="permutation",
            workload_kw={"size_pkts": 256, "seed": 6},
            schemes=CHAOS_SCHEMES,
            failure="chaos",
            failure_kw={"seed": 7, "n_events": 4, "max_links": 3},
            n_ticks=1 << 18,
            spec_kw={"n_pkt_cap": 1 << 17, "with_healthy_ref": True},
            tiers=("smoke", "chaos"),
            guards=_g_graceful(4.0),
        ),
    ]

    # paper-scale PACKET-engine cells (DESIGN.md §14): the 1056-endpoint
    # Dragonfly (smoke+ci) and 1134-endpoint Slim Fly (ci) run through
    # the exact packet engine itself — its occupancy-bounded carry and
    # sparse rank/aggregation paths, not the flow-level abstraction.
    # Guards are counters and in-session ratios only; wall time is
    # recorded, never gated.
    for topo, tiers in (("dragonfly1056", ("smoke", "ci")),
                        ("slimfly1134", ("ci",))):
        cells.append(Cell(
            cell_id=f"engine.{topo}.permutation.quick",
            figure="engine_perf", bench="engine", engine="packet",
            topology=topo, scale="quick", workload="permutation",
            workload_kw={"size_pkts": 32, "seed": 1},
            schemes=("ecmp", "ugal_l", SPRITZ_W), n_ticks=1 << 14,
            tiers=tiers,
            guards=(_G_NO_DOWN,
                    _g_counter("done_frac", ">=", 0.99),
                    _g_ratio("fct_mean_us", SPRITZ_W, "ecmp", 1.0))))

    # ------------------------------------------------- chaos tier:
    # additional recorded seeds per topology (nightly re-rolls more via
    # --chaos-seeds; derived cells keep these guards)
    for topo in ("dragonfly", "slimfly"):
        for cseed in (11, 23):
            cells.append(Cell(
                cell_id=f"chaos.{topo}.s{cseed}.small",
                figure="chaos_tier", bench="failures", engine="packet",
                topology=topo, scale="small", workload="permutation",
                workload_kw={"size_pkts": 256, "seed": 6},
                schemes=CHAOS_SCHEMES,
                failure="chaos",
                failure_kw={"seed": cseed, "n_events": 5, "max_links": 3},
                n_ticks=1 << 18,
                spec_kw={"n_pkt_cap": 1 << 17, "with_healthy_ref": True},
                tiers=("chaos",),
                # harsher schedules (5 waves incl. switch drains, which
                # hit delivery ports no scheme can route around): the
                # bound asserts no collapse, with headroom over the
                # observed worst (~5.3x on slimfly)
                guards=_g_graceful(8.0)))

    # flow-level smoke: the BENCH_fabric.json guard cells (quick configs)
    cells += [
        Cell(
            cell_id="fabric.dragonfly1056.train.smoke",
            figure="fabric_scale", bench="fabric", engine="flow",
            topology="dragonfly1056", scale="quick", workload="train",
            workload_kw={"n_chips": 256, "tp": 16, "shard": 4e6},
            schemes=FLOW_SMOKE_SCHEMES, tiers=("smoke",),
            guards=(_g_fabric_baseline("dragonfly1056", "train",
                                       "done_frac", abs_tol=0.02),
                    _g_fabric_baseline("dragonfly1056", "train",
                                       "fct_ratio_vs_ecmp", tol=0.25),
                    _g_ratio("fct_us", SPRITZ_W, "ecmp", 0.7)),
        ),
        Cell(
            cell_id="fabric.slimfly1134.alltoall.smoke",
            figure="fabric_scale", bench="fabric", engine="flow",
            topology="slimfly1134", scale="quick", workload="alltoall",
            workload_kw={"n_chips": 128, "tp": 16, "shard": 2e6},
            schemes=FLOW_SMOKE_SCHEMES, tiers=("smoke",),
            guards=(_g_fabric_baseline("slimfly1134", "alltoall",
                                       "done_frac", abs_tol=0.02),
                    _g_fabric_baseline("slimfly1134", "alltoall",
                                       "fct_ratio_vs_ecmp", tol=0.25),
                    _g_ratio("fct_us", SPRITZ_W, "ecmp", 0.85)),
        ),
        Cell(
            cell_id="fabric.dragonfly1056.midrun.smoke",
            figure="fabric_scale", bench="fabric", engine="flow",
            topology="dragonfly1056", scale="quick", workload="train",
            workload_kw={"n_chips": 256, "tp": 16, "shard": 4e6},
            failure="loaded_midrun",
            failure_kw={"n_links": 8, "fail_at_frac": 4,
                        "recover_mult": 16},
            schemes=FLOW_SMOKE_SCHEMES, tiers=("smoke",),
            guards=(_g_fabric_baseline("dragonfly1056", "midrun_failure",
                                       "done_frac", abs_tol=0.02),
                    _g_fabric_baseline("dragonfly1056", "midrun_failure",
                                       "fct_ratio_vs_ecmp", tol=0.25),
                    _g_counter("forced", ">=", 1, scheme=SPRITZ_W),
                    _g_ratio("fct_us", SPRITZ_W, "ecmp", 0.5)),
        ),
    ]

    # ------------------------------------------- ci tier (nightly) +
    # ------------------------------------------- full tier (paper scale)
    for topo in ("dragonfly", "slimfly"):
        for wname in ("permutation", "adversarial"):
            for scale, size, tiers in (("small", 512, ("ci",)),
                                       ("full", 1024, ("full",))):
                cells.append(Cell(
                    cell_id=f"micro.{topo}.{wname}.{scale}",
                    figure="fig6", bench="micro", engine="packet",
                    topology=topo, scale=scale, workload=wname,
                    workload_kw={"size_pkts": size, "seed": 1},
                    n_ticks=1 << 17, spec_kw={"n_pkt_cap": 1 << 17},
                    tiers=tiers, guards=(_G_NO_DOWN,)))
        for scale, tiers in (("small", ("ci",)), ("full", ("full",))):
            cells.append(Cell(
                cell_id=f"motivational.{topo}.{scale}",
                figure="table3_fig5", bench="motivational",
                engine="packet", topology=topo, scale=scale,
                workload="motivational", workload_kw={"mon_mib": 4.0},
                n_ticks=1 << 17, spec_kw={"n_pkt_cap": 1 << 17},
                tiers=tiers,
                guards=(_G_NO_DOWN,
                        _g_ratio("mon_fct_mean_us", SPRITZ_W,
                                 "ugal_l", 1.1))))
            for kind in ("allreduce_ring", "allreduce_butterfly",
                         "alltoall"):
                full = scale == "full"
                cells.append(Cell(
                    cell_id=f"collectives.{topo}.{kind}.{scale}",
                    figure="fig7", bench="collectives", engine="packet",
                    topology=topo, scale=scale, workload="collective",
                    workload_kw={"kind": kind, "m": 128 if full else 16,
                                 "total_mib": 8.0 if full else 1.0,
                                 "bg_pkts": 1024 if full else 256,
                                 "seed": 2},
                    n_ticks=1 << 18, spec_kw={"n_pkt_cap": 1 << 17},
                    tiers=tiers,
                    guards=(_G_NO_DOWN,
                            _g_counter("coll_done_frac", ">=", 0.99,
                                       scheme=SPRITZ_W))))
            cells.append(Cell(
                cell_id=f"incast.{topo}.{scale}",
                figure="fig8", bench="incast", engine="packet",
                topology=topo, scale=scale, workload="incast",
                workload_kw={"n_senders": 32 if scale == "full" else 8,
                             "size_mib": 4.0 if scale == "full" else 0.25,
                             "seed": 3},
                n_ticks=1 << 18, spec_kw={"n_pkt_cap": 1 << 17},
                tiers=tiers, guards=(_G_NO_DOWN,)))
            cells.append(Cell(
                cell_id=f"trace.{topo}.{scale}",
                figure="fig10_11", bench="trace", engine="packet",
                topology=topo, scale=scale, workload="websearch",
                workload_kw={"dur_us": 1000.0 if scale == "full" else 100.0,
                             "load": 1.0,
                             "max_flows": 20000 if scale == "full"
                             else 4000, "seed": 4},
                # ~8x the trace duration, as the legacy bench budgeted
                # (the horizon driver early-stops once all flows finish)
                n_ticks=(1 << 14) if scale == "small" else (1 << 17),
                spec_kw={"n_pkt_cap": 1 << 16},
                tiers=tiers, guards=(_G_NO_DOWN,)))
            size = 1024 if scale == "full" else 256
            for scen in ("static_links", "midrun_links", "flap_links",
                         "degraded_links"):
                guards = [_G_NO_DOWN, _G_NO_RATE]
                if scen == "midrun_links" and topo == "dragonfly":
                    guards.append(_g_ratio("postfail_fct_mean_us",
                                           SPRITZ_W, "ops_u", 1.0))
                fkw = {"frac": 0.02, "seed": 5}
                if scen == "degraded_links":
                    # bench_failures' brownout scenario: links at 1/4
                    # line rate over the mid-flight window
                    fkw = {"frac": 0.05, "rate": 0.25, "seed": 5}
                cells.append(Cell(
                    cell_id=f"failures.{topo}.{scen}.{scale}",
                    figure="fig9", bench="failures", engine="packet",
                    topology=topo, scale=scale, workload="permutation",
                    workload_kw={"size_pkts": size, "seed": 6},
                    schemes=FAILOVER_SCHEMES,
                    failure=scen, failure_kw=fkw,
                    n_ticks=1 << 18, spec_kw={"n_pkt_cap": 1 << 17},
                    tiers=tiers, guards=tuple(guards)))

    # memory model (Table IV): host-side, scheme-free
    for scale, tiers in (("small", ("ci",)), ("full", ("full",))):
        cells.append(Cell(
            cell_id=f"memory.multi.endpoint_memory.{scale}",
            figure="table4", bench="memory", engine="host",
            topology="dragonfly", scale=scale, workload="endpoint_memory",
            workload_kw={"n_pairs": 60, "seed": 0}, tiers=tiers,
            guards=(_g_counter("max_paths_per_pair", ">=", 2),)))

    # flow-level matrix: every scheme, quick configs nightly (guarded
    # against BENCH_fabric.json), paper configs in the full tier
    _FLOW_CFG = {
        "quick": {"train": {"n_chips": 256, "tp": 16, "shard": 4e6},
                  "alltoall": {"n_chips": 128, "tp": 16, "shard": 2e6}},
        "full": {"train": {"n_chips": None, "tp": 16, "shard": 32e6},
                 "alltoall": {"n_chips": 192, "tp": 16, "shard": 8e6}},
    }
    for topo in ("dragonfly1056", "slimfly1134"):
        for scale, tiers in (("quick", ("ci",)), ("full", ("full",))):
            for wname in ("train", "alltoall"):
                guards = []
                if scale == "quick":
                    guards += [_g_fabric_baseline(topo, wname, "done_frac",
                                                  abs_tol=0.02),
                               _g_fabric_baseline(topo, wname,
                                                  "fct_ratio_vs_ecmp",
                                                  tol=0.25)]
                cells.append(Cell(
                    cell_id=f"fabric.{topo}.{wname}.{scale}",
                    figure="fabric_scale", bench="fabric", engine="flow",
                    topology=topo, scale=scale, workload=wname,
                    workload_kw=_FLOW_CFG[scale][wname],
                    tiers=tiers, guards=tuple(guards)))
            guards = [_g_counter("forced", ">=", 1, scheme=SPRITZ_W)]
            if scale == "quick":
                guards += [_g_fabric_baseline(topo, "midrun_failure",
                                              "done_frac", abs_tol=0.02),
                           _g_fabric_baseline(topo, "midrun_failure",
                                              "fct_ratio_vs_ecmp",
                                              tol=0.25)]
            cells.append(Cell(
                cell_id=f"fabric.{topo}.midrun_failure.{scale}",
                figure="fabric_scale", bench="fabric", engine="flow",
                topology=topo, scale=scale, workload="train",
                workload_kw=_FLOW_CFG[scale]["train"],
                failure="loaded_midrun",
                failure_kw={"n_links": 8, "fail_at_frac": 4,
                            "recover_mult": 16},
                tiers=tiers, guards=tuple(guards)))

    # flow-level chaos tier: capacity masking at paper scale — the
    # loaded links brown out to 1/4 rate mid-run, and a seeded chaos
    # schedule stresses the whole fabric
    cells.append(Cell(
        cell_id="fabric.dragonfly1056.degraded.quick",
        figure="chaos_tier", bench="fabric", engine="flow",
        topology="dragonfly1056", scale="quick", workload="train",
        workload_kw=_FLOW_CFG["quick"]["train"],
        failure="loaded_degraded",
        failure_kw={"n_links": 8, "rate": 0.25, "fail_at_frac": 4,
                    "recover_mult": 16},
        schemes=FLOW_SMOKE_SCHEMES, tiers=("chaos",),
        guards=(_G_NO_RATE,
                _g_counter("done_frac", ">=", 0.999, scheme=SPRITZ_W),
                _g_ratio("fct_us", SPRITZ_W, "ecmp", 1.0)),
    ))
    # cross-engine validation (DESIGN.md §14): the same DF-1056 train
    # flow set through BOTH the flow-level and the packet engine, with
    # the per-scheme packet/flow mean-FCT ratio banded — the two
    # abstraction levels must agree within a calibrated factor
    cells.append(Cell(
        cell_id="fabric.dragonfly1056.cross.full",
        figure="fabric_scale", bench="fabric", engine="cross",
        topology="dragonfly1056", scale="quick", workload="train",
        workload_kw={"n_chips": 256, "tp": 16, "shard": 1e6},
        schemes=FLOW_SMOKE_SCHEMES, n_ticks=1 << 16,
        tiers=("full",),
        guards=(_G_NO_DOWN, _G_NO_RATE,
                _g_counter("flow_done_frac", ">=", 0.99),
                _g_counter("packet_done_frac", ">=", 0.99),
                _g_counter("xratio", ">=", 0.5),
                _g_counter("xratio", "<=", 2.0)),
    ))
    # ------------------------------------- open-loop serving sweeps
    # (DESIGN.md §15): Poisson websearch arrivals at 30/60/90% of
    # endpoint line rate, windowed steady-state metrics.  The smoke
    # cell runs the exact packet engine on the small Dragonfly,
    # segmented at every window boundary via checkpoint/resume; the
    # ci cell is the paper-instance DF-1056 sweep over every registry
    # scheme at flow fidelity, with the paper's headline load-curve
    # claim as a where-scoped ratio guard (spritz p99 <= ecmp p99 at
    # 90% load).  Sizes are capped (recorded here) so the drain
    # allowance that de-censors the steady percentiles stays bounded.
    cells.append(Cell(
        cell_id="serve.dragonfly.websearch.smoke",
        figure="load_sweep", bench="serve", engine="openloop",
        topology="dragonfly", scale="small", workload="poisson_websearch",
        workload_kw={"fidelity": "packet", "loads": (0.3, 0.6, 0.9),
                     "horizon_ticks": 512, "size_cap_pkts": 64,
                     "drain_ticks": 768,
                     "warmup_frac": 0.25, "window_frac": 0.25,
                     "seed": 4},
        schemes=FLOW_SMOKE_SCHEMES, spec_kw={"n_pkt_cap": 1 << 15},
        tiers=("smoke", "ci"),
        # the small fabric saturates near 90% offered load — the guard
        # asserts spritz keeps serving (observed 1.0 vs ecmp 0.93)
        # and beats ecmp's tail, not that the regime is sub-critical
        guards=(_G_NO_DOWN,
                _g_counter("steady_done_frac", ">=", 0.9,
                           scheme=SPRITZ_W, where={"load": 0.9}),
                _g_ratio("fct_p99_us", SPRITZ_W, "ecmp", 1.0,
                         where={"load": 0.9})),
    ))
    for scale, tiers, okw in (
            ("quick", ("ci",),
             {"horizon_ticks": 552, "size_cap_pkts": 512,
              "max_flows": 6000}),
            ("full", ("full",),
             {"horizon_ticks": 1104, "size_cap_pkts": 1024,
              "max_flows": 12000})):
        cells.append(Cell(
            cell_id=f"serve.dragonfly1056.websearch.{scale}",
            figure="load_sweep", bench="serve", engine="openloop",
            topology="dragonfly1056", scale=scale,
            workload="poisson_websearch",
            workload_kw=dict({"fidelity": "flow",
                              "loads": (0.3, 0.6, 0.9),
                              "warmup_frac": 0.25, "window_frac": 0.25,
                              "seed": 0, "max_paths": 32}, **okw),
            tiers=tiers,
            guards=(_G_NO_RATE,
                    _g_counter("steady_done_frac", ">=", 0.99,
                               scheme=SPRITZ_W, where={"load": 0.9}),
                    _g_ratio("fct_p99_us", SPRITZ_W, "ecmp", 1.0,
                             where={"load": 0.9}),
                    _g_ratio("fct_p99_us", SPRITZ_W, "ecmp", 1.0,
                             where={"load": 0.3})),
        ))
    cells.append(Cell(
        cell_id="fabric.dragonfly1056.chaos.quick",
        figure="chaos_tier", bench="fabric", engine="flow",
        topology="dragonfly1056", scale="quick", workload="train",
        workload_kw=_FLOW_CFG["quick"]["train"],
        failure="chaos",
        failure_kw={"seed": 11, "n_events": 5, "max_links": 3,
                    "horizon_mult": 4},
        schemes=FLOW_SMOKE_SCHEMES, tiers=("chaos",),
        guards=(_G_NO_RATE,
                _g_counter("done_frac", ">=", 0.999, scheme=SPRITZ_W)),
    ))
    return cells


CELLS: dict[str, Cell] = {}
for _c in _cells():
    if _c.cell_id in CELLS:
        raise ValueError(f"duplicate cell id {_c.cell_id}")
    CELLS[_c.cell_id] = _c
del _c


def cells(tier: str | None = None, ids=None, bench: str | None = None
          ) -> list[Cell]:
    """Select cells by tier, explicit id list, and/or owning bench."""
    out = list(CELLS.values())
    if tier is not None:
        out = [c for c in out if tier in c.tiers]
    if bench is not None:
        out = [c for c in out if c.bench == bench]
    if ids is not None:
        ids = list(ids)
        unknown = [i for i in ids if i not in CELLS]
        if unknown:
            raise KeyError(f"unknown cell ids: {unknown}; known: "
                           f"{sorted(CELLS)}")
        out = [c for c in out if c.cell_id in ids]
    return out


def figures(tier: str | None = None) -> set[str]:
    return {c.figure for c in cells(tier)}


def benches(tier: str | None = None) -> set[str]:
    return {c.bench for c in cells(tier)}
