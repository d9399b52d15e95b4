"""Packet-engine cell executor (DESIGN.md §13).  Port of
``repro.exp.packet``.

Runs a matrix cell through the port's batched packet driver
(``engine.run_batch``: every scheme x seed a lane through the engine's
loop, the lanes of one spec sharing its captured graph on the card) and
normalizes per-lane results into flat metric rows, the reference's rows
field for field.  ``device`` goes through to the engine: the card by
default, ``"cpu"`` for the kernels' plain versions.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.exp.workloads import (build_failure, build_workload,
                                       make_topology)
from repro_torch.net.policies import registry as REG
from repro_torch.net.sim import build as B
from repro_torch.net.sim import engine as E
from repro_torch.net.sim.types import SCHEME_NAMES, SPRAY_W
from repro_torch.net.workloads.collectives import collective_duration


def fct_stats(res, mask=None, prefix=""):
    """Completed-flow FCT statistics over ``mask``.  Empty samples emit
    the explicit ``-1.0`` sentinel (``repro_torch.net.steady.EMPTY``), never
    NaN — guards fail on present-but-sentinel metrics."""
    sel = np.ones(len(res.fct_ticks), bool) if mask is None else mask
    fct = B.ticks_to_us(res.fct_ticks[sel])
    done = res.done[sel]

    def pct(q):
        return float(np.percentile(fct[done], q)) if done.any() else -1.0

    return {
        f"{prefix}done_frac": float(done.mean()) if sel.any() else -1.0,
        f"{prefix}fct_mean_us": (float(fct[done].mean())
                                 if done.any() else -1.0),
        f"{prefix}fct_p50_us": pct(50),
        f"{prefix}fct_p99_us": pct(99),
        f"{prefix}fct_p999_us": pct(99.9),
        f"{prefix}trims": int(res.trims[sel].sum()),
        f"{prefix}timeouts": int(res.timeouts[sel].sum()),
        f"{prefix}retx": int(res.retx[sel].sum()),
        f"{prefix}ooo_pct": float(100 * res.ooo[sel].sum()
                                  / max(res.delivered[sel].sum(), 1)),
    }


def completed_after(res, flows, tick):
    """Mask of flows whose completion tick lies after virtual ``tick`` —
    feed to ``fct_stats(res, mask)`` for post-failure FCT slices.  A flow
    that never finished counts as 'after' (it was still running)."""
    start = np.asarray([f.start_tick for f in flows])
    return ~res.done | (start + res.fct_ticks > tick)


def run_schemes(topo, flows, schemes, *, n_ticks, seeds=(0,), seed=0,
                stop_flows=None, masks=None, spec_kw=None, postfail_tick=None,
                collective=False, with_dense_ref=False, verbose=True,
                device=None):
    """Run every scheme x seed over one flow set as one ``run_batch``
    call on ``device``; returns ``[(row, SimResult)]`` scheme-major,
    seed-minor.

    The spec (paths, ports, latencies) is built once with a weighted
    base scheme; per-scheme lanes derive their weights/static paths
    inside ``engine.run_batch``.  ``seed`` seeds the spec build (path
    draws), ``seeds`` the engine lanes.  ``with_dense_ref=True``
    additionally times the dense tick-by-tick reference per scheme and
    reports the (in-session normalized, hence gateable) ratio
    ``dense_speedup``."""
    schemes = [REG.as_code(s) for s in schemes]
    base = B.build_spec(topo, flows, SPRAY_W, n_ticks=n_ticks, seed=seed,
                        **(spec_kw or {}))
    t0 = time.time()
    results = E.run_batch(base, schemes=schemes, seeds=list(seeds),
                          stop_flows=stop_flows, device=device)
    wall = time.time() - t0
    starts = np.asarray([f.start_tick for f in flows])
    rows = []
    for li, res in enumerate(results):
        scheme = schemes[li // len(seeds)]
        row = {"topology": topo.name, "scheme": SCHEME_NAMES[scheme],
               "seed": int(seeds[li % len(seeds)]),
               "wall_s": round(wall / max(len(results), 1), 2),
               "steps": int(res.steps_executed),
               "ticks": int(res.ticks_simulated),
               "compression": round(res.compression, 3),
               "down_violations": int(res.down_violations),
               "rate_violations": int(res.rate_violations)}
        row.update(fct_stats(res))
        for name, m in (masks or {}).items():
            row.update(fct_stats(res, m, prefix=f"{name}_"))
        if postfail_tick is not None:
            row.update(fct_stats(res, completed_after(res, flows,
                                                      postfail_tick),
                                 prefix="postfail_"))
        if collective and masks and "coll" in masks:
            dur = collective_duration(res.fct_ticks, starts, masks["coll"])
            row["coll_duration_us"] = (float(B.ticks_to_us(dur))
                                       if dur >= 0 else -1)
        if with_dense_ref:
            lane = B.respec_scheme(base, scheme)
            sd = int(seeds[li % len(seeds)])
            warm, dense = _warm_pair(lane, sd, stop_flows, device)
            row["wall_s_dense_warm"] = round(dense, 2)
            row["dense_speedup"] = round(dense / max(warm, 1e-9), 2)
        rows.append((row, res))
        if verbose:
            print("   ", {k: v for k, v in row.items()
                          if not isinstance(v, float) or abs(v) < 1e7},
                  flush=True)
    return rows


def _warm_pair(spec, seed, stop_flows, device, reps: int = 2):
    """Best-of-``reps`` warm wall time for the compressed driver and the
    dense reference on one spec — their *ratio* is machine-independent
    and therefore the only wall-derived quantity guards may gate."""
    warm = dense = float("inf")
    for reference in (False, True):
        E.run(spec, seed=seed, stop_flows=stop_flows, reference=reference,
              device=device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            E.run(spec, seed=seed, stop_flows=stop_flows,
                  reference=reference, device=device)
            best = min(best, time.time() - t0)
        if reference:
            dense = best
        else:
            warm = best
    return warm, dense


def run_packet_cell(cell, schemes, seeds, verbose=True,
                    device=None) -> list[dict]:
    """Materialize + execute one packet cell; returns flat metric rows."""
    topo = make_topology(cell.topology, cell.scale)
    wl = build_workload(cell, topo)
    fail = build_failure(cell, topo)
    spec_kw = dict(cell.spec_kw)
    spec_kw.update(fail.spec_kw)
    # pseudo spec_kw consumed here, not by build_spec: opt into the
    # dense-reference timing pair (its ratio is gateable, DESIGN.md §13)
    with_dense_ref = bool(spec_kw.pop("with_dense_ref", False))
    # pseudo spec_kw: additionally sweep the SAME workload with no
    # failure plan and report per-(scheme, seed) ``degrade_ratio`` =
    # degraded / healthy mean FCT — the graceful-degradation signal the
    # chaos-tier counter guards gate (in-session ratio, never wall time)
    with_healthy_ref = bool(spec_kw.pop("with_healthy_ref", False))
    if verbose:
        print(f"[exp/{cell.cell_id}] {len(wl.flows)} flows, "
              f"{len(schemes)} schemes x {len(seeds)} seeds", flush=True)
    got = run_schemes(
        topo, wl.flows, schemes, n_ticks=cell.n_ticks or (1 << 17),
        seeds=seeds, stop_flows=wl.stop_flows, masks=wl.masks,
        spec_kw=spec_kw, postfail_tick=fail.t_fail,
        collective=wl.collective, with_dense_ref=with_dense_ref,
        verbose=verbose, device=device)
    if with_healthy_ref:
        # healthy baseline: same flows/schemes/seeds, failure-free spec
        # (cell.spec_kw only — no plan, no static link mask)
        h_kw = {k: v for k, v in dict(cell.spec_kw).items()
                if k not in ("with_dense_ref", "with_healthy_ref",
                             "failure_plan", "failed_links")}
        healthy = run_schemes(
            topo, wl.flows, schemes, n_ticks=cell.n_ticks or (1 << 17),
            seeds=seeds, stop_flows=wl.stop_flows, masks=wl.masks,
            spec_kw=h_kw, collective=wl.collective, verbose=False,
            device=device)
        for (row, _), (hrow, _) in zip(got, healthy):
            assert (row["scheme"], row["seed"]) == (hrow["scheme"],
                                                    hrow["seed"])
            row["healthy_fct_mean_us"] = hrow["fct_mean_us"]
            if hrow["fct_mean_us"] <= 0:
                row["degrade_ratio"] = -1.0      # healthy ref broken: no verdict
            elif row["fct_mean_us"] <= 0:
                row["degrade_ratio"] = 1e9       # collapsed: fails any <= bound
            else:
                row["degrade_ratio"] = round(
                    row["fct_mean_us"] / hrow["fct_mean_us"], 3)
    rows = []
    for row, _res in got:
        row["workload"] = cell.workload
        if cell.failure:
            row["scenario"] = cell.failure
        rows.append(row)
    return rows
