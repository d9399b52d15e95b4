"""Open-loop serving cell executor (DESIGN.md §15).  Port of
``repro.exp.openloop``.

Runs an offered-load sweep cell: per load point a Poisson arrival
stream (``repro_torch.net.arrivals``) is compiled once and every
registry scheme serves it, with windowed steady-state measurement
(``repro_torch.net.steady``) replacing run-to-drain accounting.  Two
fidelities share one row schema, and both run on ``device``:

* ``fidelity="flow"`` — the paper-scale path: the stream's
  :class:`~repro_torch.fabric.flowsim.FlowSpec` set through the
  water-filling engine, stopped at the serving horizon via ``t_end``
  (plus a drain allowance so steady percentiles are not
  censoring-biased).
* ``fidelity="packet"`` — the exact-engine path: the stream rides the
  port's packet engine, **segmented at every window boundary via
  checkpoint/resume** (``engine.run_batch(…, until_tick, resume)``,
  bit-identical to one unsegmented run), harvesting a per-port
  queue-depth snapshot from each checkpoint's carry.  Each lane's spec
  keeps its loop between segments, so the card captures its step once
  and replays the same graph in every segment.

Rows are per ``(scheme, seed, load)``; FCT stats are microseconds with
:data:`repro_torch.net.steady.EMPTY` (-1.0) for empty samples — never
NaN — and ``goodput_frac`` normalizes delivered volume to a fraction of
aggregate endpoint line rate.  Guards scope to one load point via the
``where`` row filter (``{"where": {"load": 0.9}}``).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.exp.workloads import make_topology
from repro_torch.net.arrivals import poisson_stream
from repro_torch.net.sim import build as B
from repro_torch.net.sim import engine as E
from repro_torch.net.sim.types import SPRAY_W
from repro_torch.net.steady import queue_depth_ticks, window_stats
from repro_torch.net.topology.base import BYTES_PER_TICK, BYTES_PER_US


def _kw(cell) -> dict:
    """Normalize ``workload_kw`` (documented in EXPERIMENTS.md):
    ``loads`` (sweep points), ``horizon_ticks`` (serving horizon),
    ``warmup_frac``/``window_frac`` (steady-state measurement),
    ``drain_ticks`` (post-horizon completion allowance; default six
    size-caps so the capped elephant tail de-censors), plus the
    ``poisson_stream`` parameters."""
    kw = dict(cell.workload_kw)
    cap = kw.get("size_cap_pkts")
    out = {
        "fidelity": kw.get("fidelity", "flow"),
        "loads": tuple(kw.get("loads", (0.3, 0.6, 0.9))),
        "horizon_ticks": int(kw.get("horizon_ticks", 512)),
        "seed": int(kw.get("seed", 0)),
        "size": kw.get("size", "websearch"),
        "size_cap_pkts": int(cap) if cap is not None else None,
        "max_flows": (int(kw["max_flows"])
                      if kw.get("max_flows") is not None else None),
        "warmup_frac": float(kw.get("warmup_frac", 0.25)),
        "window_frac": float(kw.get("window_frac", 0.25)),
        "max_paths": int(kw.get("max_paths", 32)),
    }
    drain = kw.get("drain_ticks")
    if drain is None:
        drain = 6 * (out["size_cap_pkts"] or out["horizon_ticks"])
    out["drain_ticks"] = int(drain)
    return out


def _stream_for(topo, kw, load):
    return poisson_stream(
        topo, load=load, horizon_ticks=kw["horizon_ticks"],
        seed=kw["seed"], size=kw["size"],
        size_cap_pkts=kw["size_cap_pkts"], max_flows=kw["max_flows"])


def _steady_fields(ws, n_eps, to_us, goodput_unit) -> dict:
    """Flatten a ``window_stats`` result into row fields: steady-block
    stats in us (sentinels pass through unscaled), ``goodput_frac`` of
    aggregate line rate, and the per-window series."""
    def us(v):
        return round(v * to_us, 3) if v >= 0 else -1.0

    st = ws["steady"]
    row = {
        "fct_p50_us": us(st["fct_p50"]),
        "fct_p99_us": us(st["fct_p99"]),
        "fct_p999_us": us(st["fct_p999"]),
        "fct_mean_us": us(st["fct_mean"]),
        "goodput_frac": round(st["goodput"] / (n_eps * goodput_unit), 4),
        "steady_done_frac": (round(st["done_frac"], 4)
                             if st["done_frac"] >= 0 else -1.0),
        "censored": int(st["censored"]),
        "steady_arrivals": int(st["n_arrivals"]),
        "windows": [
            {"t0_us": round(w["t0"] * to_us, 2),
             "t1_us": round(w["t1"] * to_us, 2),
             "n_done": w["n_done"],
             "fct_p50_us": us(w["fct_p50"]),
             "fct_p99_us": us(w["fct_p99"]),
             "fct_p999_us": us(w["fct_p999"]),
             "goodput_frac": round(w["goodput"]
                                   / (n_eps * goodput_unit), 4)}
            for w in ws["windows"]],
    }
    return row


# per-process memo of (specs, FlowTable, wall) per (topology workload
# stream) key — path enumeration dominates flow-level setup at paper
# scale and every scheme lane of a load point shares the table
_TABLE_MEMO: dict = {}


def _run_flow(cell, schemes, seeds, kw, topo, verbose,
              device=None) -> list[dict]:
    from repro_torch.fabric import flowsim as FS
    rows = []
    n_eps = topo.n_endpoints
    for load in kw["loads"]:
        stream = _stream_for(topo, kw, load)
        key = (cell.topology, cell.scale,
               tuple(sorted(dict(cell.workload_kw).items())), load)
        if key not in _TABLE_MEMO:
            specs = stream.to_flowspecs()
            t0 = time.time()
            table = FS.build_flow_table(topo, specs,
                                        max_paths=kw["max_paths"])
            _TABLE_MEMO[key] = (specs, table, round(time.time() - t0, 2))
        specs, table, table_wall = _TABLE_MEMO[key]
        hz = stream.horizon_ticks
        t_end = float(hz + kw["drain_ticks"]) * BYTES_PER_TICK
        start = np.asarray([f.start for f in specs])
        size = np.asarray([f.size_bytes for f in specs])
        if verbose:
            print(f"[exp/{cell.cell_id}] load={load}: {stream.n_flows} "
                  f"flows over {hz} ticks "
                  f"(offered {stream.offered_load(n_eps):.3f})",
                  flush=True)
        for name in schemes:
            for seed in seeds:
                t0 = time.time()
                res = FS.simulate(topo, specs, name, seed=int(seed),
                                  table=table, max_paths=kw["max_paths"],
                                  t_end=t_end, device=device)
                wall = round(time.time() - t0, 2)
                ws = window_stats(
                    start, np.asarray(res.fct), size,
                    warmup=kw["warmup_frac"] * hz * BYTES_PER_TICK,
                    window=kw["window_frac"] * hz * BYTES_PER_TICK,
                    horizon=float(hz) * BYTES_PER_TICK)
                row = {"topology": cell.topology, "workload": cell.workload,
                       "scheme": name, "seed": int(seed),
                       "load": float(load),
                       "offered_load": round(stream.offered_load(n_eps), 4),
                       "n_flows": stream.n_flows,
                       "epochs": int(res.epochs),
                       "reselections": int(res.reselections),
                       "rate_violations": int(res.rate_violations),
                       "wall_s": wall, "table_wall_s": table_wall}
                row.update(_steady_fields(ws, n_eps, 1.0 / BYTES_PER_US,
                                          goodput_unit=1.0))
                rows.append(row)
                if verbose:
                    print("   ", {k: v for k, v in row.items()
                                  if k != "windows"}, flush=True)
    return rows


def _run_packet(cell, schemes, seeds, kw, topo, verbose,
                device=None) -> list[dict]:
    rows = []
    n_eps = topo.n_endpoints
    to_us = float(B.ticks_to_us(1.0))
    for load in kw["loads"]:
        stream = _stream_for(topo, kw, load)
        flows = stream.to_packet_flows()
        hz = stream.horizon_ticks
        n_ticks = cell.n_ticks or (hz + kw["drain_ticks"])
        spec = B.build_spec(topo, flows, SPRAY_W, n_ticks=n_ticks,
                            seed=kw["seed"], **dict(cell.spec_kw))
        warmup = int(kw["warmup_frac"] * hz)
        window = max(int(kw["window_frac"] * hz), 1)
        # segment the long-horizon run at every window boundary via
        # checkpoint/resume (bit-identical to one unsegmented call —
        # DESIGN.md §15) and snapshot queue depth at each boundary
        bounds = list(range(warmup + window, hz + 1, window))
        if verbose:
            print(f"[exp/{cell.cell_id}] load={load}: {stream.n_flows} "
                  f"flows over {hz} ticks "
                  f"(offered {stream.offered_load(n_eps):.3f}), "
                  f"{len(bounds) + 1} segments", flush=True)
        t0 = time.time()
        cps = None
        depth_snaps: list[list[dict]] = [
            [] for _ in range(len(schemes) * len(seeds))]
        for b in bounds + [None]:
            results, states = E.run_batch(
                spec, schemes=list(schemes), seeds=list(seeds),
                until_tick=b, resume=cps, return_carry=True, device=device)
            if b is not None:
                for li, (res, st) in enumerate(zip(results, states)):
                    depth_snaps[li].append(queue_depth_ticks(
                        st["q_tail"], res.ticks_simulated))
            cps = [E.checkpoint(r, s)
                   for r, s in zip(results, states)]
        wall = round(time.time() - t0, 2)
        start = np.asarray([f.start_tick for f in flows])
        sizes = np.asarray(stream.size_pkts, np.float64)
        for li, res in enumerate(results):
            name = schemes[li // len(seeds)]
            seed = seeds[li % len(seeds)]
            ws = window_stats(start, res.fct_ticks, sizes,
                              warmup=warmup, window=window, horizon=hz)
            snaps = depth_snaps[li]
            row = {"topology": cell.topology, "workload": cell.workload,
                   "scheme": name, "seed": int(seed),
                   "load": float(load),
                   "offered_load": round(stream.offered_load(n_eps), 4),
                   "n_flows": stream.n_flows,
                   "ticks": int(res.ticks_simulated),
                   "steps": int(res.steps_executed),
                   "down_violations": int(res.down_violations),
                   "rate_violations": int(res.rate_violations),
                   "qdepth_mean": round(float(np.mean(
                       [s["mean"] for s in snaps])), 2) if snaps else -1.0,
                   "qdepth_p99": round(float(np.max(
                       [s["p99"] for s in snaps])), 2) if snaps else -1.0,
                   "qdepth_max": round(float(np.max(
                       [s["max"] for s in snaps])), 2) if snaps else -1.0,
                   "wall_s": round(wall / max(len(results), 1), 2)}
            row.update(_steady_fields(ws, n_eps, to_us, goodput_unit=1.0))
            rows.append(row)
            if verbose:
                print("   ", {k: v for k, v in row.items()
                              if k != "windows"}, flush=True)
    return rows


def run_openloop_cell(cell, schemes, seeds, verbose=True,
                      device=None) -> list[dict]:
    """Materialize + execute one open-loop serving cell; flat rows."""
    kw = _kw(cell)
    topo = make_topology(cell.topology, cell.scale)
    if kw["fidelity"] == "packet":
        return _run_packet(cell, schemes, seeds, kw, topo, verbose, device)
    if kw["fidelity"] != "flow":
        raise ValueError(f"{cell.cell_id}: unknown openloop fidelity "
                         f"{kw['fidelity']!r}")
    return _run_flow(cell, schemes, seeds, kw, topo, verbose, device)
