"""Cross-engine validation cell executor (DESIGN.md §14).  Port of
``repro.exp.cross``: both engines run on ``device``.

Runs ONE flow set — a fabric collective cell expanded by the bridge —
through BOTH simulation levels at paper scale: the flow-level engine
(``flowsim.simulate_batch``) and the exact packet engine
(``engine.run_batch`` over ``bridge.to_packet_flows``), with the same
endpoint path-table width on each side.  Every (scheme, seed) row then
carries both FCT means plus their in-session ratio ``xratio`` =
packet / flow mean FCT, the quantity the cell's counter guards band:
the two abstraction levels must stay within a calibrated factor of each
other, per scheme, or one of the engines drifted.

Wall time is recorded (``wall_s_flow`` / ``wall_s_packet``) but never
gated, like everywhere else in the matrix.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.exp.flow import MAX_PATHS
from repro_torch.exp.workloads import make_topology
from repro_torch.fabric import bridge
from repro_torch.fabric import flowsim as FS
from repro_torch.net.sim import build as B
from repro_torch.net.sim import engine as E
from repro_torch.net.topology.base import BYTES_PER_US


def run_cross_cell(cell, schemes, seeds, verbose=True,
                   device=None) -> list[dict]:
    """Materialize + execute one cross-engine cell on ``device``; flat
    metric rows."""
    topo = make_topology(cell.topology, cell.scale)
    kw = dict(cell.workload_kw)
    n_chips = kw.get("n_chips") or (topo.n_endpoints
                                    // kw["tp"]) * kw["tp"]
    flows = bridge.cell_flows(topo, cell.workload, kw["shard"],
                              n_chips=n_chips, tp=kw["tp"])
    if verbose:
        print(f"[exp/{cell.cell_id}] {len(flows)} flows through both "
              f"engines, {len(schemes)} schemes x {len(seeds)} seeds",
              flush=True)

    # flow level: one shared table, every scheme a lane
    t0 = time.time()
    table = FS.build_flow_table(topo, flows, max_paths=MAX_PATHS)
    per_scheme = FS.simulate_batch(topo, flows, list(schemes),
                                   seeds=list(seeds), table=table,
                                   max_paths=MAX_PATHS, device=device)
    wall_flow = round((time.time() - t0) / max(len(schemes), 1), 2)

    # packet level: the SAME flows (order-preserving lowering), the same
    # path-table width, one batched device program for the whole sweep
    t0 = time.time()
    base = B.build_spec(topo, bridge.to_packet_flows(flows), "spritz_spray_w",
                        n_ticks=cell.n_ticks or (1 << 16), seed=0,
                        max_paths=MAX_PATHS, **dict(cell.spec_kw))
    pkt = E.run_batch(base, schemes=list(schemes), seeds=list(seeds),
                      device=device)
    wall_pkt = round((time.time() - t0) / max(len(schemes), 1), 2)

    rows = []
    for si, name in enumerate(schemes):
        for ri, seed in enumerate(seeds):
            fres = per_scheme[name][ri]
            pres = pkt[si * len(seeds) + ri]
            fdone = fres.fct >= 0
            f_mean = (float(fres.fct[fdone].mean()) / BYTES_PER_US
                      if fdone.any() else -1.0)
            pfct = B.ticks_to_us(pres.fct_ticks[pres.done])
            p_mean = float(pfct.mean()) if pres.done.any() else -1.0
            row = {"topology": cell.topology, "workload": cell.workload,
                   "scheme": name, "seed": int(seed),
                   "flow_fct_mean_us": round(f_mean, 2),
                   "packet_fct_mean_us": round(p_mean, 2),
                   "xratio": (round(p_mean / f_mean, 3)
                              if f_mean > 0 and p_mean > 0 else -1.0),
                   "flow_done_frac": round(float(fdone.mean()), 4),
                   "packet_done_frac": round(float(np.mean(pres.done)), 4),
                   "down_violations": int(pres.down_violations),
                   "rate_violations": int(pres.rate_violations)
                   + int(fres.rate_violations),
                   "steps": int(pres.steps_executed),
                   "compression": round(pres.compression, 3),
                   "wall_s_flow": wall_flow, "wall_s_packet": wall_pkt,
                   "wall_s": wall_flow + wall_pkt}
            rows.append(row)
            if verbose:
                print("   ", row, flush=True)
    return rows
