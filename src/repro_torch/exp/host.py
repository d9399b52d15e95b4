"""Host-side analytic cells (no simulator run).  Port of
``repro.exp.host``.

Currently one kind: the paper's endpoint-table memory model (Table IV)
— bounded simple-path enumeration over sampled switch pairs plus the
3 B/EV-entry footprint formula.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net import paths as P
from repro_torch.net.topology.dragonfly import make_dragonfly
from repro_torch.net.topology.slimfly import make_slimfly


def max_paths_per_pair(topo, n_pairs: int = 60, seed: int = 0) -> int:
    rng = np.random.default_rng(seed)
    best = 0
    for _ in range(n_pairs):
        s, d = rng.integers(0, topo.n_switches, 2)
        if s == d:
            continue
        best = max(best, len(P.enumerate_paths(topo, int(s), int(d))))
    return best


def _memory_topos(scale: str):
    if scale == "full":
        return [make_dragonfly(4, 2, 2), make_dragonfly(6, 3, 3),
                make_dragonfly(8, 4, 4), make_slimfly(5), make_slimfly(9),
                make_slimfly(13)]
    return [make_dragonfly(4, 2, 2), make_dragonfly(6, 3, 3),
            make_slimfly(5, p=2)]


def run_host_cell(cell, schemes, seeds, verbose=True) -> list[dict]:
    """Host cells ignore schemes/seeds — the memory model is scheme-free
    (rows keep the schema's scheme/seed keys with '-'/0 placeholders)."""
    del schemes, seeds
    if cell.workload != "endpoint_memory":
        raise ValueError(f"{cell.cell_id}: unknown host workload "
                         f"{cell.workload!r}")
    rows = []
    for topo in _memory_topos(cell.scale):
        mp = max_paths_per_pair(topo, **dict(cell.workload_kw))
        rows.append({
            "topology": topo.name, "workload": cell.workload,
            "scheme": "-", "seed": 0,
            "endpoints": topo.n_endpoints,
            "switches": topo.n_switches,
            "max_paths_per_pair": mp,
            "endpoint_table_KiB":
                round(P.endpoint_table_bytes(topo, mp) / 1024, 1),
        })
        if verbose:
            print("   ", rows[-1], flush=True)
    return rows
