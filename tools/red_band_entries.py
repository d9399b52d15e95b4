"""Count, at each step of a DF-1056 permutation run, the fused rank +
RED/ECN launch's enqueued entries and those whose RED draw decides the
mark (accepted, 0 < pr < 1): the draws the launch makes in place.

    PYTHONPATH=src python tools/red_band_entries.py [--scheme ecmp]

The run is ``chip_smoke.py`` phase 4's (``data.CONFIG``), on the CPU
through the private eager loop, with kernels on (their plain versions);
the rank is recomputed with its plain version to find each entry's
occupancy.  A CPU count, not a device measurement; several minutes.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import data as GOLD
from repro_torch._parity import f32, red_recip
from repro_torch.kernels import ops
from repro_torch.kernels import ref as KREF
from repro_torch.net.sim import build as B
from repro_torch.net.sim import engine as E
from repro_torch.net.topology.dragonfly import make_dragonfly
from repro_torch.net.workloads.synthetic import permutation


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="spritz_spray_w")
    args = ap.parse_args()
    torch.set_num_threads(2)
    cfg = GOLD.CONFIG
    topo = make_dragonfly(8, 4, 4)
    spec = B.build_spec(topo, permutation(topo, size_pkts=32, seed=1),
                        args.scheme, n_ticks=cfg["n_ticks"])
    seen = []
    fused = ops.tick_rank_red_ecn

    def counted(port, enq, unif=None, q_tail=None, t=None, *, rng=None,
                qsize, kmin, kmax, n_ports):
        rank = KREF.tick_rank_reference(port, n_ports=n_ports)
        occ = (q_tail[port.clamp_max(n_ports - 1)] - t).clamp_min(0) + rank
        pr = ((occ.float() - f32(kmin)) * red_recip(kmin, kmax)).clamp(0, 1)
        band = enq & (occ < qsize) & (pr > 0) & (pr < 1)
        seen.append((port.shape[0], int(enq.sum()), int(band.sum())))
        return fused(port, enq, unif, q_tail, t, rng=rng, qsize=qsize,
                     kmin=kmin, kmax=kmax, n_ports=n_ports)
    ops.tick_rank_red_ecn = counted
    res = E._eager_run(spec, cfg["seed"], device="cpu")
    a = np.array(seen)
    print(f"{args.scheme}: {res.steps_executed} steps, M {a[0, 0]}; "
          f"enqueued a step mean {a[:, 1].mean():.1f}, max {a[:, 1].max()}; "
          f"in the RED band mean {a[:, 2].mean():.1f}, max {a[:, 2].max()} "
          f"(CPU count)")


if __name__ == "__main__":
    main()
