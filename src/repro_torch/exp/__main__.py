"""CLI for the port's experiment matrix (DESIGN.md §13).

::

    python -m repro_torch.exp run --tier smoke       # on the card
    python -m repro_torch.exp run --cells engine.dragonfly.probe.smoke \
        --device cpu                                  # plain versions
    python -m repro_torch.exp run --cells micro.dragonfly.adversarial.smoke \
        --schemes ecmp,spritz_spray_w --force
    python -m repro_torch.exp list --tier smoke

Exit code is non-zero on any ratio/counter guard breach.  Unchanged
cells (same spec + same git-tracked port sources) are cache hits.  A
tier selection lists the cells the port cannot run yet ("not ported
yet: …") and runs the rest; naming one with ``--cells`` raises.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.exp import matrix, runner
from repro_torch.exp.spec import TIERS


def _csv(arg):
    return [s for s in arg.split(",") if s] if arg else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.exp")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run matrix cells")
    rp.add_argument("--tier", choices=TIERS, default=None)
    rp.add_argument("--cells", default=None,
                    help="comma-separated cell ids (see `list`)")
    rp.add_argument("--bench", default=None,
                    help="select by owning bench module (micro, engine, …)")
    rp.add_argument("--schemes", default=None,
                    help="comma-separated registry scheme names override")
    rp.add_argument("--seeds", default=None,
                    help="comma-separated integer seeds override")
    rp.add_argument("--scale", default=None,
                    choices=["small", "mid", "full", "quick"],
                    help="scale override (derives new cell ids)")
    rp.add_argument("--chaos-seeds", default=None,
                    help="comma-separated extra schedule seeds: every "
                         "selected chaos cell is re-rolled per seed "
                         "(seeds are recorded in the result JSONs)")
    rp.add_argument("--out", default=str(runner.DEFAULT_OUT))
    rp.add_argument("--force", action="store_true",
                    help="ignore cached results")
    rp.add_argument("--device", default=None,
                    help="torch device (default: the card; `cpu` runs "
                         "the kernels' plain versions)")
    rp.add_argument("--quiet", action="store_true")

    lp = sub.add_parser("list", help="list registered cells")
    lp.add_argument("--tier", choices=TIERS, default=None)
    lp.add_argument("--bench", default=None)

    args = ap.parse_args(argv)

    if args.cmd == "list":
        for c in matrix.cells(tier=args.tier, bench=args.bench):
            schemes = "all" if not c.schemes else len(c.schemes)
            print(f"{c.cell_id:48s} {c.engine:8s} {c.topology:14s} "
                  f"tiers={','.join(c.tiers):12s} schemes={schemes} "
                  f"guards={len(c.guards)} "
                  f"{'ported' if runner.ported(c) else 'not ported'}")
        return 0

    seeds = [int(s) for s in _csv(args.seeds)] if args.seeds else None
    chaos_seeds = [int(s) for s in _csv(args.chaos_seeds)] \
        if args.chaos_seeds else None
    summary = runner.run(
        tier=args.tier, cells=_csv(args.cells), bench=args.bench,
        schemes=_csv(args.schemes), seeds=seeds, scale=args.scale,
        chaos_seeds=chaos_seeds, out=Path(args.out), force=args.force,
        verbose=not args.quiet, device=args.device)
    return 1 if summary.breaches else 0


if __name__ == "__main__":
    sys.exit(main())
