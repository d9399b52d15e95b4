"""Experiment-matrix runner (DESIGN.md §13).  Port of ``repro.exp.runner``.

Dispatches selected cells through the port's executors (``packet``,
``openloop`` at packet fidelity, ``host``), emits one normalized JSON per
cell under ``results/exp_torch/`` keyed by the content hash of ``(cell
spec, git-tracked port sources)`` — unchanged cells are skipped on
re-run — and evaluates ratio/counter guards.  Any guard breach makes
:func:`run` report failure (the CLI exits non-zero).

Cells that need the flow-level engine (``flow``, ``cross`` and
flow-fidelity ``openloop``) are not ported yet (ROADMAP.md queue 1, item
5).  Named one by one they raise ``NotImplementedError``; a selection by
tier or bench lists them in :attr:`RunSummary.not_ported` and runs the
rest.

Packet cells run on ``device``: the card by default (raising, as
``engine.run`` does, when there is none), ``"cpu"`` on request.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

from repro_torch.exp import guards as G
from repro_torch.exp import matrix
from repro_torch.exp.hashing import cell_hash
from repro_torch.exp.openloop import FLOW_NOT_PORTED
from repro_torch.exp.spec import (RESULT_SCHEMA_VERSION, SCALES_BY_ENGINE,
                                  validate_result)
from repro_torch.net.sim import engine as E

DEFAULT_OUT = Path("results/exp_torch")


@dataclasses.dataclass
class CellResult:
    cell_id: str
    cached: bool
    rows: list
    guards: list
    wall_s: float
    path: Path

    @property
    def ok(self) -> bool:
        return all(g["ok"] for g in self.guards)


@dataclasses.dataclass
class RunSummary:
    results: list[CellResult]
    tier: str | None = None
    # selected cells the port cannot run yet (never counted as passed)
    not_ported: list[str] = dataclasses.field(default_factory=list)

    @property
    def breaches(self) -> list[str]:
        return [f"{r.cell_id}: {g['desc']} -> {g.get('value')} "
                f"({g.get('note', '')})"
                for r in self.results for g in r.guards if not g["ok"]]

    @property
    def cache_hits(self) -> int:
        return sum(r.cached for r in self.results)

    @property
    def rows(self) -> list[dict]:
        return [dict(row, cell_id=r.cell_id)
                for r in self.results for row in r.rows]

    @property
    def ok(self) -> bool:
        return not self.breaches


def ported(cell) -> bool:
    """Whether the port has the executor ``cell`` needs."""
    if cell.engine == "openloop":
        return dict(cell.workload_kw).get("fidelity", "flow") == "packet"
    return cell.engine in ("packet", "host")


def _resolve_schemes(cell):
    """() == every registered scheme, in registry order."""
    from repro_torch.net.policies import registry as REG
    if cell.schemes:
        return [REG.resolve(s).name for s in cell.schemes]
    return list(REG.names())


def _execute(cell, schemes, verbose, device):
    if cell.engine == "packet":
        from repro_torch.exp.packet import run_packet_cell
        return run_packet_cell(cell, schemes, list(cell.seeds),
                               verbose=verbose, device=device)
    if cell.engine == "openloop":
        from repro_torch.exp.openloop import run_openloop_cell
        return run_openloop_cell(cell, schemes, list(cell.seeds),
                                 verbose=verbose, device=device)
    from repro_torch.exp.host import run_host_cell
    return run_host_cell(cell, schemes, list(cell.seeds), verbose=verbose)


def run_cell(cell, out: Path = DEFAULT_OUT, force: bool = False,
             verbose: bool = True, device=None) -> CellResult:
    """Run (or cache-skip) one cell on ``device``; always (re-)evaluates
    guards so a guard edit is enforced even on a cached result — the hash
    covers the matrix source anyway, this is defense in depth."""
    if not ported(cell):
        raise NotImplementedError(f"{cell.cell_id}: {FLOW_NOT_PORTED}")
    device = E._device(device)     # raises without a card unless asked
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{cell.cell_id}.json"
    h = cell_hash(cell)
    schemes = _resolve_schemes(cell)

    if not force and path.is_file():
        try:
            prev = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            prev = None
        if prev and prev.get("hash") == h and not validate_result(prev):
            verdicts = G.evaluate(cell.guards, prev["rows"])
            if verbose:
                print(f"[exp] {cell.cell_id}: cache hit ({h[:12]})",
                      flush=True)
            return CellResult(cell.cell_id, True, prev["rows"], verdicts,
                              prev.get("wall_s", 0.0), path)

    t0 = time.time()
    rows = _execute(cell, schemes, verbose, device)
    wall = round(time.time() - t0, 2)
    verdicts = G.evaluate(cell.guards, rows)
    obj = {
        "schema": RESULT_SCHEMA_VERSION,
        "cell_id": cell.cell_id,
        "hash": h,
        "spec": cell.to_json(),
        "schemes_run": schemes,
        "rows": rows,
        "guards": verdicts,
        "wall_s": wall,
    }
    errs = validate_result(obj)
    if errs:
        raise RuntimeError(f"{cell.cell_id}: emitted result fails schema: "
                           f"{errs}")
    path.write_text(json.dumps(obj, indent=1))
    if verbose:
        status = "OK" if all(v["ok"] for v in verdicts) else "GUARD BREACH"
        print(f"[exp] {cell.cell_id}: {status} in {wall}s -> {path}",
              flush=True)
    return CellResult(cell.cell_id, False, rows, verdicts, wall, path)


def chaos_seed_cells(selected, chaos_seeds):
    """Re-roll every selected chaos cell over ``chaos_seeds``: each
    derived cell swaps the schedule seed in ``failure_kw`` and tags the
    id (``@cs<seed>``), so its result JSON — whose spec block records
    the seed — never collides with the registered cell's cache.  The
    registered fixed-seed cells stay in the selection; non-chaos cells
    pass through untouched."""
    out = []
    for c in selected:
        out.append(c)
        if c.failure != "chaos":
            continue
        for s in chaos_seeds:
            s = int(s)
            if s == int(dict(c.failure_kw).get("seed", 0)):
                continue
            fkw = dict(c.failure_kw)
            fkw["seed"] = s
            out.append(dataclasses.replace(
                c, failure_kw=fkw, cell_id=f"{c.cell_id}@cs{s}"))
    return out


def run(tier: str | None = None, cells=None, bench: str | None = None,
        schemes=None, seeds=None, scale: str | None = None,
        chaos_seeds=None, out: Path = DEFAULT_OUT, force: bool = False,
        check: bool = False, verbose: bool = True,
        device=None) -> RunSummary:
    """Run a cell selection on ``device``.  ``schemes``/``seeds``/``scale``
    derive overridden cells (rewritten ids — they never pollute the
    registered cells' cache entries); ``chaos_seeds`` additionally
    re-rolls chaos cells over extra schedule seeds.  ``check=True``
    raises ``SystemExit`` on any guard breach; the CLI instead exits via
    the returned summary.  A cell named in ``cells`` that the port cannot
    run raises ``NotImplementedError``; one selected by ``tier`` or
    ``bench`` alone goes to ``RunSummary.not_ported``."""
    device = E._device(device)
    selected = matrix.cells(tier=tier, ids=cells, bench=bench)
    if not selected:
        raise SystemExit(f"no cells selected (tier={tier}, cells={cells}, "
                         f"bench={bench})")
    not_ported = [c.cell_id for c in selected if not ported(c)]
    if not_ported and cells is not None:
        raise NotImplementedError(f"{', '.join(not_ported)}: "
                                  f"{FLOW_NOT_PORTED}")
    selected = [c for c in selected if ported(c)]
    if verbose and not_ported:
        print(f"[exp] not ported yet: {', '.join(not_ported)}", flush=True)
    if chaos_seeds:
        selected = chaos_seed_cells(selected, chaos_seeds)
    if schemes is not None or seeds is not None or scale is not None:
        # a scale override only applies where the engine's topology
        # table understands BOTH the requested and the registered scale
        selected = [
            c.with_overrides(
                schemes=schemes, seeds=seeds,
                scale=scale if (scale in SCALES_BY_ENGINE[c.engine]
                                and c.scale in SCALES_BY_ENGINE[c.engine])
                else None)
            for c in selected]
    results = [run_cell(c, out=out, force=force, verbose=verbose,
                        device=device)
               for c in selected]
    summary = RunSummary(results, tier=tier, not_ported=not_ported)
    if verbose:
        print(f"[exp] {len(results)} cells, {summary.cache_hits} cached, "
              f"{len(summary.breaches)} guard breaches, "
              f"{len(not_ported)} not ported", flush=True)
        for b in summary.breaches:
            print(f"[exp] BREACH {b}", flush=True)
    if check and summary.breaches:
        raise SystemExit("experiment-matrix guard breach: "
                         + "; ".join(summary.breaches))
    return summary
