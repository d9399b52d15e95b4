"""Guard evaluation for experiment cells (DESIGN.md §13).  Port of
``repro.exp.guards``.

Guards turn a cell's metric rows into pass/fail verdicts expressed
**only as ratios and counters** — never absolute wall time.  Kinds:

* ``counter`` — bound one metric per row: ``{"kind": "counter",
  "metric": "down_violations", "op": "==", "value": 0}`` (optionally
  scoped to one ``scheme``; a metric prefix like ``postfail_`` is part
  of the metric name).
* ``ratio`` — seed-averaged metric of scheme ``num`` over scheme
  ``den`` within the same cell: ``{"kind": "ratio", "metric":
  "fct_mean_us", "num": "spritz_spray_w", "den": "ecmp", "op": "<=",
  "value": 1.0}``.
* ``baseline`` — one scalar from a checked-in repo-root baseline JSON
  (``file`` + dotted ``path``) vs the row metric, within relative
  ``tol``; ``dir`` picks the failing direction ("max": value may not
  exceed base*(1+tol), "min": may not fall below base*(1-tol)).
* ``baseline_schemes`` — a per-scheme map in the baseline JSON
  (``path`` ends at a ``schemes`` dict): every scheme actually run is
  compared on ``metric`` within relative ``tol`` (or absolute
  ``abs_tol``); schemes absent from the baseline are skipped, so a
  narrowed ``--schemes`` run guards only what it ran.

Every kind accepts an optional ``where`` mapping — an equality row
filter applied before evaluation (``{"where": {"load": 0.9}}`` scopes
a guard to one point of an offered-load sweep, DESIGN.md §15).

**Sentinel discipline.**  Executors emit the explicit ``-1.0`` sentinel
(:data:`repro_torch.net.steady.EMPTY`) — never NaN — when a statistic has no
data (e.g. the completed-flow filter matched nothing).  Guards treat a
metric that is *present but sentinel/NaN on every row of a scheme that
ran* as a hard failure, not a skip: an empty FCT sample under a ratio
guard means the scheme collapsed, and silently passing would hide
exactly the regressions the guard exists to catch (regression-pinned
by ``tests/test_torch_exp.py``).  Skips remain only for schemes genuinely
absent from a narrowed ``--schemes`` run.
"""
from __future__ import annotations

import json
import math
import operator
from pathlib import Path

from repro_torch.exp.hashing import repo_root

_OPS = {"==": operator.eq, "<=": operator.le, ">=": operator.ge,
        "<": operator.lt, ">": operator.gt}


def _rows_where(rows, g):
    """Apply the guard's optional ``where`` equality filter."""
    where = g.get("where")
    if not where:
        return rows
    return [r for r in rows
            if all(r.get(k) == v for k, v in where.items())]


def _metric_vals(rows, scheme, metric):
    """Split a scheme's metric column into (valid values, n_invalid).

    Valid = finite and non-negative; NaN and the ``-1.0`` empty-stats
    sentinel count as *invalid but present* — the distinction between
    "scheme not run" (skip) and "scheme ran and produced no data"
    (fail)."""
    vals, invalid = [], 0
    for r in rows:
        if r.get("scheme") != scheme or metric not in r:
            continue
        v = r[metric]
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and math.isfinite(v) and v >= 0:
            vals.append(v)
        else:
            invalid += 1
    return vals, invalid


def _mean_metric(rows, scheme, metric):
    vals, _ = _metric_vals(rows, scheme, metric)
    return sum(vals) / len(vals) if vals else None


def _load_baseline(file: str, path: str):
    p = Path(repo_root()) / file
    if not p.is_file():
        return None, f"baseline file {file} missing"
    obj = json.loads(p.read_text())
    for key in path.split("."):
        if not isinstance(obj, dict) or key not in obj:
            return None, f"baseline path {path} missing in {file}"
        obj = obj[key]
    return obj, None


def _eval_counter(g, rows):
    op = _OPS[g.get("op", "==")]
    bound = g["value"]
    metric = g["metric"]
    if g.get("scheme") and not _ran(rows, g["scheme"]):
        return dict(ok=True, value=None,
                    note=f"skipped: {g['scheme']} not in this run")
    rows = _rows_where(rows, g)
    sel = [r for r in rows
           if metric in r and (g.get("scheme") is None
                               or r.get("scheme") == g["scheme"])]
    if not sel:
        return dict(ok=False, value=None,
                    note=f"no rows carry metric {metric!r}")
    bad = [r for r in sel if not op(r[metric], bound)]
    worst = (max if g.get("op", "==") in ("<=", "<", "==") else min)(
        (r[metric] for r in sel))
    return dict(ok=not bad, value=worst,
                note=(f"{len(bad)}/{len(sel)} rows breach"
                      if bad else f"{len(sel)} rows OK"))


def _ran(rows, scheme):
    return any(r.get("scheme") == scheme for r in rows)


def _eval_ratio(g, rows):
    # a narrowed --schemes run guards only what it ran: a ratio whose
    # endpoint scheme was not part of this invocation is skipped, not
    # failed (the registered cell still enforces it on full CI runs)
    skipped = [s for s in (g["num"], g["den"]) if not _ran(rows, s)]
    if skipped:
        return dict(ok=True, value=None,
                    note=f"skipped: {','.join(skipped)} not in this run")
    rows = _rows_where(rows, g)
    parts = {}
    for side in ("num", "den"):
        vals, invalid = _metric_vals(rows, g[side], g["metric"])
        if not vals:
            # the scheme RAN — a missing or all-sentinel column is a
            # failure, never a silent pass
            why = (f"{invalid} sentinel/NaN values" if invalid
                   else "metric missing")
            return dict(ok=False, value=None,
                        note=f"{g[side]}: {why} for {g['metric']!r}")
        parts[side] = sum(vals) / len(vals)
    if parts["den"] == 0:
        return dict(ok=False, value=None,
                    note=f"zero denominator {g['den']}:{g['metric']}")
    ratio = parts["num"] / parts["den"]
    return dict(ok=bool(_OPS[g.get("op", "<=")](ratio, g["value"])),
                value=round(ratio, 4))


def _within(cur, base, tol):
    if base == 0:
        return cur == 0
    return abs(cur - base) <= tol * abs(base)


def _eval_baseline(g, rows):
    if g.get("scheme") and not _ran(rows, g["scheme"]):
        return dict(ok=True, value=None,
                    note=f"skipped: {g['scheme']} not in this run")
    base, err = _load_baseline(g["file"], g["path"])
    if err:
        return dict(ok=False, value=None, note=err)
    rows = _rows_where(rows, g)
    val = _mean_metric(rows, g.get("scheme"), g["metric"]) \
        if g.get("scheme") else _mean_metric(
            rows, rows[0].get("scheme") if rows else None, g["metric"])
    if val is None:
        return dict(ok=False, value=None,
                    note=f"metric {g['metric']!r} missing")
    tol = g.get("tol", 0.25)
    if g.get("dir", "max") == "max":
        ok = val <= base * (1 + tol)
    else:
        ok = val >= base * (1 - tol)
    return dict(ok=bool(ok), value=val,
                note=f"baseline {base} ±{tol:.0%} ({g.get('dir', 'max')})")


def _eval_baseline_schemes(g, rows):
    base, err = _load_baseline(g["file"], g["path"])
    if err:
        return dict(ok=False, value=None, note=err)
    metric, tol, abs_tol = g["metric"], g.get("tol"), g.get("abs_tol")
    sel = _rows_where(rows, g)
    # a run in which NO row carries the metric cannot evaluate it at
    # all (e.g. a --schemes run without ecmp emits no ratio column):
    # that is a legitimate skip, distinct from a scheme that collapsed
    if not any(metric in r for r in sel):
        return dict(ok=True, value=0,
                    note=f"skipped: no row carries {metric!r} to "
                         f"compare against {g['path']}")
    bad, checked = [], 0
    for scheme, bcell in base.items():
        if metric not in bcell:
            continue
        if not _ran(rows, scheme):
            continue                      # scheme not run this invocation
        vals, invalid = _metric_vals(sel, scheme, metric)
        if not vals:
            # ran but produced no comparable value: a collapsed run
            # emits the -1 sentinel (or omits the column) — fail loudly
            # instead of skipping (regression-pinned by tests/test_torch_exp)
            checked += 1
            why = "all sentinel/NaN" if invalid else "metric missing"
            bad.append(f"{scheme}:{why}")
            continue
        checked += 1
        val = sum(vals) / len(vals)
        b = bcell[metric]
        ok = (abs(val - b) <= abs_tol) if abs_tol is not None \
            else _within(val, b, tol if tol is not None else 0.25)
        if not ok:
            bad.append(f"{scheme}:{val} vs {b}")
    if checked == 0:
        # no overlap between run schemes and the baseline map (e.g. a
        # --schemes run whose schemes the baseline doesn't know):
        # skip — the registered cell still enforces this on full runs
        return dict(ok=True, value=0,
                    note=f"skipped: no run scheme appears in {g['path']}")
    return dict(ok=not bad, value=checked,
                note="; ".join(bad) if bad else f"{checked} schemes OK")


_EVAL = {"counter": _eval_counter, "ratio": _eval_ratio,
         "baseline": _eval_baseline,
         "baseline_schemes": _eval_baseline_schemes}


def describe(g: dict) -> str:
    kind = g["kind"]
    scope = ""
    if g.get("where"):
        scope = " @ " + ",".join(f"{k}={v}"
                                 for k, v in sorted(g["where"].items()))
    if kind == "counter":
        sch = f"[{g['scheme']}]" if g.get("scheme") else "[*]"
        return f"{sch} {g['metric']} {g.get('op', '==')} {g['value']}{scope}"
    if kind == "ratio":
        return (f"{g['metric']} {g['num']}/{g['den']} "
                f"{g.get('op', '<=')} {g['value']}{scope}")
    if kind == "baseline":
        return f"{g['metric']} vs {g['file']}:{g['path']}{scope}"
    return f"{g['metric']} per-scheme vs {g['file']}:{g['path']}{scope}"


def evaluate(guards, rows) -> list[dict]:
    """Evaluate every guard over the cell's metric rows; returns
    normalized verdict dicts (``desc``/``ok``/``value``/``note``)."""
    out = []
    for g in guards:
        verdict = _EVAL[g["kind"]](dict(g), rows)
        out.append(dict(desc=describe(dict(g)), kind=g["kind"], **verdict))
    return out
