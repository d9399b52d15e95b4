"""Report rendering from the port's experiment matrix.  Port of
``repro.exp.report``.

``render_results`` writes the paper-target check table for the cells of
one run — ratios and counters only, wall time shown as informational —
to ``results/exp_torch/RESULTS.md`` by default.  ``matrix_table`` /
``tier_table`` / ``scheme_table`` generate the matrix's tables from the
registered cells (``python -m repro_torch.exp tables``), which
:func:`write_tables` writes as a block of its own.  The port never writes
the reference's root ``RESULTS.md`` or ``EXPERIMENTS.md``.
"""
from __future__ import annotations

import time
from pathlib import Path

from repro_torch.exp import matrix
from repro_torch.exp.spec import TIERS

_KEY_METRICS = ("fct_p99_us", "fct_mean_us", "fct_us", "coll_duration_us",
                "mon_fct_mean_us", "endpoint_table_KiB")


def _key_metric(row: dict):
    for k in _KEY_METRICS:
        v = row.get(k)
        if isinstance(v, (int, float)) and v >= 0:
            return k, v
    return None, None


def render_results(summary, path: Path, out: Path) -> None:
    lines = [
        "# RESULTS — experiment-matrix run",
        "",
        f"Tier: `{summary.tier or 'custom'}` · {len(summary.results)} "
        f"cells · {summary.cache_hits} cache hits · "
        f"{len(summary.breaches)} guard breaches",
        "",
        f"Per-cell JSON under `{out}/` (content-hash keyed; unchanged "
        "cells are cache hits).  Guards are ratios and counters only — "
        "wall time is recorded but never gated.",
        "",
        "## Cells",
        "",
        "| cell | cached | rows | guards | wall s |",
        "|---|---|---|---|---|",
    ]
    for r in summary.results:
        ok = sum(g["ok"] for g in r.guards)
        badge = "✅" if r.ok else "❌"
        lines.append(f"| `{r.cell_id}` | {'hit' if r.cached else 'run'} | "
                     f"{len(r.rows)} | {badge} {ok}/{len(r.guards)} | "
                     f"{r.wall_s} |")
    lines += ["", "## Paper-target checks", "",
              "| cell | guard | ok | value | note |", "|---|---|---|---|---|"]
    for r in summary.results:
        for g in r.guards:
            lines.append(f"| `{r.cell_id}` | {g['desc']} | "
                         f"{'✅' if g['ok'] else '❌'} | {g.get('value')} | "
                         f"{g.get('note', '')} |")
    lines += ["", "## Headline ratios", "",
              "| cell | scheme | metric | value |", "|---|---|---|---|"]
    for r in summary.results:
        for row in r.rows:
            k, v = _key_metric(row)
            if k is None or row.get("scheme") in (None, "-"):
                continue
            lines.append(f"| `{r.cell_id}` | {row['scheme']} | {k} | "
                         f"{round(v, 1)} |")
    lines += ["", f"_Generated by `python -m repro_torch.exp run` on "
              f"{time.strftime('%Y-%m-%d %H:%M:%S')}._", ""]
    path.write_text("\n".join(lines))


def matrix_table() -> str:
    """The full cell table, one row per registered cell."""
    lines = ["| cell | figure | engine | topology | workload | schemes "
             "| tiers | guards |",
             "|---|---|---|---|---|---|---|---|"]
    for c in matrix.cells():
        schemes = "all" if not c.schemes else str(len(c.schemes))
        wl = c.workload + (f" + {c.failure}" if c.failure else "")
        lines.append(f"| `{c.cell_id}` | {c.figure} | {c.engine} | "
                     f"{c.topology} | {wl} | {schemes} | "
                     f"{','.join(c.tiers)} | {len(c.guards)} |")
    return "\n".join(lines)


def tier_table() -> str:
    lines = ["| tier | cells | engines | topologies | figures |",
             "|---|---|---|---|---|"]
    for tier in TIERS:
        sel = matrix.cells(tier)
        engines = sorted({c.engine for c in sel})
        topos = sorted({c.topology for c in sel})
        lines.append(f"| `{tier}` | {len(sel)} | {','.join(engines)} | "
                     f"{','.join(topos)} | "
                     f"{','.join(sorted(matrix.figures(tier)))} |")
    return "\n".join(lines)


def scheme_table() -> str:
    """The registry scheme table (DESIGN.md §11) — generated so docs
    cannot drift from the registered policies."""
    from repro_torch.net.policies import registry as REG
    lines = ["| code | name | family | failover | flow-level rule |",
             "|---|---|---|---|---|"]
    for p in REG.all_policies():
        fl = getattr(p.flow_level, "kind", p.flow_level)
        lines.append(f"| {p.code} | `{p.name}` | {p.family or '—'} | "
                     f"{'yes' if p.failover else 'no'} | {fl} |")
    return "\n".join(lines)


MARK_BEGIN = ("<!-- exp-matrix:begin (generated by `python -m "
              "repro_torch.exp tables` — do not edit) -->")
MARK_END = "<!-- exp-matrix:end -->"
DEFAULT_TABLES = Path("results/exp_torch/EXPERIMENTS_tables.md")


def tables_block() -> str:
    """The scheme / tier / cell tables between the block markers."""
    return "\n".join([
        MARK_BEGIN, "", "### Registered schemes", "", scheme_table(), "",
        "### Tiers", "", tier_table(), "",
        "### Registered cells", "", matrix_table(), "", MARK_END])


def write_tables(path: Path = DEFAULT_TABLES) -> bool:
    """Write :func:`tables_block` to ``path`` (a file of its own, never
    the reference's ``EXPERIMENTS.md``); returns True if it changed."""
    path = Path(path)
    block = tables_block() + "\n"
    if path.is_file() and path.read_text() == block:
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(block)
    return True
