"""Windowed steady-state measurement for open-loop runs (DESIGN.md §15).
Port of ``repro.net.steady``.

Closed-loop cells run a fixed flow set to drain and report whole-run
FCT statistics; open-loop serving (``repro_torch.net.arrivals``) instead
sustains a load level and measures the *stationary* regime: a warmup
prefix is excluded, the remaining horizon is cut into fixed windows,
and each window reports completion percentiles and goodput.  The
helpers here are unit-agnostic — packet-engine callers pass ticks,
flow-engine callers pass byte-times — as long as ``start``/``fct`` and
the ``warmup``/``window``/``horizon`` parameters share one unit.

Two measurement axes, deliberately different:

* **per-window** series bucket flows by *completion* time (a
  time-series view of the run; late windows under overload visibly
  starve), and
* **steady** aggregates select flows by *arrival* time inside
  ``[warmup, horizon)`` and use their FCT whenever it lands (bounded
  by the caller's drain allowance) — this avoids the completion-
  bucketing censoring bias for everything except flows still unfinished
  at the end of the run, which are counted in ``censored`` rather than
  silently dropped.

Empty statistics are the explicit :data:`EMPTY` sentinel (-1.0), never
NaN: ``repro_torch.exp.guards`` treats a present-but-sentinel metric as a
hard guard failure (NaN would silently pass some comparisons because
every NaN comparison is False).
"""
from __future__ import annotations

import numpy as np

# Explicit "no data" marker for empty-window / empty-completion stats.
# A negative value fails the guards' ``>= 0`` validity filter loudly
# (guards report present-but-sentinel metrics as breaches) and keeps
# result JSONs numeric.  Never emit NaN from a stats helper.
EMPTY = -1.0


def percentile_or_empty(vals, q: float) -> float:
    """``np.percentile`` with the empty-input case mapped to
    :data:`EMPTY` instead of NaN (satellite of DESIGN.md §15)."""
    vals = np.asarray(vals, np.float64)
    if vals.size == 0:
        return EMPTY
    return float(np.percentile(vals, q))


def _fct_block(fct, prefix="fct_"):
    """p50/p99/p999/mean over a completed-FCT sample (EMPTY when the
    sample is empty)."""
    fct = np.asarray(fct, np.float64)
    return {
        f"{prefix}p50": percentile_or_empty(fct, 50),
        f"{prefix}p99": percentile_or_empty(fct, 99),
        f"{prefix}p999": percentile_or_empty(fct, 99.9),
        f"{prefix}mean": float(fct.mean()) if fct.size else EMPTY,
    }


def window_stats(start, fct, size, *, warmup: float, window: float,
                 horizon: float) -> dict:
    """Windowed steady-state statistics over one open-loop run.

    ``start``/``fct``/``size`` are per-flow arrays in one consistent
    unit system (``fct`` relative to ``start``; ``fct < 0`` == never
    finished).  Windows tile ``[warmup, horizon)`` in steps of
    ``window``; a trailing partial window is kept (its span is
    recorded).  Returns::

        {"windows": [{"t0", "t1", "n_done", "fct_p50", "fct_p99",
                      "fct_p999", "fct_mean", "goodput"}, ...],
         "steady": {"n_arrivals", "n_done", "censored", "done_frac",
                    "fct_p50", "fct_p99", "fct_p999", "fct_mean",
                    "goodput", "span"}}

    ``goodput`` is delivered ``size``-units per time-unit over the
    window (callers normalize to a capacity fraction).  The ``steady``
    block selects flows by arrival in ``[warmup, horizon)``; FCTs count
    whenever the flow completes, and still-running flows land in
    ``censored`` (percentiles are then lower bounds — guard
    ``done_frac`` alongside them).
    """
    start = np.asarray(start, np.float64)
    fct = np.asarray(fct, np.float64)
    size = np.asarray(size, np.float64)
    if not (0 <= warmup < horizon):
        raise ValueError(f"need 0 <= warmup < horizon, got "
                         f"warmup={warmup} horizon={horizon}")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    comp = np.where(fct >= 0, start + fct, np.inf)

    windows = []
    t0 = float(warmup)
    while t0 < horizon:
        t1 = min(t0 + window, float(horizon))
        in_w = (comp >= t0) & (comp < t1)
        w = {"t0": t0, "t1": t1, "n_done": int(in_w.sum()),
             "goodput": float(size[in_w].sum()) / (t1 - t0)}
        w.update(_fct_block(fct[in_w]))
        windows.append(w)
        t0 = t1

    arr = (start >= warmup) & (start < horizon)
    done = arr & (fct >= 0)
    span = float(horizon) - float(warmup)
    in_span = (comp >= warmup) & (comp < horizon)
    steady = {
        "n_arrivals": int(arr.sum()),
        "n_done": int(done.sum()),
        "censored": int((arr & (fct < 0)).sum()),
        "done_frac": (float(done.sum() / arr.sum())
                      if arr.any() else EMPTY),
        "goodput": float(size[in_span].sum()) / span,
        "span": span,
    }
    steady.update(_fct_block(fct[done]))
    return {"windows": windows, "steady": steady}


def mean_inflight(start, fct, t0: float, t1: float) -> float:
    """Time-averaged number of in-flight flows over ``[t0, t1)``.

    Each flow contributes the overlap of its lifetime ``[start,
    start+fct)`` with the interval; flows that never finished
    (``fct < 0``) are open-ended and contribute through ``t1``.  With
    Little's law, this should match ``arrival_rate * mean_fct`` in the
    stationary regime (pinned by tests/test_arrivals.py at low load).
    """
    start = np.asarray(start, np.float64)
    fct = np.asarray(fct, np.float64)
    if t1 <= t0:
        raise ValueError(f"need t1 > t0, got [{t0}, {t1})")
    end = np.where(fct >= 0, start + fct, t1)
    overlap = np.minimum(end, t1) - np.maximum(start, t0)
    return float(np.maximum(overlap, 0.0).sum() / (t1 - t0))


def queue_depth_ticks(q_tail, t: float) -> dict:
    """Per-port queue occupancy distribution from a packet-engine
    checkpoint.

    ``q_tail`` is the carry's per-port busy-tail tick (the tick the
    port's queue drains at full service rate); occupancy at tick ``t``
    is ``max(q_tail - t, 0)`` ticks-to-drain — at nominal rate one tick
    is one queued packet, on a degraded port it is capacity-normalized
    backlog, which is exactly the load signal the adaptive schemes
    steer on.  Returns mean/p50/p99/max over ports.
    """
    depth = np.maximum(np.asarray(q_tail, np.float64) - float(t), 0.0)
    return {
        "mean": float(depth.mean()) if depth.size else EMPTY,
        "p50": percentile_or_empty(depth, 50),
        "p99": percentile_or_empty(depth, 99),
        "max": float(depth.max()) if depth.size else EMPTY,
    }
