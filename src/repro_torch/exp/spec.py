"""Declarative experiment-matrix cell model (DESIGN.md §13).  Port of
``repro.exp.spec``: the same cells, schema and result version, so a
result of the port passes the reference's ``validate_result``.

A **cell** is data: ``(topology, workload, engine, schemes, failure
plan, seeds, scale tier)`` plus the guard list that turns its result
into a pass/fail verdict.  Cells are registered in
:mod:`repro_torch.exp.matrix`; :mod:`repro_torch.exp.runner` dispatches
the packet, host and packet-fidelity open-loop cells through the port's
packet engine (``engine.run_batch``) and emits one normalized JSON per
cell under ``results/exp_torch/``.

Guards are expressed **only as ratios and counters** — never absolute
wall time (shared-container variance; wall time is recorded as
informational ``wall_s`` fields only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# "chaos" is the randomized-degradation tier (DESIGN.md §10/§13): cells
# with seeded capacity schedules; nightly derives extra seeds via
# ``--chaos-seeds`` (each recorded in the result JSON's spec block).
TIERS = ("smoke", "ci", "chaos", "full")

# engine dispatch kinds: "packet" = engine.run_batch, "flow" =
# flowsim.simulate_batch, "cross" = the same flow set through BOTH
# engines with per-scheme cross-engine FCT ratios (DESIGN.md §14),
# "host" = host-side analytic cells (path/memory model — no simulator
# run), "openloop" = offered-load sweep serving cells (DESIGN.md §15:
# Poisson arrival streams + windowed steady-state metrics, at flow or
# packet fidelity per the cell's workload_kw).
ENGINES = ("packet", "flow", "cross", "host", "openloop")

# scales a CLI --scale override may retarget per engine.  Packet/host
# scale picks only the topology size; flow and cross cells'
# "quick"/"full" is entangled with their chip/shard workload_kw, so they
# are never retargeted — select the registered quick or full cell
# instead.  A cell whose own scale is outside its engine's table (e.g.
# the paper-instance "quick" packet cells on dragonfly1056) is likewise
# pinned: the runner only retargets when both the requested and the
# registered scale are listed here.
SCALES_BY_ENGINE = {"packet": ("small", "mid", "full"),
                    "flow": (),
                    "cross": (),
                    "host": ("small", "mid", "full"),
                    "openloop": ()}

RESULT_SCHEMA_VERSION = 1

# guard kinds understood by repro_torch.exp.guards.evaluate (that module's
# docstring specifies each kind's fields; every kind additionally
# accepts ``where`` — a row filter, e.g. {"where": {"load": 0.9}} —
# and ``counter``/``baseline`` accept a ``scheme`` scope)
GUARD_KINDS = ("counter", "ratio", "baseline", "baseline_schemes")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One experiment-matrix cell.  Everything is plain data — the cell
    spec (via :meth:`to_json`) is part of the result content-hash, so
    any edit invalidates the cached result.

    Field contract (what a new cell must get right):

    * ``cell_id`` — unique dotted name, conventionally
      ``bench.topology.workload[.failure].scale``; it is the result
      file name under ``results/exp/``.
    * ``engine`` — dispatch kind from :data:`ENGINES`; picks the
      executor module (``repro_torch.exp.packet`` / ``flow`` / ``cross`` /
      ``host`` / ``openloop``).
    * ``topology``/``scale`` — a key of
      ``repro_torch.exp.workloads.make_topology``'s table.  A CLI
      ``--scale`` override only retargets when both the requested and
      the registered scale appear in :data:`SCALES_BY_ENGINE` for the
      cell's engine (flow/cross/openloop cells are pinned: their scale
      is entangled with ``workload_kw``).
    * ``workload``/``workload_kw`` — builder name plus its kwargs.
      Packet cells resolve through ``repro_torch.exp.workloads``; flow cells
      name a collective kind for ``bridge.cell_flows``; openloop cells
      use ``workload_kw`` for the sweep itself (``fidelity``,
      ``loads``, ``horizon_ticks``, ``warmup_frac``, ``window_frac``,
      ``size``, ``size_cap_pkts``, ``drain_ticks`` — see
      ``repro_torch.exp.openloop._kw``).
    * ``schemes`` — registry names; ``()`` means every registered
      scheme, resolved at run time in registry order.
    * ``failure``/``failure_kw`` — failure-plan builder (packet:
      ``repro_torch.exp.workloads.FAILURES``; flow:
      ``repro_torch.exp.flow._failure_plan``); ``None`` = healthy run.
    * ``seeds`` — engine seeds; every scheme runs every seed and rows
      carry ``seed`` so guards average over them.
    * ``n_ticks``/``spec_kw`` — packet-engine tick budget and
      ``build_spec`` kwargs (plus the pseudo-keys ``with_dense_ref``
      and ``with_healthy_ref`` the packet executor consumes).
    * ``tiers`` — which of :data:`TIERS` select the cell.
    * ``guards`` — mappings with a ``kind`` from :data:`GUARD_KINDS`;
      evaluated by ``repro_torch.exp.guards.evaluate`` over the emitted rows
      (ratios and counters only — never absolute wall time).
    """

    cell_id: str                      # unique, dotted: bench.topo.workload[.failure].scale
    figure: str                       # DESIGN.md §8 paper artifact id
    bench: str                        # owning legacy bench module ("micro", ...)
    engine: str                       # one of ENGINES
    topology: str                     # "dragonfly" | "slimfly" | "dragonfly1056" | ...
    scale: str                        # "small" | "mid" | "full" | "quick"
    workload: str                     # builder name (repro_torch.exp.workloads / flow cell kind)
    workload_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    schemes: tuple[str, ...] = ()     # registry names; () == every registered scheme
    failure: str | None = None        # failure-plan builder name
    failure_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seeds: tuple[int, ...] = (0,)
    n_ticks: int | None = None        # packet engine tick budget
    spec_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    tiers: tuple[str, ...] = ("ci",)
    guards: tuple[Mapping[str, Any], ...] = ()

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"{self.cell_id}: unknown engine {self.engine}")
        for t in self.tiers:
            if t not in TIERS:
                raise ValueError(f"{self.cell_id}: unknown tier {t}")
        for g in self.guards:
            if g.get("kind") not in GUARD_KINDS:
                raise ValueError(f"{self.cell_id}: unknown guard kind "
                                 f"{g.get('kind')!r}")

    def to_json(self) -> dict:
        """Canonical JSON form — the hashing payload and the ``spec``
        block of the emitted result file."""
        d = dataclasses.asdict(self)
        d["workload_kw"] = dict(sorted(dict(self.workload_kw).items()))
        d["failure_kw"] = dict(sorted(dict(self.failure_kw).items()))
        d["spec_kw"] = dict(sorted(dict(self.spec_kw).items()))
        d["schemes"] = list(self.schemes)
        d["seeds"] = list(self.seeds)
        d["tiers"] = list(self.tiers)
        d["guards"] = [dict(sorted(g.items())) for g in self.guards]
        return d

    def with_overrides(self, *, schemes=None, seeds=None, scale=None) -> "Cell":
        """Derive a cell with a narrowed scheme set / seed list / scale.
        Any effective override rewrites the id (a deterministic ``@``
        suffix) so overridden runs never collide with the registered
        cell's cached result file."""
        import hashlib
        cell = self
        tags = []
        if schemes is not None and tuple(schemes) != self.schemes:
            cell = dataclasses.replace(cell, schemes=tuple(schemes))
            tags.append("s" + hashlib.sha256(
                ",".join(schemes).encode()).hexdigest()[:8])
        if seeds is not None and tuple(seeds) != self.seeds:
            cell = dataclasses.replace(cell, seeds=tuple(seeds))
            tags.append("r" + hashlib.sha256(
                ",".join(map(str, seeds)).encode()).hexdigest()[:8])
        if scale is not None and scale != cell.scale:
            cell = dataclasses.replace(cell, scale=scale)
            tags.append(scale)
        if tags:
            cell = dataclasses.replace(
                cell, cell_id=f"{self.cell_id}@{'-'.join(tags)}")
        return cell


def validate_result(obj: dict) -> list[str]:
    """Schema check for an emitted per-cell result JSON.  Returns a list
    of problems (empty == valid) — used by the runner before writing and
    by ``tests/test_exp.py`` as the emitter/guard drift tripwire."""
    errs = []

    def need(key, typ):
        if key not in obj:
            errs.append(f"missing key {key!r}")
            return None
        if typ is not None and not isinstance(obj[key], typ):
            errs.append(f"{key!r} is {type(obj[key]).__name__}, "
                        f"want {typ.__name__}")
            return None
        return obj[key]

    if need("schema", int) != RESULT_SCHEMA_VERSION:
        errs.append(f"schema != {RESULT_SCHEMA_VERSION}")
    need("cell_id", str)
    need("hash", str)
    spec = need("spec", dict)
    if spec is not None:
        for k in ("engine", "topology", "workload", "schemes", "seeds",
                  "tiers", "guards"):
            if k not in spec:
                errs.append(f"spec missing {k!r}")
    rows = need("rows", list)
    if rows is not None:
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                errs.append(f"rows[{i}] not a dict")
                continue
            for k in ("scheme", "seed"):
                if k not in r:
                    errs.append(f"rows[{i}] missing {k!r}")
    guards = need("guards", list)
    if guards is not None:
        for i, g in enumerate(guards):
            if not isinstance(g, dict):
                errs.append(f"guards[{i}] not a dict")
                continue
            for k in ("desc", "ok"):
                if k not in g:
                    errs.append(f"guards[{i}] missing {k!r}")
    need("schemes_run", list)
    need("wall_s", (int, float))
    return errs
