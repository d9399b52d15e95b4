"""The port's experiment matrix and runner (``repro_torch.exp``) against
the reference's (``repro.exp``).

Covers: all 82 cells equal to the reference matrix's, the workload and
failure builders of every packet cell equal to the reference's, the
content hash (port sources only), the emitted JSON against the
reference's ``validate_result``, cache hit and invalidation, guard
evaluation (the reference's guard tests, mirrored and compared verdict
for verdict), the host memory cell's rows, and the port's refusals: the
flow-level cells that need the unported flow engine, and the card
default without a card.  Packet rows against the reference are in
``test_torch_exp_{packet,failover,openloop}.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.exp import guards as JG  # noqa: E402
from repro.exp import matrix as JM  # noqa: E402
from repro.exp import runner as JR  # noqa: E402
from repro.exp import spec as JSPEC  # noqa: E402
from repro.exp import workloads as JWL  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402
from repro_torch.exp import __main__ as CLI  # noqa: E402
from repro_torch.exp import guards as G  # noqa: E402
from repro_torch.exp import hashing, matrix, runner  # noqa: E402
from repro_torch.exp import spec as SPEC  # noqa: E402
from repro_torch.exp import workloads as WL  # noqa: E402
from repro_torch.exp.spec import Cell, validate_result  # noqa: E402

from test_torch_build import _same_flows  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PROBE = "engine.dragonfly.probe.smoke"
FLOW_SMOKE = ["fabric.dragonfly1056.train.smoke",
              "fabric.slimfly1134.alltoall.smoke",
              "fabric.dragonfly1056.midrun.smoke"]


# ---------------------------------------------------------------- matrix

def test_matrix_equals_reference():
    assert len(matrix.CELLS) == len(JM.CELLS) == 82
    assert list(matrix.CELLS) == list(JM.CELLS)
    for cid, cell in matrix.CELLS.items():
        assert cell.to_json() == JM.CELLS[cid].to_json(), cid
    for tier in SPEC.TIERS:
        assert [c.cell_id for c in matrix.cells(tier)] == \
            [c.cell_id for c in JM.cells(tier)]
    assert matrix.figures() == JM.figures()
    assert matrix.benches() == JM.benches()
    assert (SPEC.TIERS, SPEC.ENGINES, SPEC.SCALES_BY_ENGINE,
            SPEC.RESULT_SCHEMA_VERSION, SPEC.GUARD_KINDS) == \
        (JSPEC.TIERS, JSPEC.ENGINES, JSPEC.SCALES_BY_ENGINE,
         JSPEC.RESULT_SCHEMA_VERSION, JSPEC.GUARD_KINDS)


def test_cell_ids_unique_and_valid():
    for cell_id, cell in matrix.CELLS.items():
        assert cell.cell_id == cell_id
        assert cell.tiers and cell.seeds, cell_id
    with pytest.raises(ValueError):
        dataclasses.replace(matrix.CELLS[PROBE], engine="bogus")
    with pytest.raises(ValueError):
        dataclasses.replace(matrix.CELLS[PROBE], tiers=("nightly",))


def test_schemes_resolve_against_registry():
    from repro_torch.net.policies import registry as REG
    known = set(REG.names())
    for cell in matrix.cells():
        for s in cell.schemes:
            assert s in known, f"{cell.cell_id}: unknown scheme {s}"
        for g in cell.guards:
            for key in ("scheme", "num", "den"):
                if g.get(key):
                    assert g[key] in known, cell.cell_id
    assert runner._resolve_schemes(matrix.CELLS["memory.multi."
                                                "endpoint_memory.small"]) \
        == REG.names()


def test_smoke_tier_split_by_engine():
    """The smoke tier is the 7 cells the port runs and the 3 flow-level
    cells it cannot run yet."""
    smoke = matrix.cells("smoke")
    assert len(smoke) == 10
    assert [c.cell_id for c in smoke if not runner.ported(c)] == FLOW_SMOKE
    assert all(c.guards for c in smoke)
    assert not runner.ported(matrix.CELLS["serve.dragonfly1056."
                                          "websearch.quick"])
    assert runner.ported(matrix.CELLS["serve.dragonfly.websearch.smoke"])


_TOPOS: dict = {}


def _topos(cell):
    key = (cell.topology, cell.scale)
    if key not in _TOPOS:
        _TOPOS[key] = (JWL.make_topology(*key), WL.make_topology(*key))
    return _TOPOS[key]


def _same_plan(a, b, ctx):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys(), ctx
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{ctx} {k}")


def test_workload_and_failure_builders_equal():
    """Every packet cell's flows, masks, stop set and failure plan (the
    compiled arrays) equal the reference's."""
    assert list(WL.WORKLOADS) == list(JWL.WORKLOADS)
    assert list(WL.FAILURES) == list(JWL.FAILURES)
    n = 0
    for cell in matrix.cells():
        if cell.engine != "packet":
            continue
        n += 1
        ja, ta = _topos(cell)
        jw, tw = JWL.build_workload(cell, ja), WL.build_workload(cell, ta)
        _same_flows(jw.flows, tw.flows)
        assert list(jw.masks) == list(tw.masks), cell.cell_id
        for k in jw.masks:
            np.testing.assert_array_equal(jw.masks[k], tw.masks[k])
        np.testing.assert_array_equal(
            np.asarray(jw.stop_flows if jw.stop_flows is not None else -1),
            np.asarray(tw.stop_flows if tw.stop_flows is not None else -1))
        assert jw.collective == tw.collective
        jf, tf = JWL.build_failure(cell, ja), WL.build_failure(cell, ta)
        assert jf.t_fail == tf.t_fail and list(jf.spec_kw) == \
            list(tf.spec_kw), cell.cell_id
        for k, v in jf.spec_kw.items():
            if k == "failure_plan":
                _same_plan(v.compile(), tf.spec_kw[k].compile(),
                           cell.cell_id)
            else:
                assert tf.spec_kw[k] == v, (cell.cell_id, k)
    assert n == 59


def test_unknown_builders_raise():
    cell = dataclasses.replace(matrix.CELLS[PROBE], workload="bogus")
    with pytest.raises(ValueError, match="unknown workload"):
        WL.build_workload(cell, None)
    cell = dataclasses.replace(matrix.CELLS[PROBE], failure="bogus")
    with pytest.raises(ValueError, match="unknown failure plan"):
        WL.build_failure(cell, None)
    with pytest.raises(ValueError, match="unknown topology"):
        WL.make_topology("torus", "small")


# ------------------------------------------------------- schema + hashing

def _probe_cell(**over) -> Cell:
    base = matrix.CELLS[PROBE]
    return dataclasses.replace(base, **over) if over else base


def test_cell_hash_covers_spec_and_tree(monkeypatch):
    c1 = _probe_cell()
    c2 = _probe_cell(cell_id="engine.other", n_ticks=1 << 12)
    h1, h2 = hashing.cell_hash(c1), hashing.cell_hash(c2)
    assert h1 != h2
    assert h1 == hashing.cell_hash(c1)  # deterministic
    monkeypatch.setattr(hashing, "tree_digest", lambda root=None: "tampered")
    assert hashing.cell_hash(c1) != h1


def test_hash_covers_the_port_and_the_baselines_only():
    files = [p.relative_to(REPO).as_posix()
             for p in hashing._tracked_files(REPO)]
    assert "BENCH_engine.json" in files and "BENCH_fabric.json" in files
    assert "src/repro_torch/exp/matrix.py" in files
    assert any(f.endswith(".cu") for f in files)
    assert not [f for f in files if f.startswith(("src/repro/",
                                                  "benchmarks/"))]
    assert hashing.repo_root() == REPO


def test_result_schema_validator_rejects_drift():
    ok = {"schema": 1, "cell_id": "x", "hash": "h", "spec": {
        "engine": "packet", "topology": "d", "workload": "w",
        "schemes": [], "seeds": [0], "tiers": ["ci"], "guards": []},
        "rows": [{"scheme": "ecmp", "seed": 0}], "guards": [],
        "schemes_run": ["ecmp"], "wall_s": 0.1}
    for bad in ({**ok, "schema": 99}, {k: v for k, v in ok.items()
                                       if k != "rows"},
                {**ok, "rows": [{"seed": 0}]},
                {**ok, "guards": [{"ok": True}]}):
        assert validate_result(bad) == JSPEC.validate_result(bad) != []
    assert validate_result(ok) == []


# --------------------------------------------- runner: cache + guards

@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("exp")
    summary = runner.run(cells=[PROBE], out=out, verbose=False,
                         device="cpu")
    return out, summary


def test_packet_cell_roundtrip_and_guards(probe_run):
    out, summary = probe_run
    assert summary.ok and len(summary.results) == 1
    assert summary.not_ported == []
    (res,) = summary.results
    assert not res.cached
    obj = json.loads(res.path.read_text())
    # the port's result passes the reference's schema check too
    assert validate_result(obj) == JSPEC.validate_result(obj) == []
    assert obj["cell_id"] == PROBE and obj["schemes_run"] == ["ecmp"]
    assert obj["spec"] == JM.CELLS[PROBE].to_json()
    kinds = {g["kind"] for g in obj["guards"]}
    assert kinds == {"counter", "baseline"}
    assert all(g["ok"] for g in obj["guards"])
    assert summary.rows[0]["cell_id"] == PROBE
    assert runner.DEFAULT_OUT == Path("results/exp_torch")


def test_cache_hit_then_invalidation(probe_run, monkeypatch):
    out, first = probe_run
    again = runner.run(cells=[PROBE], out=out, verbose=False, device="cpu")
    assert again.cache_hits == 1 and again.ok
    assert again.results[0].rows == first.results[0].rows
    monkeypatch.setattr(hashing, "tree_digest", lambda root=None: "edited")
    stored = json.loads((out / f"{PROBE}.json").read_text())
    assert hashing.cell_hash(matrix.CELLS[PROBE]) != stored["hash"]


def test_guard_breach_exits_nonzero(probe_run, monkeypatch):
    out, _ = probe_run
    breach = _probe_cell(cell_id="engine.probe.breach",
                         guards=({"kind": "counter", "metric": "compression",
                                  "op": ">=", "value": 1e9},))
    res = runner.run_cell(breach, out=out, verbose=False, device="cpu")
    assert not res.ok
    monkeypatch.setattr(matrix, "cells",
                        lambda tier=None, ids=None, bench=None: [breach])
    summary = runner.run(cells=["engine.probe.breach"], out=out,
                         verbose=False, device="cpu")
    assert summary.breaches
    with pytest.raises(SystemExit):
        runner.run(cells=["engine.probe.breach"], out=out, check=True,
                   verbose=False, device="cpu")


def test_runner_rejects_unknown_cell():
    with pytest.raises(KeyError):
        runner.run(cells=["no.such.cell"], verbose=False, device="cpu")


def test_scheme_override_derives_new_cache_key():
    cell = _probe_cell()
    narrowed = cell.with_overrides(schemes=("ecmp",), scale="mid")
    assert narrowed.cell_id != cell.cell_id
    assert hashing.cell_hash(narrowed) != hashing.cell_hash(cell)
    assert cell.with_overrides(schemes=("minimal",)).cell_id != cell.cell_id
    assert cell.with_overrides(schemes=cell.schemes).cell_id == cell.cell_id
    j = JM.CELLS[PROBE].with_overrides(schemes=("minimal",), seeds=(1, 2),
                                       scale="mid")
    t = cell.with_overrides(schemes=("minimal",), seeds=(1, 2), scale="mid")
    assert t.to_json() == j.to_json()


def test_chaos_seed_cells_equal_reference():
    sel = matrix.cells("chaos")
    got = runner.chaos_seed_cells(sel, [7, 99])
    want = JR.chaos_seed_cells(JM.cells("chaos"), [7, 99])
    assert [c.to_json() for c in got] == [c.to_json() for c in want]


def test_host_memory_cell_equals_reference(tmp_path):
    cid = "memory.multi.endpoint_memory.small"
    port = runner.run_cell(matrix.CELLS[cid], out=tmp_path / "port",
                           verbose=False, device="cpu")
    ref = JR.run_cell(JM.CELLS[cid], out=tmp_path / "ref", verbose=False)
    assert port.rows == ref.rows and len(port.rows) == 3
    assert port.guards == ref.guards and port.ok


def test_dense_ref_pseudo_key(tmp_path):
    """``spec_kw["with_dense_ref"]`` adds the dense stepper's warm wall
    time and the speedup over it to each row and changes nothing else."""
    short = {"start_tick": 64, "size_pkts": 8}
    plain = _probe_cell(cell_id="engine.probe.short", workload_kw=short)
    dense = _probe_cell(cell_id="engine.probe.dense", workload_kw=short,
                        spec_kw={"with_dense_ref": True})
    (a,) = runner.run_cell(plain, out=tmp_path, verbose=False,
                           device="cpu").rows
    (b,) = runner.run_cell(dense, out=tmp_path, verbose=False,
                           device="cpu").rows
    assert b["wall_s_dense_warm"] >= 0 and b["dense_speedup"] > 0
    assert {k: v for k, v in b.items() if k not in GOLD.WALL_FIELDS} == \
        {k: v for k, v in a.items() if k not in GOLD.WALL_FIELDS}


# ------------------------------------------- what the port cannot run

class _Fake:
    """``runner.run_cell`` without a run: the rows of a clean cell."""

    def __init__(self):
        self.ran = []

    def __call__(self, cell, out, force, verbose, device):
        self.ran.append(cell.cell_id)
        return runner.CellResult(cell.cell_id, False, [], [], 0.0, Path(out))


def test_smoke_tier_lists_flow_cells_not_ported(monkeypatch, capsys):
    fake = _Fake()
    monkeypatch.setattr(runner, "run_cell", fake)
    summary = runner.run(tier="smoke", device="cpu")
    assert summary.not_ported == FLOW_SMOKE
    assert len(fake.ran) == 7 and not set(fake.ran) & set(FLOW_SMOKE)
    assert f"[exp] not ported yet: {', '.join(FLOW_SMOKE)}" in \
        capsys.readouterr().out.splitlines()
    assert summary.ok and len(summary.results) == 7
    # the CLI: exit 0, the same line
    fake.ran.clear()
    assert CLI.main(["run", "--tier", "smoke", "--device", "cpu"]) == 0
    assert f"[exp] not ported yet: {', '.join(FLOW_SMOKE)}" in \
        capsys.readouterr().out
    assert len(fake.ran) == 7


@pytest.mark.parametrize("cid", FLOW_SMOKE[:1] + [
    "serve.dragonfly1056.websearch.quick", "fabric.dragonfly1056.cross.full"])
def test_named_flow_cell_raises(cid):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        runner.run(cells=[cid], device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        runner.run_cell(matrix.CELLS[cid], device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        CLI.main(["run", "--cells", cid, "--device", "cpu"])


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run(cells=[PROBE], out=tmp_path, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_cell(matrix.CELLS[PROBE], out=tmp_path, verbose=False)


def test_cli_list(capsys):
    assert CLI.main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 82
    assert sum(line.endswith("not ported") for line in lines) == \
        sum(not runner.ported(c) for c in matrix.cells())
    assert CLI.main(["list", "--tier", "smoke"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 10


# ---------------------------------------------------------- guard units

def _both(guards, rows):
    """The port's verdicts, required equal to the reference's."""
    got = G.evaluate(guards, rows)
    assert got == JG.evaluate(guards, rows)
    return got


def test_guard_evaluators():
    rows = [{"scheme": "ecmp", "seed": 0, "fct_mean_us": 100.0,
             "down_violations": 0},
            {"scheme": "spritz_spray_w", "seed": 0, "fct_mean_us": 80.0,
             "down_violations": 0}]
    out = _both((
        {"kind": "counter", "metric": "down_violations", "op": "==",
         "value": 0},
        {"kind": "ratio", "metric": "fct_mean_us", "num": "spritz_spray_w",
         "den": "ecmp", "op": "<=", "value": 1.0},
        {"kind": "ratio", "metric": "fct_mean_us", "num": "ecmp",
         "den": "spritz_spray_w", "op": "<=", "value": 1.0},
    ), rows)
    assert [g["ok"] for g in out] == [True, True, False]
    assert out[1]["value"] == pytest.approx(0.8)
    (miss,) = _both(({"kind": "ratio", "metric": "fct_mean_us",
                      "num": "reps", "den": "ecmp", "op": "<=",
                      "value": 1.0},), rows)
    assert miss["ok"] and "skip" in miss["note"]
    (drift,) = _both(({"kind": "ratio", "metric": "nonexistent_metric",
                       "num": "spritz_spray_w", "den": "ecmp",
                       "op": "<=", "value": 1.0},), rows)
    assert not drift["ok"]
    (zero,) = _both(({"kind": "counter", "metric": "absent", "op": "==",
                      "value": 0},), rows)
    assert not zero["ok"]


def test_guard_sentinel_and_nan_fail_not_skip():
    rows = [{"scheme": "ecmp", "seed": 0, "fct_p99_us": 100.0,
             "fct_ratio_vs_ecmp": 1.0},
            {"scheme": "spritz_spray_w", "seed": 0, "fct_p99_us": -1.0,
             "fct_ratio_vs_ecmp": -1.0}]
    ratio = {"kind": "ratio", "metric": "fct_p99_us",
             "num": "spritz_spray_w", "den": "ecmp", "op": "<=",
             "value": 1.0}
    (g,) = _both((ratio,), rows)
    assert not g["ok"] and "sentinel" in g["note"]
    nan_rows = [dict(r, nan_metric=float("nan")) for r in rows]
    (g,) = G.evaluate((dict(ratio, metric="nan_metric"),), nan_rows)
    assert not g["ok"]
    bs = {"kind": "baseline_schemes", "file": "BENCH_fabric.json",
          "path": "quick_cells.dragonfly1056.train.schemes",
          "metric": "fct_ratio_vs_ecmp", "tol": 0.25}
    (g,) = _both((bs,), rows)
    assert not g["ok"] and "sentinel" in g["note"]
    bare = [{k: v for k, v in r.items() if k != "fct_ratio_vs_ecmp"}
            for r in rows]
    (g,) = _both((bs,), bare)
    assert g["ok"] and "skip" in g["note"]


def test_guard_where_filter_scopes_rows():
    rows = [{"scheme": "ecmp", "seed": 0, "load": 0.3, "fct_p99_us": 10.0},
            {"scheme": "ecmp", "seed": 0, "load": 0.9, "fct_p99_us": 100.0},
            {"scheme": "spritz_spray_w", "seed": 0, "load": 0.3,
             "fct_p99_us": 20.0},
            {"scheme": "spritz_spray_w", "seed": 0, "load": 0.9,
             "fct_p99_us": 80.0}]
    g90 = {"kind": "ratio", "metric": "fct_p99_us",
           "num": "spritz_spray_w", "den": "ecmp", "op": "<=",
           "value": 1.0, "where": {"load": 0.9}}
    (a,) = _both((g90,), rows)
    assert a["ok"] and a["value"] == pytest.approx(0.8)
    assert "load=0.9" in a["desc"]
    (b,) = _both((dict(g90, where={"load": 0.3}),), rows)
    assert not b["ok"] and b["value"] == pytest.approx(2.0)
    (c,) = _both(({"kind": "counter", "metric": "fct_p99_us",
                   "op": "<=", "value": 30.0,
                   "where": {"load": 0.3}},), rows)
    assert c["ok"] and c["value"] == 20.0


def test_baseline_guards_read_checked_in_files():
    base = json.loads((REPO / "BENCH_fabric.json").read_text())
    cellb = base["quick_cells"]["dragonfly1056"]["train"]["schemes"]
    g = {"kind": "baseline_schemes", "file": "BENCH_fabric.json",
         "path": "quick_cells.dragonfly1056.train.schemes",
         "metric": "done_frac", "abs_tol": 0.02}
    rows = [{"scheme": "ecmp", "seed": 0,
             "done_frac": cellb["ecmp"]["done_frac"]}]
    (v,) = _both((g,), rows)
    assert v["ok"]
    rows[0]["done_frac"] -= 0.5
    (v,) = _both((g,), rows)
    assert not v["ok"]
    probe = next(x for x in matrix.CELLS[PROBE].guards
                 if x["kind"] == "baseline")
    steps = json.loads((REPO / "BENCH_engine.json").read_text())[
        "compression_probe"]["steps_executed"]
    for n, ok in ((steps, True), (int(steps * 1.3) + 1, False)):
        (v,) = _both((probe,), [{"scheme": "ecmp", "seed": 0, "steps": n}])
        assert v["ok"] is ok
    (v,) = _both((dict(probe, file="BENCH_missing.json"),),
                 [{"scheme": "ecmp", "seed": 0, "steps": 1}])
    assert not v["ok"] and "missing" in v["note"]
