"""The port's flow and flow-fidelity open-loop executors give the
reference runner's rows, ``fabric_cells_golden.json`` stays the
reference's record of the smoke tier's flow cells, and the port's report
and tables leave the reference's root documents alone.  The cross-engine
cell has a file of its own (``test_torch_exp_cross.py``), so that the
two share no worker.

Cut-down copies of the cells (:data:`CUTS`) run through
``repro.exp.runner`` (the reference on the CPU) and
``repro_torch.exp.runner`` (``device="cpu"``); every row field must be
equal, the wall-time fields excluded, and so must the guard verdicts.
Each cut keeps its cell's topology (the paper's DF-1056 or SF-1134),
workload builder, failure plan, scheme set and guards, and shrinks only
the collective (chips and shard bytes) or the arrival stream.

``chip_smoke.py`` runs the registered smoke cells at full size on the
card against the record.  Regenerate the record (the reference's runner
over every cell of ``data.FABRIC_CELLS``, about half a minute on the
CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_exp_flow.py --write

Hold a result file the port's runner wrote (on the card, for a cell too
long for the tests) against the reference's runner on the CPU, row for
row, wall-time fields excluded, with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_exp_flow.py --check results/exp_torch/<cell>.json
"""
import contextlib
import dataclasses
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.exp import matrix as JM  # noqa: E402
from repro.exp import report as JREP  # noqa: E402
from repro.exp import runner as JR  # noqa: E402
from repro.fabric import flowsim as JF  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402
from repro_torch.exp import __main__ as CLI  # noqa: E402
from repro_torch.exp import matrix as TM  # noqa: E402
from repro_torch.exp import report as TREP  # noqa: E402
from repro_torch.exp import runner as TR  # noqa: E402
from repro_torch.fabric import flowsim as TF  # noqa: E402

from test_torch_exp_packet import assert_rows_equal  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TRAIN = {"n_chips": 64, "tp": 16, "shard": 4e5}
CUTS = {
    "fabric.dragonfly1056.train.smoke": dict(workload_kw=TRAIN),
    "fabric.slimfly1134.alltoall.smoke": dict(
        workload_kw={"n_chips": 48, "tp": 16, "shard": 2e5}),
    "fabric.dragonfly1056.midrun.smoke": dict(workload_kw=TRAIN),
    "fabric.dragonfly1056.degraded.quick": dict(workload_kw=TRAIN),
    "fabric.dragonfly1056.chaos.quick": dict(workload_kw=TRAIN),
    "serve.dragonfly1056.websearch.quick": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"fidelity": "flow", "loads": (0.3, 0.9),
                     "horizon_ticks": 64, "size_cap_pkts": 32,
                     "max_flows": 300, "warmup_frac": 0.25,
                     "window_frac": 0.25, "seed": 0, "max_paths": 32}),
}


@contextlib.contextmanager
def fct_digests(module, name: str):
    """Collect :func:`GOLD.fct_digest` of every ``FlowResult`` that
    ``module.name`` returns while the block runs, in call order: every
    lane goes through the reference's ``simulate`` and the port's
    ``_run``."""
    digests, inner = [], getattr(module, name)

    def lane(*a, **kw):
        res = inner(*a, **kw)
        digests.append(GOLD.fct_digest(res.fct))
        return res

    setattr(module, name, lane)
    try:
        yield digests
    finally:
        setattr(module, name, inner)


def cut(matrix, cell_id: str, cuts=CUTS):
    return dataclasses.replace(matrix.CELLS[cell_id],
                               cell_id=f"{cell_id}.cut", **cuts[cell_id])


def check_cut(cell_id, tmp_path, cuts=CUTS):
    """The cut cell through both runners: rows, guards and spec equal,
    and every flow-level lane's ``fct`` equal byte for byte."""
    with fct_digests(JF, "simulate") as want:
        ref = JR.run_cell(cut(JM, cell_id, cuts), out=tmp_path / "ref",
                          force=True, verbose=False)
    with fct_digests(TF, "_run") as got:
        port = TR.run_cell(cut(TM, cell_id, cuts), out=tmp_path / "port",
                           force=True, verbose=False, device="cpu")
    assert want and got == want
    assert_rows_equal(ref.rows, port.rows, cell_id)
    assert port.guards == ref.guards
    assert json.loads(port.path.read_text())["spec"] == \
        json.loads(json.dumps(cut(JM, cell_id, cuts).to_json()))
    assert {r["scheme"] for r in port.rows} == set(
        TR._resolve_schemes(cut(TM, cell_id, cuts)))
    return port


@pytest.mark.parametrize("cell_id", list(CUTS))
def test_cut_cell_rows_equal_reference(cell_id, tmp_path):
    check_cut(cell_id, tmp_path)


def test_fabric_record_matches_matrix():
    """The record covers the smoke tier's flow-level cells, each with the
    spec both matrices register; its rows carry no wall field and the
    reference passed every guard."""
    record = GOLD.load(GOLD.FABRIC_GOLDEN)
    assert tuple(record["cells"]) == GOLD.FABRIC_CELLS
    assert tuple(c.cell_id for c in TM.cells("smoke")
                 if c.engine == "flow") == GOLD.FABRIC_CELLS
    for cid, entry in record["cells"].items():
        assert entry["spec"] == json.loads(json.dumps(
            TM.CELLS[cid].to_json())), cid
        assert TM.CELLS[cid].to_json() == JM.CELLS[cid].to_json(), cid
        assert len(entry["rows"]) == len(TM.CELLS[cid].schemes), cid
        for row in entry["rows"]:
            assert not set(row) & set(GOLD.WALL_FIELDS), cid
        assert entry["guards"] and all(g["ok"] for g in entry["guards"])
        assert len(entry["fct_sha256"]) == len(entry["rows"]), cid


@pytest.mark.parametrize("cell_id", ["fabric.dragonfly1056.train.smoke",
                                     "fabric.dragonfly1056.midrun.smoke"])
def test_full_size_cell_equals_record(cell_id, tmp_path):
    """The two DF-1056 smoke cells at their registered sizes through the
    port's runner on the CPU: rows and each lane's ``fct`` bytes equal to
    the record, as ``chip_smoke.py`` holds them on the card (the SF-1134
    cell, ~45 s on the CPU, only there)."""
    want = GOLD.load(GOLD.FABRIC_GOLDEN)["cells"][cell_id]
    with fct_digests(TF, "_run") as got:
        res = TR.run_cell(TM.CELLS[cell_id], out=tmp_path, force=True,
                          verbose=False, device="cpu")
    assert GOLD.comparable(res.rows) == want["rows"]
    assert got == want["fct_sha256"]
    assert all(g["ok"] for g in res.guards)


def test_tables_equal_reference(capsys):
    assert TREP.scheme_table() == JREP.scheme_table()
    assert TREP.tier_table() == JREP.tier_table()
    assert TREP.matrix_table() == JREP.matrix_table()
    # the reference's generated block in EXPERIMENTS.md, marker lines
    # aside, is the port's block
    text = (REPO / "EXPERIMENTS.md").read_text()
    ref_block = text.split(JREP.MARK_BEGIN, 1)[1].split(JREP.MARK_END)[0]
    port_block = TREP.tables_block()
    assert port_block.startswith(TREP.MARK_BEGIN)
    assert port_block.split(TREP.MARK_BEGIN, 1)[1].split(
        TREP.MARK_END)[0] == ref_block
    assert CLI.main(["tables", "--print"]) == 0
    assert capsys.readouterr().out == port_block + "\n"


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_reports_leave_root_documents_alone(tmp_path, monkeypatch, capsys):
    """``run`` (which renders a report by default) and ``tables`` write
    under ``results/exp_torch/`` of the working directory; the root
    ``RESULTS.md`` and ``EXPERIMENTS.md`` stay byte for byte."""
    before = {n: _digest(REPO / n) for n in ("RESULTS.md", "EXPERIMENTS.md")}
    monkeypatch.chdir(tmp_path)
    cid = "memory.multi.endpoint_memory.small"
    assert CLI.main(["run", "--cells", cid, "--device", "cpu"]) == 0
    report = tmp_path / "results/exp_torch/RESULTS.md"
    assert TR.default_results_md() == Path("results/exp_torch/RESULTS.md")
    text = report.read_text()
    assert f"`{cid}`" in text and "python -m repro_torch.exp run" in text
    other = tmp_path / "elsewhere.md"
    assert CLI.main(["run", "--cells", cid, "--device", "cpu",
                     "--results-md", str(other)]) == 0
    assert other.is_file()
    assert CLI.main(["tables"]) == 0
    tables = tmp_path / TREP.DEFAULT_TABLES
    assert tables.read_text() == TREP.tables_block() + "\n"
    assert CLI.main(["tables"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("unchanged")
    assert {n: _digest(REPO / n) for n in before} == before


def reference_record() -> dict:
    cells = {}
    with tempfile.TemporaryDirectory() as out:
        for cid in GOLD.FABRIC_CELLS:
            with fct_digests(JF, "simulate") as digests:
                res = JR.run_cell(JM.CELLS[cid], out=Path(out), force=True,
                                  verbose=False)
            cells[cid] = {"spec": JM.CELLS[cid].to_json(),
                          "rows": GOLD.comparable(res.rows),
                          "guards": [{k: g[k] for k in ("desc", "ok")}
                                     for g in res.guards],
                          "fct_sha256": digests}
            print(f"{cid}: {len(res.rows)} rows, {res.wall_s} s", flush=True)
    return {"source": "repro.exp.runner.run_cell on the CPU",
            "wall_fields_dropped": list(GOLD.WALL_FIELDS), "cells": cells}


def check_result(path: Path) -> bool:
    """The port's result file at ``path`` against the reference runner's
    rows for the same cell: prints each row's epochs on both sides, the
    totals and the reference's water-fill calls (epochs that ran a fill),
    and returns whether every row is equal."""
    port = json.loads(path.read_text())
    cid = port["cell_id"]
    fills = [0]
    inner = JF._maxmin_rates_dense

    def fill(*a, **kw):
        fills[0] += 1
        return inner(*a, **kw)

    JF._maxmin_rates_dense = fill
    try:
        with tempfile.TemporaryDirectory() as out:
            ref = JR.run_cell(JM.CELLS[cid], out=Path(out), force=True,
                              verbose=False)
    finally:
        JF._maxmin_rates_dense = inner
    want, got = GOLD.comparable(ref.rows), GOLD.comparable(port["rows"])
    for w, g in zip(want, got):
        print(f"{w.get('scheme')} load {w.get('load')}: epochs reference "
              f"{w.get('epochs')}, port {g.get('epochs')}; "
              f"{'equal' if w == g else 'DIFFERENT'}")
    equal = want == got
    print(f"{cid}: {len(want)} reference rows, {len(got)} port rows, "
          f"{'all equal' if equal else 'NOT equal'}; epochs reference "
          f"{sum(r.get('epochs', 0) for r in want)}, port "
          f"{sum(r.get('epochs', 0) for r in got)}; reference water-fill "
          f"calls {fills[0]}; reference wall {ref.wall_s} s on the CPU")
    return equal


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--check"] and len(args) == 2:
        sys.exit(0 if check_result(Path(args[1])) else 1)
    if args != ["--write"]:
        sys.exit("usage: test_torch_exp_flow.py --write | --check RESULT")
    GOLD.FABRIC_GOLDEN.write_text(json.dumps(reference_record(), indent=1)
                                  + "\n")
    print(f"wrote {GOLD.FABRIC_GOLDEN}")
