"""The port's experiment runner gives the reference's rows on the smoke
tier's packet cells, and ``smoke_cells_golden.json`` stays the
reference's record of the registered cells.

Cut-down copies of the cells (:data:`CUTS`) run through
``repro.exp.runner`` (JAX on the CPU) and ``repro_torch.exp.runner``
(``device="cpu"``); every row field must be equal, the wall-time fields
excluded, and so must the guard verdicts.  Each cut keeps its cell's
topology, workload builder, failure plan, guards and pseudo spec keys,
and shrinks only the scheme set (two schemes) and the sizes, so the
seven cells fit the tier-1 budget.  The failover cells
(``test_torch_exp_failover.py``) and the open-loop cell
(``test_torch_exp_openloop.py``) have files of their own, so that the
three share no worker.

``chip_smoke.py`` runs the registered cells at full size on the card
against the record.  Regenerate the record (the reference's runner over
every cell of ``data.SMOKE_CELLS``, about four minutes on the CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_exp_packet.py --write
"""
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.exp import matrix as JM  # noqa: E402
from repro.exp import runner as JR  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402
from repro_torch.exp import matrix as TM  # noqa: E402
from repro_torch.exp import runner as TR  # noqa: E402

CUTS = {
    "micro.dragonfly.adversarial.smoke": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"size_pkts": 32, "seed": 1}),
    "failures.dragonfly.midrun.smoke": dict(
        schemes=("ops_u", "spritz_spray_w"),
        workload_kw={"size_pkts": 32, "seed": 6}),
    "collectives.slimfly.alltoall.smoke": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"kind": "alltoall", "m": 8, "total_mib": 0.0625,
                     "bg_pkts": 16, "seed": 2}),
    "engine.dragonfly.probe.smoke": dict(),
    "chaos.dragonfly.s7.smoke": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"size_pkts": 32, "seed": 6}),
    "engine.dragonfly1056.permutation.quick": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"size_pkts": 1, "seed": 1}),
    "serve.dragonfly.websearch.smoke": dict(
        schemes=("ecmp", "spritz_spray_w"),
        workload_kw={"fidelity": "packet", "loads": (0.3, 0.6, 0.9),
                     "horizon_ticks": 96, "size_cap_pkts": 16,
                     "drain_ticks": 160, "warmup_frac": 0.25,
                     "window_frac": 0.25, "seed": 4}),
}
assert tuple(CUTS) == GOLD.SMOKE_CELLS


def cut(matrix, cell_id: str):
    """``cell_id``'s registered cell of ``matrix``, cut down."""
    return dataclasses.replace(matrix.CELLS[cell_id],
                               cell_id=f"{cell_id}.cut", **CUTS[cell_id])


def both(cell_id: str, out):
    """(reference result, port result) of the cut cell, each written
    under ``out``."""
    ref = JR.run_cell(cut(JM, cell_id), out=out / "ref", force=True,
                      verbose=False)
    port = TR.run_cell(cut(TM, cell_id), out=out / "port", force=True,
                       verbose=False, device="cpu")
    return ref, port


def assert_rows_equal(ref_rows, port_rows, ctx):
    """Every row field equal, the wall-time fields excluded."""
    want, got = GOLD.comparable(ref_rows), GOLD.comparable(port_rows)
    assert len(got) == len(want), ctx
    for i, (a, b) in enumerate(zip(want, got)):
        diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                if a.get(k) != b.get(k)}
        assert not diff, (ctx, i, diff)


@pytest.mark.parametrize("cell_id", [
    "micro.dragonfly.adversarial.smoke",
    "collectives.slimfly.alltoall.smoke",
    "engine.dragonfly.probe.smoke",
    "engine.dragonfly1056.permutation.quick",
])
def test_cut_cell_rows_equal_reference(cell_id, tmp_path):
    ref, port = both(cell_id, tmp_path)
    assert_rows_equal(ref.rows, port.rows, cell_id)
    assert port.guards == ref.guards
    obj = json.loads(port.path.read_text())
    assert obj["spec"] == cut(JM, cell_id).to_json()


def test_smoke_record_matches_matrix():
    """The record covers the smoke tier's packet-engine cells, each with
    the spec both matrices register, and its rows carry no wall field."""
    record = GOLD.load(GOLD.SMOKE_GOLDEN)
    assert tuple(record["cells"]) == GOLD.SMOKE_CELLS
    smoke = [c.cell_id for c in TM.cells("smoke")
             if c.engine == "packet"
             or dict(c.workload_kw).get("fidelity") == "packet"]
    assert tuple(smoke) == GOLD.SMOKE_CELLS
    for cid, entry in record["cells"].items():
        # through JSON, as the record holds it (tuples become lists)
        spec = json.loads(json.dumps(TM.CELLS[cid].to_json()))
        assert entry["spec"] == spec, cid
        assert TM.CELLS[cid].to_json() == JM.CELLS[cid].to_json(), cid
        assert entry["rows"], cid
        for row in entry["rows"]:
            assert not set(row) & set(GOLD.WALL_FIELDS), cid
        # the reference passed every guard of the cell
        assert all(g["ok"] for g in entry["guards"]), cid


def reference_record() -> dict:
    cells = {}
    with tempfile.TemporaryDirectory() as out:
        for cid in GOLD.SMOKE_CELLS:
            res = JR.run_cell(JM.CELLS[cid], out=Path(out), force=True,
                              verbose=False)
            cells[cid] = {"spec": JM.CELLS[cid].to_json(),
                          "rows": GOLD.comparable(res.rows),
                          "guards": [{k: g[k] for k in ("desc", "ok")}
                                     for g in res.guards]}
            print(f"{cid}: {len(res.rows)} rows, {res.wall_s} s", flush=True)
    return {"source": "repro.exp.runner.run_cell, JAX on the CPU",
            "wall_fields_dropped": list(GOLD.WALL_FIELDS), "cells": cells}


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: test_torch_exp_packet.py --write")
    GOLD.SMOKE_GOLDEN.write_text(json.dumps(reference_record(), indent=1)
                                 + "\n")
    print(f"wrote {GOLD.SMOKE_GOLDEN}")
