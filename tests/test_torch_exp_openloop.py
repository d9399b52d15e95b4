"""The port's open-loop executor gives the reference's rows on a cut-down
copy of ``serve.dragonfly.websearch.smoke``: Poisson web-search arrivals
at three loads through the packet engine, segmented at every window
boundary with ``run_batch(until_tick=, resume=)``, queue depths from each
segment's carry.  Every row field must be equal, the wall-time field
excluded (the steady-state percentiles, the per-window series and the
``qdepth_*`` snapshots included), and so must the guard verdicts.  At
flow fidelity (``serve.dragonfly1056.websearch.quick``, cut down) the
executor's rows equal the reference executor's.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402

import test_torch_exp_packet as X  # noqa: E402
from repro.exp import matrix as JM  # noqa: E402
from repro.exp import openloop as JOL  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402
from repro_torch.exp import matrix as TM  # noqa: E402
from repro_torch.exp import openloop as OL  # noqa: E402

CELL = "serve.dragonfly.websearch.smoke"


def test_cut_cell_rows_equal_reference(tmp_path):
    ref, port = X.both(CELL, tmp_path)
    X.assert_rows_equal(ref.rows, port.rows, CELL)
    assert port.guards == ref.guards
    loads = {r["load"] for r in port.rows}
    assert loads == {0.3, 0.6, 0.9}
    for r in port.rows:
        assert r["windows"] and r["qdepth_max"] >= 0


def test_flow_fidelity_raises():
    """(The name is from before the flow engine was ported.)  The flow
    fidelity through both executors, one load, three schemes, two seeds:
    rows equal, wall fields excluded, steady windows included."""
    kw = {"fidelity": "flow", "loads": (0.6,), "horizon_ticks": 48,
          "size_cap_pkts": 24, "max_flows": 200, "warmup_frac": 0.25,
          "window_frac": 0.25, "seed": 3, "max_paths": 16}
    cid = "serve.dragonfly1056.websearch.quick"
    schemes, seeds = ["ecmp", "ugal_l", "spritz_spray_w"], [0, 1]
    want = JOL.run_openloop_cell(
        dataclasses.replace(JM.CELLS[cid], workload_kw=kw), schemes, seeds,
        verbose=False)
    got = OL.run_openloop_cell(
        dataclasses.replace(TM.CELLS[cid], workload_kw=kw), schemes, seeds,
        verbose=False, device="cpu")
    X.assert_rows_equal(want, got, cid)
    assert len(got) == 6 and all(r["windows"] for r in got)
    assert all(r["table_wall_s"] >= 0 for r in got)
    assert set(GOLD.comparable(got)[0]) == set(got[0]) - {"wall_s",
                                                          "table_wall_s"}
    with pytest.raises(ValueError, match="unknown openloop fidelity"):
        OL.run_openloop_cell(
            dataclasses.replace(TM.CELLS[cid], workload_kw=dict(
                kw, fidelity="bogus")), schemes, seeds, verbose=False,
            device="cpu")
