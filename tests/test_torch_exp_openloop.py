"""The port's open-loop executor gives the reference's rows on a cut-down
copy of ``serve.dragonfly.websearch.smoke``: Poisson web-search arrivals
at three loads through the packet engine, segmented at every window
boundary with ``run_batch(until_tick=, resume=)``, queue depths from each
segment's carry.  Every row field must be equal, the wall-time field
excluded (the steady-state percentiles, the per-window series and the
``qdepth_*`` snapshots included), and so must the guard verdicts.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_exp_packet as X  # noqa: E402
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
    cell = TM.CELLS["serve.dragonfly1056.websearch.quick"]
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        OL.run_openloop_cell(cell, ["ecmp"], [0], verbose=False,
                             device="cpu")
