"""The port's cross-engine executor gives the reference runner's rows on
a cut-down copy of ``fabric.dragonfly1056.cross.full``: one DF-1056
train collective through both the flow-level and the packet engine,
every row field equal (the packet/flow ratio ``xratio`` included), the
wall-time fields excluded, and the guard verdicts equal.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_exp_flow import check_cut  # noqa: E402

CELL = "fabric.dragonfly1056.cross.full"
CUTS = {CELL: dict(workload_kw={"n_chips": 32, "tp": 16, "shard": 4e4},
                   n_ticks=1 << 10)}


def test_cut_cell_rows_equal_reference(tmp_path):
    port = check_cut(CELL, tmp_path, CUTS)
    for r in port.rows:
        assert r["flow_done_frac"] == r["packet_done_frac"] == 1.0
        assert r["xratio"] > 0 and r["steps"] > 0
