"""The port's experiment runner gives the reference's rows on the smoke
tier's failover cells: the mid-run link failure
(``failures.dragonfly.midrun.smoke``, with its ``postfail_*`` slice) and
the seeded chaos schedule (``chaos.dragonfly.s7.smoke``, with its
in-session healthy sweep and ``degrade_ratio``).  Cut-down copies
(``tests/test_torch_exp_packet.py``) run through both runners on the CPU;
every row field must be equal, the wall-time fields excluded, and so
must the guard verdicts.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_exp_packet as X  # noqa: E402


@pytest.mark.parametrize("cell_id", ["failures.dragonfly.midrun.smoke",
                                     "chaos.dragonfly.s7.smoke"])
def test_cut_cell_rows_equal_reference(cell_id, tmp_path):
    ref, port = X.both(cell_id, tmp_path)
    X.assert_rows_equal(ref.rows, port.rows, cell_id)
    assert port.guards == ref.guards
    if cell_id.startswith("failures"):
        assert all("postfail_fct_mean_us" in r for r in port.rows)
    else:
        assert all(r["degrade_ratio"] > 0 for r in port.rows)
