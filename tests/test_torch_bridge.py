"""The port's trainer-to-fabric bridge (``repro_torch.fabric.bridge``)
equals the reference's (``repro.fabric.bridge``) on the CPU.

The mesh embedding, the three collective expanders, the cell
collectives and flow sets, the packet lowering, ``collective_time_us``
and ``fabric_report`` at flow level (with and without a failure plan)
and, with ``packet_level=True``, through both packages' ``run_batch``,
on DF(4,2,2) and SF(5, p=2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fabric import bridge as JB  # noqa: E402
from repro.net.sim import failures as JFF  # noqa: E402
from repro_torch.fabric import bridge as TB  # noqa: E402
from repro_torch.net.sim import failures as TFF  # noqa: E402

from test_torch_build import _same_flows  # noqa: E402
from test_torch_flowsim import TOPOS  # noqa: E402


@pytest.mark.parametrize("topo", ["df", "sf"])
@pytest.mark.parametrize("n_devices,tp", [(64, 4), (72, 8), (16, 16),
                                          (48, 2)])
def test_embed_mesh_equal(topo, n_devices, tp):
    ja, ta = TOPOS[topo]
    a, b = JB.embed_mesh(ja, n_devices, tp), TB.embed_mesh(ta, n_devices, tp)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["allreduce_ring", "allreduce_butterfly",
                                  "alltoall"])
@pytest.mark.parametrize("n", [2, 5, 8, 13])
def test_expanders_equal(kind, n):
    eps = [3 * i + 1 for i in range(n)]
    a = JB._EXPAND[kind](eps, 123457.0)
    b = TB._EXPAND[kind](eps, 123457.0)
    _same_flows(a, b)
    assert all(type(f).__module__ == "repro_torch.fabric.flowsim" for f in b)


@pytest.mark.parametrize("topo", ["df", "sf"])
@pytest.mark.parametrize("kind", ["train", "alltoall"])
def test_cell_flows_equal(topo, kind):
    ja, ta = TOPOS[topo]
    a = JB.cell_flows(ja, kind, 2e5, n_chips=64, tp=8)
    b = TB.cell_flows(ta, kind, 2e5, n_chips=64, tp=8)
    _same_flows(a, b)
    ca = JB.cell_collectives(ja, kind, 2e5, n_chips=64, tp=8)
    cb = TB.cell_collectives(ta, kind, 2e5, n_chips=64, tp=8)
    assert [dataclasses.astuple(c) for c in ca] == \
        [dataclasses.astuple(c) for c in cb]
    _same_flows(JB.to_packet_flows(a), TB.to_packet_flows(b))


@pytest.mark.parametrize("kind", ["allreduce_ring", "allreduce_butterfly",
                                  "alltoall"])
@pytest.mark.parametrize("scheme", ["ecmp", "spritz_spray_w"])
def test_collective_time_equal(kind, scheme):
    ja, ta = TOPOS["df"]
    eps = [0, 9, 20, 33, 41, 57, 64, 70]
    a = JB.collective_time_us(ja, JB.CollectiveSpec(kind, eps, 3e5), scheme,
                              seed=1)
    b = TB.collective_time_us(ta, TB.CollectiveSpec(kind, eps, 3e5), scheme,
                              seed=1, device="cpu")
    assert a == b and b["fct_us"] > 0


@pytest.mark.parametrize("topo", ["df", "sf"])
def test_fabric_report_flow_level_equal(topo):
    ja, ta = TOPOS[topo]
    kw = dict(n_chips=64, tp=8, seed=3)
    a = JB.fabric_report(ja, "train", 4e5, **kw)
    b = TB.fabric_report(ta, "train", 4e5, device="cpu", **kw)
    assert a == b and list(b) == list(TB.DEFAULT_SCHEMES)
    links = JFF.sample_links(ja, 3, seed=1)
    a = JB.fabric_report(ja, "alltoall", 1e5, schemes=("ecmp", "ops_u"),
                         failure_plan=JFF.FailureSchedule(ja)
                         .fail_links(16, links).recover(2048),
                         max_paths=16, **kw)
    b = TB.fabric_report(ta, "alltoall", 1e5, schemes=("ecmp", "ops_u"),
                         failure_plan=TFF.FailureSchedule(ta)
                         .fail_links(16, links).recover(2048),
                         max_paths=16, device="cpu", **kw)
    assert a == b


def test_fabric_report_packet_level_equal():
    """The collective flow set lowered onto both packages' packet engines
    (one ``run_batch`` each): every reported field equal."""
    ja, ta = TOPOS["df"]
    kw = dict(schemes=("ecmp", "spritz_spray_w"), n_chips=16, tp=4, seed=2,
              packet_level=True, n_ticks=1 << 12)
    a = JB.fabric_report(ja, "train", 3e4, **kw)
    b = TB.fabric_report(ta, "train", 3e4, device="cpu", **kw)
    assert a == b
    assert all(v["done_frac"] == 1.0 for v in b.values())
