"""The rest of the port's host layer equals the reference's.

Slim Fly (GF(q) arithmetic, the MMS graph, ``diameter``), the topology's
equal-cost next slots, path latencies and the Table IV memory formula,
every workload builder (collectives with their masks, web search, the
Fig. 5 and Fig. 8 scenarios), the open-loop arrival streams and the
steady-state statistics are numpy code copied into ``repro_torch``:
for the same arguments and seed every array, flow list and number must
be equal.  ``build_spec`` is held equal on the reduced Slim Fly and on
the paper's 1,134-endpoint one.  Tolerance: zero.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.net import arrivals as JA  # noqa: E402
from repro.net import paths as JP  # noqa: E402
from repro.net import steady as JS  # noqa: E402
from repro.net import workloads as JW  # noqa: E402
from repro.net.sim import build as JB  # noqa: E402
from repro.net.topology import dragonfly as JDF  # noqa: E402
from repro.net.topology import gf as JGF  # noqa: E402
from repro.net.topology import slimfly as JSF  # noqa: E402
from repro.net.workloads import collectives as JCOL  # noqa: E402
from repro.net.workloads import trace as JTR  # noqa: E402
from repro_torch.net import arrivals as TA  # noqa: E402
from repro_torch.net import paths as TP  # noqa: E402
from repro_torch.net import steady as TS  # noqa: E402
from repro_torch.net import workloads as TW  # noqa: E402
from repro_torch.net.sim import build as TB  # noqa: E402
from repro_torch.net.topology import dragonfly as TDF  # noqa: E402
from repro_torch.net.topology import gf as TGF  # noqa: E402
from repro_torch.net.topology import slimfly as TSF  # noqa: E402
from repro_torch.net.workloads import collectives as TCOL  # noqa: E402
from repro_torch.net.workloads import trace as TTR  # noqa: E402

from test_torch_build import _same_flows, _same_spec  # noqa: E402

SF_ARGS = [(5, 2), (5, None), (9, None)]
TOPO_ARRAYS = ("nbr", "nbr_type", "sw_group", "port_latency_ticks",
               "static_next", "dist")


def _pair(kind: str):
    if kind == "df":
        return JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
    return JSF.make_slimfly(5, p=2), TSF.make_slimfly(5, p=2)


@pytest.mark.parametrize("q", [3, 4, 5, 8, 9, 13])
def test_gf_tables_equal(q):
    a, b = JGF.GF(q), TGF.GF(q)
    assert (a.p, a.k, a._poly, a.primitive) == (b.p, b.k, b._poly,
                                                b.primitive)
    np.testing.assert_array_equal(a.add_table, b.add_table)
    np.testing.assert_array_equal(a.mul_table, b.mul_table)
    for x in range(q):
        assert a.neg(x) == b.neg(x)
        assert [a.pow(x, n) for n in range(q)] == \
            [b.pow(x, n) for n in range(q)]
        assert [a.sub(x, y) for y in range(q)] == \
            [b.sub(x, y) for y in range(q)]


def test_gf9_is_a_field():
    """GF(9) is an extension field: its tables are not arithmetic mod 9,
    and every nonzero element has an inverse and a power of the
    primitive element."""
    g = TGF.GF(9)
    assert (g.p, g.k) == (3, 2)
    assert not np.array_equal(g.mul_table,
                              np.outer(np.arange(9), np.arange(9)) % 9)
    for x in range(1, 9):
        assert (g.mul_table[x, 1:] == 1).sum() == 1
    assert sorted(g.pow(g.primitive, n) for n in range(8)) == \
        list(range(1, 9))
    with pytest.raises(ValueError):
        TGF.factor_prime_power(6)


@pytest.mark.parametrize("q,p", SF_ARGS)
def test_slimfly_equal(q, p):
    a, b = JSF.make_slimfly(q, p=p), TSF.make_slimfly(q, p=p)
    assert a.name == b.name and a.params == b.params
    for k in TOPO_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert a.diameter == b.diameter == 2
    assert (a.n_endpoints, a.n_ports, a.bdp_packets()) == \
        (b.n_endpoints, b.n_ports, b.bdp_packets())
    assert a.slot_of_edge == b.slot_of_edge


def test_slimfly_refuses_other_q():
    with pytest.raises(NotImplementedError):
        TSF.make_slimfly(7)


@pytest.mark.parametrize("kind", ["df", "sf"])
def test_min_next_slots_and_latency_equal(kind):
    a, b = _pair(kind)
    assert a.diameter == b.diameter
    assert a.min_next_slots == b.min_next_slots
    for s, d in [(0, 5), (3, 30), (7, 13), (12, 1)]:
        for pa, pb in zip(JP.enumerate_paths(a, s, d),
                          TP.enumerate_paths(b, s, d)):
            assert pa == pb
            assert JP.path_latency_ns(a, pa, s) == \
                TP.path_latency_ns(b, pb, s)
    for mp in (1, 7, 64):
        assert JP.endpoint_table_bytes(a, mp) == \
            TP.endpoint_table_bytes(b, mp)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["df", "sf"])
def test_collectives_equal(kind, seed):
    a, b = _pair(kind)
    for name, m in (("allreduce_ring", 8), ("allreduce_butterfly", 8),
                    ("alltoall", 16)):
        for bg in (True, False):
            fa, ma = getattr(JCOL, name)(a, m, 256, seed=seed,
                                         with_background=bg, bg_pkts=32)
            fb, mb = getattr(TCOL, name)(b, m, 256, seed=seed,
                                         with_background=bg, bg_pkts=32)
            _same_flows(fa, fb)
            np.testing.assert_array_equal(ma, mb)
    fct = np.random.default_rng(seed).integers(-1, 500, len(fa))
    start = np.array([f.start_tick for f in fa])
    assert JCOL.collective_duration(fct, start, ma) == \
        TCOL.collective_duration(fct, start, mb)
    fct = np.abs(fct)
    assert JCOL.collective_duration(fct, start, ma) == \
        TCOL.collective_duration(fct, start, mb) >= 0


@pytest.mark.parametrize("kind", ["df", "sf"])
def test_websearch_equal(kind):
    a, b = _pair(kind)
    for seed, load, cap in ((0, 1.0, None), (4, 0.6, 200), (9, 0.3, 40)):
        _same_flows(JW.websearch(a, 400, load=load, seed=seed,
                                 max_flows=cap),
                    TW.websearch(b, 400, load=load, seed=seed,
                                 max_flows=cap))
    assert JTR.mean_websearch_bytes() == TTR.mean_websearch_bytes()
    assert JTR.mean_websearch_wire_bytes() == TTR.mean_websearch_wire_bytes()
    np.testing.assert_array_equal(
        JTR.sample_websearch_bytes(np.random.default_rng(1), 1000),
        TTR.sample_websearch_bytes(np.random.default_rng(1), 1000))


@pytest.mark.parametrize("seed", [0, 2])
def test_motivational_and_incast_equal(seed):
    a, b = _pair("df")
    for solo in (False, True):
        fa, ia = JW.motivational(a, 64, 32, seed=seed, solo=solo,
                                 bg_flows_per_ep=2)
        fb, ib = TW.motivational(b, 64, 32, seed=seed, solo=solo,
                                 bg_flows_per_ep=2)
        _same_flows(fa, fb)
        assert ia == ib
    for n in (1, 20, 71):
        fa, ma = JW.incast_bystanders(a, n, 16, seed=seed)
        fb, mb = TW.incast_bystanders(b, n, 16, seed=seed)
        _same_flows(fa, fb)
        np.testing.assert_array_equal(ma, mb)
    with pytest.raises(ValueError):
        TW.incast_bystanders(b, 72, 16)
    assert TW.__all__ == JW.__all__


def _same_stream(x, y):
    for f in ("src_ep", "dst_ep", "size_pkts", "start_tick"):
        u, v = getattr(x, f), getattr(y, f)
        assert u.dtype == v.dtype, f
        np.testing.assert_array_equal(u, v, err_msg=f)
    assert (x.horizon_ticks, x.load, x.truncated) == \
        (y.horizon_ticks, y.load, y.truncated)
    assert x.offered_load(72) == y.offered_load(72)


@pytest.mark.parametrize("kw", [
    dict(load=0.3, horizon_ticks=512, seed=4, size_cap_pkts=64),
    dict(load=0.9, horizon_ticks=300, seed=1),
    dict(load=0.6, horizon_ticks=400, seed=2, size=8),
    dict(load=0.9, horizon_ticks=512, seed=0, size_cap_pkts=64,
         max_flows=50),
    dict(load=0.5, horizon_ticks=256, seed=7, endpoints=[3, 9, 40]),
])
def test_arrival_streams_equal(kw):
    a, b = _pair("df")
    x, y = JA.poisson_stream(a, **kw), TA.poisson_stream(b, **kw)
    _same_stream(x, y)
    _same_flows(x.to_packet_flows(), y.to_packet_flows())
    for f, g in zip(x.to_packet_flows(), y.to_packet_flows()):
        assert type(g) is TB.Flow
    _same_flows(x.to_flowspecs(), y.to_flowspecs())
    for f in y.to_flowspecs():
        assert type(f).__module__ == "repro_torch.fabric.flowsim"


def test_trace_stream_equal():
    rng = np.random.default_rng(5)
    cols = (rng.integers(0, 72, 40), rng.integers(0, 72, 40),
            rng.integers(1, 30, 40), rng.integers(0, 1000, 40))
    _same_stream(JA.trace_stream(*cols), TA.trace_stream(*cols))
    _same_stream(JA.trace_stream(*cols, horizon_ticks=2000),
                 TA.trace_stream(*cols, horizon_ticks=2000))
    empty = [np.zeros(0, np.int64)] * 4
    _same_stream(JA.trace_stream(*empty), TA.trace_stream(*empty))
    with pytest.raises(ValueError):
        TA.trace_stream(cols[0], cols[1][:3], cols[2], cols[3])
    with pytest.raises(ValueError):
        TA.trace_stream(cols[0], cols[1], np.zeros(40), cols[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steady_stats_equal(seed):
    rng = np.random.default_rng(seed)
    n = 300
    start = rng.integers(0, 1000, n)
    fct = np.where(rng.random(n) < 0.1, -1, rng.integers(1, 400, n))
    size = rng.integers(1, 64, n)
    for warm, win, hz in ((250, 250, 1000), (100, 333, 1000),
                          (0, 1000, 1000), (900, 50, 1000)):
        assert JS.window_stats(start, fct, size, warmup=warm, window=win,
                               horizon=hz) == \
            TS.window_stats(start, fct, size, warmup=warm, window=win,
                            horizon=hz)
    assert JS.mean_inflight(start, fct, 200, 800) == \
        TS.mean_inflight(start, fct, 200, 800)
    q_tail = rng.integers(0, 900, 500)
    for t in (0, 300, 1000):
        assert JS.queue_depth_ticks(q_tail, t) == \
            TS.queue_depth_ticks(q_tail, t)
    assert TS.queue_depth_ticks(np.zeros(0), 5) == \
        JS.queue_depth_ticks(np.zeros(0), 5)
    assert TS.percentile_or_empty([], 99) == TS.EMPTY == JS.EMPTY
    for bad in (dict(warmup=5, window=1, horizon=5),
                dict(warmup=0, window=0, horizon=5)):
        with pytest.raises(ValueError):
            TS.window_stats(start, fct, size, **bad)


@pytest.mark.parametrize("scheme", ["ecmp", "spritz_spray_w", "ugal_l",
                                    "reps"])
def test_build_spec_equal_sf(scheme):
    a, b = _pair("sf")
    fa, _ = JW.alltoall(a, 16, 256, seed=2, bg_pkts=64)
    fb, _ = TW.alltoall(b, 16, 256, seed=2, bg_pkts=64)
    _same_spec(JB.build_spec(a, fa, scheme, n_ticks=1 << 14),
               TB.build_spec(b, fb, scheme, n_ticks=1 << 14))


def test_build_spec_equal_sf1134():
    a, b = JSF.make_slimfly(9), TSF.make_slimfly(9)
    ja = JB.build_spec(a, JW.permutation(a, size_pkts=32, seed=1),
                       "spritz_spray_w", n_ticks=1 << 14)
    tb = TB.build_spec(b, TW.permutation(b, size_pkts=32, seed=1),
                       "spritz_spray_w", n_ticks=1 << 14)
    _same_spec(ja, tb)
    assert (tb.n_flows, tb.n_ports) == (1134, 3240)
    assert dataclasses.asdict(tb)["name"] == dataclasses.asdict(ja)["name"]
