"""The port's failure/capacity schedule builder equals the reference's.

``repro_torch.net.sim.failures`` is a numpy copy of
``repro.net.sim.failures``: every builder compiles the same
``FailurePlan`` arrays (event ticks, ports, up flags, intervals) on the
same topology, raises the same ``ValueError``s, and the interval oracle
``port_ivl_at`` agrees.  Checked on
DF(4,2,2) and, for the two plans ``chip_smoke.py`` runs, on DF-1056.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.net.sim import build as JB  # noqa: E402
from repro.net.sim import failures as JF  # noqa: E402
from repro.net.topology import dragonfly as JDF  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402
from repro_torch.net.sim import build as TB  # noqa: E402
from repro_torch.net.sim import failures as TF  # noqa: E402
from repro_torch.net.topology import dragonfly as TDF  # noqa: E402

JDF422, TDF422 = JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
PLAN_ARRAYS = ("event_tick", "port_id", "port_up", "event_ivl")


def _same_plan(a, b):
    for k in PLAN_ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _links(mod, topo, n=4, seed=3):
    return mod.sample_links(topo, n, seed=seed)


# each builder: fn(failures module, topology) -> schedule
BUILDERS = {
    "fail_links": lambda m, t: m.FailureSchedule(t).fail_links(
        10, _links(m, t)),
    "recover": lambda m, t: m.FailureSchedule(t).fail_links(
        60, _links(m, t, 3)).degrade_links(80, _links(m, t, 2, 9), 0.5)
    .recover(2500),
    "flap": lambda m, t: m.FailureSchedule(t).flap(
        _links(m, t, 2), period=256, at=64, until=4000, down_frac=0.3),
    "fail_switch": lambda m, t: m.FailureSchedule(t).fail_switch(40, 3)
    .recover_switch(900, 3),
    "degrade_links": lambda m, t: m.FailureSchedule(t).degrade_links(
        60, _links(m, t), 0.25, until=6000),
    "drain_switch": lambda m, t: m.FailureSchedule(t).drain_switch(
        100, 5, over=300, steps=4, until=1000),
    "oversubscribe": lambda m, t: m.FailureSchedule(t).oversubscribe(
        30, _links(m, t, 2), 4.0, until=700)
    .background_tenant(50, _links(m, t, 1, 11), 0.75),
    "set_port_ivl": lambda m, t: m.FailureSchedule(t).set_port_ivl(
        0, [1, 2, 3], 7).set_ports(5, [2], up=False).set_rate(
        5, _links(m, t, 1), 0.125),
    "static_plan": lambda m, t: m.static_plan(t, _links(m, t, 3), at=0),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_schedule_compiles_equal(name):
    a = BUILDERS[name](JF, JDF422)
    b = BUILDERS[name](TF, TDF422)
    pa = a if hasattr(a, "event_tick") else a.compile()
    pb = b if hasattr(b, "event_tick") else b.compile()
    _same_plan(pa, pb)
    assert pa.n_events > 0 and pa.has_rate_events == pb.has_rate_events
    n = TDF422.n_ports
    for t in (0, 5, 64, 100, 333, 2499, 2500, 10000):
        np.testing.assert_array_equal(pa.port_ivl_at(t, n),
                                      pb.port_ivl_at(t, n))


@pytest.mark.parametrize("seed", [0, 7, 42, 99])
def test_chaos_schedule_compiles_equal(seed):
    _same_plan(JF.chaos_schedule(JDF422, horizon=4096, seed=seed).compile(),
               TF.chaos_schedule(TDF422, horizon=4096, seed=seed).compile())


def test_link_helpers_and_rates_equal():
    assert JF.all_links(JDF422) == TF.all_links(TDF422)
    for k, seed in ((1, 0), (5, 3), (29, 5)):
        assert JF.sample_links(JDF422, k, seed=seed) == \
            TF.sample_links(TDF422, k, seed=seed)
    assert JF.MAX_IVL == TF.MAX_IVL
    for r in (0.0, 2e-5, 0.125, 0.3, 0.5, 2 / 3, 1.0):
        assert JF.rate_to_ivl(r) == TF.rate_to_ivl(r)
    for ivl in (0, 1, 3, 65536):
        assert JF.ivl_to_rate(ivl) == TF.ivl_to_rate(ivl)


# each bad call: fn(failures module, topology), the ValueError's text
BAD = {
    "rate above 1": (lambda m, t: m.rate_to_ivl(1.5), "within"),
    "rate too small": (lambda m, t: m.rate_to_ivl(1e-6), "interval"),
    "interval range": (lambda m, t: m.FailureSchedule(t).set_port_ivl(
        0, [0], m.MAX_IVL + 1), "interval"),
    "negative tick": (lambda m, t: m.FailureSchedule(t).set_port_ivl(
        -5, [0], 1), ">= 0"),
    "port range": (lambda m, t: m.FailureSchedule(t).set_ports(
        0, [t.n_ports], up=False), "port"),
    "no link": (lambda m, t: m.FailureSchedule(t).fail_links(0, [(0, 0)]),
                "no link"),
    "switch range": (lambda m, t: m.FailureSchedule(t).fail_switch(
        0, t.n_switches), "switch"),
    "until before at": (lambda m, t: m.FailureSchedule(t).degrade_links(
        50, _links(m, t, 1), 0.5, until=40), "until"),
    "oversubscribe below 1": (lambda m, t: m.FailureSchedule(t)
                              .oversubscribe(0, _links(m, t, 1), 0.5),
                              "factor"),
    "tenant share": (lambda m, t: m.FailureSchedule(t).background_tenant(
        0, _links(m, t, 1), 1.0), "share"),
    "drain span": (lambda m, t: m.FailureSchedule(t).drain_switch(
        0, 1, over=-1), "span"),
    "drain until": (lambda m, t: m.FailureSchedule(t).drain_switch(
        0, 1, over=100, until=50), "drain end"),
    "flap period": (lambda m, t: m.FailureSchedule(t).flap(
        _links(m, t, 1), period=0, until=10), "period"),
    "flap down_frac": (lambda m, t: m.FailureSchedule(t).flap(
        _links(m, t, 1), period=4, until=10, down_frac=1.0), "down_frac"),
    "chaos horizon": (lambda m, t: m.chaos_schedule(t, horizon=4, seed=0),
                      "horizon"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_same_value_errors(case):
    fn, match = BAD[case]
    msgs = []
    for m, t in ((JF, JDF422), (TF, TDF422)):
        with pytest.raises(ValueError, match=match) as e:
            fn(m, t)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_failure_plan_validates_like_reference():
    from repro.net.sim.types import FailurePlan as JPlan
    from repro_torch.net.sim.types import FailurePlan as TPlan
    i32 = np.int32
    for args in ((np.asarray([5, 3], i32), np.asarray([0, 1], i32),
                  np.asarray([False, False])),
                 (np.asarray([-2], i32), np.asarray([0], i32),
                  np.asarray([False])),
                 (np.asarray([1], i32), np.asarray([0, 1], i32),
                  np.asarray([False])),
                 (np.asarray([1], i32), np.asarray([-3], i32),
                  np.asarray([False])),
                 (np.asarray([1], i32), np.asarray([0], i32),
                  np.asarray([True]), np.asarray([0], i32))):
        msgs = []
        for cls in (JPlan, TPlan):
            with pytest.raises(ValueError) as e:
                cls(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_build_spec_with_plan_equal():
    """build_spec carries a compiled plan (or a schedule) into the same
    ``fail_event_*`` arrays, and refuses a plan outside the topology."""
    flows = [(e, 40 + (e % 3), 96, 8 * e) for e in range(5)]
    specs = []
    for bmod, fmod, topo in ((JB, JF, JDF422), (TB, TF, TDF422)):
        fl = [bmod.Flow(s, d, n, start_tick=t) for s, d, n, t in flows]
        sched = BUILDERS["recover"](fmod, topo)
        specs.append(bmod.build_spec(topo, fl, "spritz_spray_w",
                                     n_ticks=1 << 13, failure_plan=sched,
                                     block_ticks=1024))
        bad = fmod.FailureSchedule(topo)
        bad._ev.append((3, topo.n_ports + 5, 0))
        with pytest.raises(ValueError, match="outside topology"):
            bmod.build_spec(topo, fl, "ecmp", failure_plan=bad)
    for k in ("fail_event_tick", "fail_event_port", "fail_event_up",
              "fail_event_ivl", "port_failed"):
        np.testing.assert_array_equal(getattr(specs[0], k),
                                      getattr(specs[1], k), err_msg=k)
    assert specs[1].block_ticks == 1024


@pytest.mark.parametrize("plan", sorted(GOLD.FAILOVER_PLANS))
def test_df1056_failover_plans_equal(plan):
    """The plans of the failover record, built with each package's
    ``failures`` module at DF-1056: 116 events (29 links down at 16, up
    at 528) and 288 (72 links at interval 4 over the same window)."""
    a = GOLD.failover_schedule(JF, JDF.make_dragonfly(8, 4, 4), plan)
    b = GOLD.failover_schedule(TF, TDF.make_dragonfly(8, 4, 4), plan)
    pa, pb = a.compile(), b.compile()
    _same_plan(pa, pb)
    assert pb.n_events == {"midrun": 116, "degraded": 288}[plan]
    assert pb.has_rate_events == (plan == "degraded")
    assert set(pb.event_tick.tolist()) == set(GOLD.FAILOVER_WINDOW)
