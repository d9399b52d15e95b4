"""The port's flow-level engine under failure and capacity plans equals
the reference's bit for bit on the CPU.

Each plan is built twice, with the reference's and with the port's
``net.sim.failures`` (the two compile the same arrays), over contended
flow sets on DF(4,2,2) and SF(5, p=2): a mid-run outage with recovery,
a brownout to a quarter of line rate, links dead from t = 0 (the forced
epoch-0 lane), an outage that never recovers (static schemes stall for
good) and a seeded chaos schedule.  Every registered scheme's
``FlowResult`` must be equal: the ``fct`` bytes, ``reselections``,
``epochs``, ``forced`` and ``rate_violations``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fabric import flowsim as JF  # noqa: E402
from repro.net.policies import registry as JREG  # noqa: E402
from repro.net.sim import failures as JFF  # noqa: E402
from repro_torch.fabric import flowsim as TF  # noqa: E402
from repro_torch.net.sim import failures as TFF  # noqa: E402

from test_torch_flowsim import (TOPOS, assert_same_result,  # noqa: E402
                                contended)

SCHEMES = JREG.names()

PLANS = {
    "midrun": lambda FF, topo, links: (FF.FailureSchedule(topo)
                                       .fail_links(64, links)
                                       .recover(1 << 14)),
    "degraded": lambda FF, topo, links: FF.FailureSchedule(topo)
    .degrade_links(64, links, 0.25, until=4000),
    "t0": lambda FF, topo, links: (FF.FailureSchedule(topo)
                                   .fail_links(0, links).recover(1 << 12)),
    "no_recovery": lambda FF, topo, links: FF.FailureSchedule(topo)
    .fail_links(32, links),
    "chaos": lambda FF, topo, links: FF.chaos_schedule(
        topo, horizon=2000, seed=3, n_events=4, max_links=3),
}


def both(topo_key, plan, scheme, seed=2, n_links=4, link_seed=2):
    ja, ta = TOPOS[topo_key]
    jf, tf = contended(topo_key, seed=1, pkts=32)
    links = JFF.sample_links(ja, n_links, seed=link_seed)
    assert links == TFF.sample_links(ta, n_links, seed=link_seed)
    a = JF.simulate(ja, jf, scheme, seed=seed,
                    failure_plan=PLANS[plan](JFF, ja, links))
    b = TF.simulate(ta, tf, scheme, seed=seed,
                    failure_plan=PLANS[plan](TFF, ta, links), device="cpu")
    assert_same_result(a, b, (topo_key, plan, scheme))
    return b


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_equals_reference_df(plan, scheme):
    res = both("df", plan, scheme)
    assert res.rate_violations == 0
    rule = JREG.flow_rule(scheme)
    if plan in ("midrun", "t0") and rule.kind != "static":
        assert res.forced > 0            # dead current paths were left
    if plan == "no_recovery" and rule.kind == "static":
        assert (res.fct < 0).any()       # pinned flows never finish


@pytest.mark.parametrize("plan", ["midrun", "degraded", "t0"])
@pytest.mark.parametrize("scheme", ["ecmp", "ugal_l", "ops_u", "reps",
                                    "spritz_spray_w"])
def test_plan_equals_reference_sf(plan, scheme):
    both("sf", plan, scheme)


def test_compiled_plan_accepted():
    """A compiled ``FailurePlan`` runs as its schedule does, and compiles
    to the reference's byte-time events."""
    ja, ta = TOPOS["df"]
    links = JFF.sample_links(ja, 4, seed=2)
    js, ts = PLANS["degraded"](JFF, ja, links), \
        PLANS["degraded"](TFF, ta, links)
    for x, y in zip(JF._compile_plan(ja, js), TF._compile_plan(ta, ts)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    _, tf = contended("df", seed=1, pkts=32)
    a = TF.simulate(ta, tf, "spritz_spray_w", failure_plan=ts, device="cpu")
    b = TF.simulate(ta, tf, "spritz_spray_w", failure_plan=ts.compile(),
                    device="cpu")
    assert_same_result(a, b)


def test_batch_under_plan_equals_reference():
    ja, ta = TOPOS["df"]
    jf, tf = contended("df", seed=1, pkts=32)
    links = JFF.sample_links(ja, 4, seed=2)
    names = ["ecmp", "flicr_w", "spritz_scout"]
    want = JF.simulate_batch(ja, jf, names, seeds=[0, 1],
                             failure_plan=PLANS["midrun"](JFF, ja, links))
    got = TF.simulate_batch(ta, tf, names, seeds=[0, 1],
                            failure_plan=PLANS["midrun"](TFF, ta, links),
                            device="cpu")
    for name in names:
        for a, b in zip(want[name], got[name]):
            assert_same_result(a, b, name)
