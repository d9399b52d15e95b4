"""Failure timelines: the port's engine on the CPU equals the JAX reference.

Mirrors the engine cases of ``tests/test_failures.py`` with the same
specs: a destination's delivery port failed mid-flight, then recovered
(and never recovered), a flapping link, and the registry's failover
sweep, where every scheme runs solo under one mid-run fail/recover plan
(the reference test runs it as one ``run_batch``; the port has no batched
driver, so each scheme is held against the reference's solo run).  Each
case keeps the reference test's invariants (completion, no service
across a down port, packet conservation) and adds equality with the
reference run: every ``SimResult`` field, ``steps_executed``, the
violation counters and every final carry leaf, each policy substate
included.  Also: a plan whose events all fire at t = 0 equals the static
``failed_links`` build, ``steps_executed`` included, in both packages.
Tolerance: zero.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.policies import registry as REG  # noqa: E402
from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.sim.failures import (FailureSchedule, sample_links,  # noqa: E402
                                    static_plan)
from repro.net.sim.types import (P_ACKWAIT, P_LOST, P_NACKWAIT,  # noqa: E402
                                 P_PROP, P_QUEUED)
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402
from repro_torch.net.sim import types as TT  # noqa: E402

DF = make_dragonfly(4, 2, 2)
RESULT_FIELDS = ("fct_ticks", "delivered", "trims", "timeouts", "ooo",
                 "retx", "done")


def _links(topo, n=4, seed=3):
    return sample_links(topo, n, seed=seed)


def _port(spec, use_kernels=None):
    tspec = TT.spec_from_arrays(dataclasses.asdict(spec))
    tspec.use_kernels = use_kernels
    return tspec


def _conservation(res, state):
    """inj_cnt == delivered + timeouts + NACKs-received + still-in-table,
    with NACKs-received == trims - packets still awaiting their NACK."""
    F_ = len(res.fct_ticks)
    live = np.isin(state["pstate"],
                   [P_QUEUED, P_PROP, P_ACKWAIT, P_NACKWAIT, P_LOST])
    in_table = np.bincount(state["pflow"][live], minlength=F_)
    nackwait = np.bincount(state["pflow"][state["pstate"] == P_NACKWAIT],
                           minlength=F_)
    rhs = res.delivered + res.timeouts + (res.trims - nackwait) + in_table
    np.testing.assert_array_equal(state["inj_cnt"], rhs)


def same_run(got, gst, want, wst, ctx):
    """Every result field, counter and carry leaf equal, dtypes too."""
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{ctx} {name}")
    for name in ("ticks_simulated", "steps_executed", "down_violations",
                 "rate_violations"):
        assert getattr(got, name) == getattr(want, name), (ctx, name)
    assert set(gst) == set(wst), ctx
    for k, v in wst.items():
        if k in ("policy", "spritz"):
            continue
        assert gst[k].dtype == v.dtype, (ctx, k)
        np.testing.assert_array_equal(gst[k], v, err_msg=f"{ctx} {k}")
    assert list(gst["policy"]) == list(wst["policy"]), ctx
    for fam, sub in wst["policy"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(gst["policy"][fam][k], v,
                                          err_msg=f"{ctx} {fam}.{k}")


def both(spec, use_kernels=None, **kw):
    """The reference's and the port's run of ``spec``, held equal;
    returns the port's (result, state)."""
    want, wst = E.run(spec, return_carry=True, **kw)
    got, gst = TE.run(_port(spec, use_kernels), device="cpu",
                      return_carry=True, **kw)
    same_run(got, gst, want, wst, spec.name)
    return got, gst


@pytest.mark.parametrize("use_kernels", [None, False],
                         ids=["kernels", "torch_forms"])
def test_midrun_delivery_port_failure_stalls_then_recovers(use_kernels):
    """Fail a destination's delivery port mid-flight: the flow stalls
    into timeouts, then completes after the scheduled recovery (Scout
    re-probing the healed path); without the recovery it never does."""
    dst = 40
    flows = [B.Flow(0, dst, 64)]
    port = DF.delivery_port(dst)
    sched = (FailureSchedule(DF).set_ports(20, [port], up=False)
             .set_ports(6000, [port], up=True))
    spec = B.build_spec(DF, flows, "spritz_scout", n_ticks=1 << 15,
                        failure_plan=sched, block_ticks=1024)
    res, state = both(spec, use_kernels)
    assert res.done.all()
    assert res.timeouts.sum() > 0 or res.trims.sum() > 0
    assert int(res.fct_ticks[0]) + int(spec.start_tick[0]) > 6000
    assert res.down_violations == 0
    _conservation(res, state)
    assert state["fail_idx"] == 2 and state["port_up"].all()

    sched2 = FailureSchedule(DF).set_ports(20, [port], up=False)
    spec2 = B.build_spec(DF, flows, "spritz_scout", n_ticks=1 << 13,
                         failure_plan=sched2, block_ticks=1024)
    res2, state2 = both(spec2, use_kernels)
    assert not res2.done.any()
    assert res2.timeouts.sum() > 0
    assert res2.down_violations == 0
    assert not state2["port_up"][port]


@pytest.mark.parametrize("use_kernels", [None, False],
                         ids=["kernels", "torch_forms"])
def test_flapping_link_is_survivable(use_kernels):
    flows = [B.Flow(e, 40 + e, 128) for e in range(4)]
    sched = FailureSchedule(DF).flap(_links(DF, 2), period=256, at=64,
                                     until=4096)
    spec = B.build_spec(DF, flows, "spritz_spray_u", n_ticks=1 << 15,
                        failure_plan=sched, block_ticks=512)
    res, state = both(spec, use_kernels)
    assert res.done.all()
    assert res.down_violations == 0
    _conservation(res, state)


def test_dense_stepper_under_midrun_plan():
    """The port's dense stepper equals the reference's under a timeline
    too (the horizon must stop at every event tick for compressed to
    equal dense)."""
    sched = FailureSchedule(DF).fail_links(60, _links(DF, 3)).recover(700)
    spec = B.build_spec(DF, CONF_FLOWS, "spritz_scout", n_ticks=1 << 10,
                        failure_plan=sched, block_ticks=256)
    dense, _ = both(spec, reference=True)
    comp, _ = both(spec)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(dense, name),
                                      getattr(comp, name))
    assert dense.ticks_simulated == comp.ticks_simulated
    assert comp.steps_executed < dense.steps_executed


def test_t0_plan_equals_static_failed_links_build():
    """Events at tick 0 are initial conditions: a plan whose links all go
    down at t = 0 runs exactly like ``build_spec(failed_links=...)``,
    ``steps_executed`` included, in the port as in the reference."""
    links = _links(DF, 3)
    flows = [B.Flow(e, 40 + (e % 3), 64, start_tick=8 * e)
             for e in range(5)]
    kw = dict(n_ticks=1 << 13, block_ticks=1024)
    s_static = B.build_spec(DF, flows, "spritz_spray_w", failed_links=links,
                            **kw)
    s_plan = B.build_spec(DF, flows, "spritz_spray_w",
                          failure_plan=static_plan(DF, links), **kw)
    a, ast = both(s_static)
    b, bst = both(s_plan)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.ticks_simulated, a.steps_executed) == \
        (b.ticks_simulated, b.steps_executed)
    np.testing.assert_array_equal(ast["port_up"], bst["port_up"])
    assert not bst["port_up"].all()
    assert int(bst["fail_idx"]) == len(s_plan.fail_event_tick)


# the registry's failover sweep of tests/test_failures.py, same plan
CONF_FLOWS = [B.Flow(e, 40 + (e % 3), 96, start_tick=8 * e)
              for e in range(5)]


@pytest.fixture(scope="module")
def failover_base():
    sched = FailureSchedule(DF).fail_links(60, _links(DF, 3)).recover(2500)
    return B.build_spec(DF, CONF_FLOWS, "spritz_spray_w", n_ticks=1 << 13,
                        failure_plan=sched, block_ticks=1024)


@pytest.mark.parametrize("name", [p.name for p in REG.all_policies()])
def test_policy_failover_conformance(name, failover_base):
    res, state = both(B.respec_scheme(failover_base, name))
    assert res.down_violations == 0
    _conservation(res, state)
    assert state["inj_cnt"].sum() > 0
    # every event up to the last executed tick was applied, no later one
    assert int(state["fail_idx"]) == np.searchsorted(
        failover_base.fail_event_tick, res.ticks_simulated, side="right")
