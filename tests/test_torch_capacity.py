"""Capacity (brownout) timelines: the port's engine on the CPU equals the
JAX reference.

Mirrors the packet-engine cases of ``tests/test_capacity.py`` with the
same specs: an all-``rate=0`` schedule runs exactly like the binary
``fail_links`` plan (``steps_executed`` included; a binary plan runs no
rate machinery), a degraded run is clean and slower and its live
interval vector equals the host oracle ``plan.port_ivl_at(t)``, the
registry's degraded sweep (every scheme solo under one brownout plus
outage mix; the reference runs it as one ``run_batch``) and a seeded
chaos schedule.  Each case keeps the reference test's invariants (zero
rate and down violations, packet conservation, completion) and adds
equality with the reference run: every ``SimResult`` field,
``steps_executed``, ``rate_violations`` and every final carry leaf,
each policy substate included.  Under a degraded plan the port's phase E
takes the standalone ``tick_rank`` for the rank (its plain version on
the CPU), or the engine's torch form; both are covered.  Tolerance: zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.policies import registry as REG  # noqa: E402
from repro.net.sim import build as B  # noqa: E402
from repro.net.sim.failures import (FailureSchedule, chaos_schedule,  # noqa: E402
                                    sample_links)
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch.kernels import ops as KOPS  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402

from test_torch_timelines import (RESULT_FIELDS, _conservation,  # noqa: E402
                                  _port, both)

DF = make_dragonfly(4, 2, 2)
CONF_FLOWS = [B.Flow(e, 40 + (e % 3), 96, start_tick=8 * e)
              for e in range(5)]


def _links(topo, n=4, seed=3):
    return sample_links(topo, n, seed=seed)


@pytest.fixture
def phase_e_calls(monkeypatch):
    """Counts the engine's calls of the standalone rank and of the fused
    rank + RED/ECN wrapper (on the CPU each runs its plain version)."""
    calls = dict.fromkeys(("tick_rank", "tick_rank_red_ecn"), 0)
    for name in calls:
        fn = getattr(KOPS, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(KOPS, name, counted)
    return calls


def test_rate_zero_plan_is_bit_identical_to_fail_links_packet_engine(
        phase_e_calls):
    """rate=0 IS the binary down event: identical compiled arrays and
    identical runs, steps_executed included, in the port as in the
    reference; neither plan runs the rate machinery, so phase E stays
    the one fused rank + RED/ECN call."""
    links = _links(DF, 3)
    p_rate = (FailureSchedule(DF).set_rate(60, links, 0.0)
              .set_rate(2500, links, 1.0).compile())
    p_bin = (FailureSchedule(DF).fail_links(60, links)
             .recover_links(2500, links).compile())
    for name in ("event_tick", "port_id", "port_up", "event_ivl"):
        np.testing.assert_array_equal(getattr(p_rate, name),
                                      getattr(p_bin, name))
    specs = [B.build_spec(DF, CONF_FLOWS, "spritz_spray_w", n_ticks=1 << 13,
                          failure_plan=p, block_ticks=1024)
             for p in (p_rate, p_bin)]
    runs = [both(spec) for spec in specs]
    (a, ast), (b, bst) = runs
    assert phase_e_calls == {"tick_rank": 0,
                             "tick_rank_red_ecn": 2 * a.steps_executed}
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.ticks_simulated, a.steps_executed) == \
        (b.ticks_simulated, b.steps_executed)
    assert a.rate_violations == 0
    np.testing.assert_array_equal(ast["port_ivl"], 1)


@pytest.mark.parametrize("use_kernels", [None, False],
                         ids=["kernels", "torch_forms"])
def test_packet_engine_degraded_run_is_clean_and_slower(use_kernels,
                                                       phase_e_calls):
    links = _links(DF, 4)
    plan = FailureSchedule(DF).degrade_links(60, links, 0.25, until=6000)
    spec = B.build_spec(DF, CONF_FLOWS, "spritz_scout", n_ticks=1 << 14,
                        failure_plan=plan, block_ticks=1024)
    res, state = both(spec, use_kernels, seed=0)
    # the rate path ranks with the standalone tick_rank, once a step
    assert phase_e_calls == {
        "tick_rank": res.steps_executed if use_kernels is None else 0,
        "tick_rank_red_ecn": 0}
    assert res.done.all()
    assert res.rate_violations == 0 and res.down_violations == 0
    _conservation(res, state)
    healthy = TE.run(_port(B.build_spec(DF, CONF_FLOWS, "spritz_scout",
                                        n_ticks=1 << 14, block_ticks=1024),
                           use_kernels), device="cpu")
    assert res.fct_ticks.sum() > healthy.fct_ticks.sum()


def test_port_ivl_equals_plan_oracle():
    """``state["port_ivl"]`` equals ``plan.port_ivl_at(t)`` at the end of
    a degraded run stopped inside the brownout (the port's own plan
    oracle, and the reference's), and the rescaled ports hold interval 4."""
    links = _links(DF, 4)
    plan = FailureSchedule(DF).degrade_links(60, links, 0.25, until=6000)
    spec = B.build_spec(DF, CONF_FLOWS, "spritz_scout", n_ticks=1 << 14,
                        failure_plan=plan, block_ticks=1024)
    res, state = both(spec, until_tick=200)
    assert 200 <= res.ticks_simulated < 6000
    plan_c = plan.compile()
    want = plan_c.port_ivl_at(res.ticks_simulated, DF.n_ports)
    np.testing.assert_array_equal(state["port_ivl"], want)
    assert (state["port_ivl"] == 4).sum() == 2 * len(links)
    tplan = _port(spec).fail_event_ivl
    np.testing.assert_array_equal(tplan, plan_c.event_ivl)


# the registry's degraded sweep of tests/test_capacity.py, same plan
@pytest.fixture(scope="module")
def degraded_base():
    sched = (FailureSchedule(DF)
             .degrade_links(60, _links(DF, 3), 0.25)
             .fail_links(500, _links(DF, 2, seed=9))
             .recover(2500))
    return B.build_spec(DF, CONF_FLOWS, "spritz_spray_w", n_ticks=1 << 13,
                        failure_plan=sched, block_ticks=1024)


@pytest.mark.parametrize("name", [p.name for p in REG.all_policies()])
def test_policy_degraded_conformance(name, degraded_base):
    res, state = both(B.respec_scheme(degraded_base, name))
    assert res.rate_violations == 0
    assert res.down_violations == 0
    _conservation(res, state)
    assert state["inj_cnt"].sum() > 0
    assert (state["port_ivl"] == 4).any()      # the brownout was applied


def test_chaos_schedule_runs_clean_through_packet_engine():
    plan = chaos_schedule(DF, horizon=2048, seed=7)
    assert plan.compile().has_rate_events
    spec = B.build_spec(DF, CONF_FLOWS, "spritz_spray_u", n_ticks=1 << 14,
                        failure_plan=plan, block_ticks=512)
    res, state = both(spec, seed=0)
    assert res.done.all()
    assert res.rate_violations == 0 and res.down_violations == 0
    _conservation(res, state)
