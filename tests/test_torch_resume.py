"""Segmented runs: ``until_tick`` and ``resume`` in the port.

Mirrors ``tests/test_arrivals.py::test_resume_bit_identical_solo`` and
``::test_resume_rejects_mismatched_spec`` with the same open-loop
Poisson spec (built by the reference and carried across), port against
port: a run stopped at a window boundary and resumed from its
checkpoint equals the unsegmented run in every result field and carry
leaf.  Two cross-package cases: a reference checkpoint resumed in the
port and a port checkpoint resumed in the reference, each equal to the
unsegmented reference run.  Also a segmented run under a mid-run
failure plan cut inside the outage, and a degraded plan cut inside the
brownout.  Tolerance: zero.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.arrivals import poisson_stream  # noqa: E402
from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.sim.failures import FailureSchedule, sample_links  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402

from test_torch_timelines import _port, same_run  # noqa: E402

DF = make_dragonfly(4, 2, 2)


@pytest.fixture(scope="module")
def packet_spec():
    s = poisson_stream(DF, load=0.3, horizon_ticks=256, seed=4,
                       size="websearch", size_cap_pkts=32)
    return B.build_spec(DF, s.to_packet_flows(), "spritz_spray_w",
                        n_ticks=448, seed=0)


@pytest.fixture(scope="module")
def reference_full(packet_spec):
    return E.run(packet_spec, seed=0, return_carry=True)


def test_resume_bit_identical_solo(packet_spec, reference_full):
    tspec = _port(packet_spec)
    full, full_state = TE.run(tspec, seed=0, device="cpu",
                              return_carry=True)
    same_run(full, full_state, *reference_full, "unsegmented")
    res, st = TE.run(tspec, seed=0, device="cpu", until_tick=128,
                     return_carry=True)
    assert res.ticks_simulated >= 128       # stopped at the boundary
    assert res.ticks_simulated < full.ticks_simulated
    want, wst = E.run(packet_spec, seed=0, until_tick=128,
                      return_carry=True)
    same_run(res, st, want, wst, "first segment")
    res2, st2 = TE.run(tspec, resume=TE.checkpoint(res, st), device="cpu",
                       return_carry=True)
    same_run(res2, st2, full, full_state, "resumed")


def test_resume_three_segments_dense(packet_spec):
    """The dense stepper segments too, over three windows."""
    tspec = _port(packet_spec)
    full, full_state = TE.run(tspec, device="cpu", reference=True,
                              return_carry=True)
    cp = None
    for bound in (100, 250, None):
        res, st = TE.run(tspec, device="cpu", reference=True, resume=cp,
                         until_tick=bound, return_carry=True)
        if bound is not None:
            assert res.ticks_simulated == bound
        cp = TE.checkpoint(res, st)
    same_run(res, st, full, full_state, "dense segments")


def test_resume_rejects_mismatched_spec(packet_spec):
    tspec = _port(packet_spec)
    res, st = TE.run(tspec, seed=0, device="cpu", until_tick=64,
                     return_carry=True)
    other = poisson_stream(DF, load=0.3, horizon_ticks=128, seed=9,
                           size="websearch", size_cap_pkts=16)
    spec2 = _port(B.build_spec(DF, other.to_packet_flows(), "spritz_spray_w",
                               n_ticks=448, seed=0))
    with pytest.raises(ValueError, match="identical SimSpec"):
        TE.run(spec2, resume=TE.checkpoint(res, st), device="cpu")


def test_reference_checkpoint_resumes_in_port(packet_spec, reference_full):
    res, st = E.run(packet_spec, seed=0, until_tick=128, return_carry=True)
    got, gst = TE.run(_port(packet_spec), resume=E.checkpoint(res, st),
                      device="cpu", return_carry=True)
    same_run(got, gst, *reference_full, "reference checkpoint in the port")


def test_port_checkpoint_resumes_in_reference(packet_spec, reference_full):
    res, st = TE.run(_port(packet_spec), seed=0, until_tick=128,
                     device="cpu", return_carry=True)
    got, gst = E.run(packet_spec, resume=E.checkpoint(res, st),
                     return_carry=True)
    same_run(got, gst, *reference_full, "port checkpoint in the reference")


@pytest.mark.parametrize("plan", ["midrun", "degraded"])
def test_resume_inside_a_timeline(plan):
    """Cut inside the outage (or brownout): the checkpoint carries the
    timeline cursor, the live port state and the policy substates."""
    flows = [B.Flow(e, 40 + (e % 3), 96, start_tick=8 * e)
             for e in range(5)]
    links = sample_links(DF, 3, seed=3)
    sched = FailureSchedule(DF)
    if plan == "midrun":
        sched.fail_links(60, links).recover(2500)
    else:
        sched.degrade_links(60, links, 0.25, until=2500)
    spec = B.build_spec(DF, flows, "reps", n_ticks=1 << 13,
                        failure_plan=sched, block_ticks=1024)
    tspec = _port(spec)
    full, full_state = E.run(spec, return_carry=True)
    res, st = TE.run(tspec, device="cpu", until_tick=300, return_carry=True)
    assert int(st["fail_idx"]) == 2 * len(links)
    got, gst = TE.run(tspec, resume=TE.checkpoint(res, st), device="cpu",
                      return_carry=True)
    same_run(got, gst, full, full_state, plan)
    if plan == "degraded":
        assert got.rate_violations == 0 and full.rate_violations == 0
