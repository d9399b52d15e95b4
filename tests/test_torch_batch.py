"""The port's ``run_batch`` equals the JAX reference's bit for bit.

The reference vmaps its while-loop over a lane axis; the port runs each
lane through its solo loop.  Either way a lane must compute what a solo
run of its spec computes, so the port's batch is held against the
reference's batch on the same spec, schemes and seeds: every
``SimResult`` field, ``ticks_simulated``, ``steps_executed`` and, with
``return_carry``, every final carry leaf (every policy substate).
Covered: all 11 schemes at seeds 0 and 3 with ``use_kernels`` False and
True, the per-lane-spec form under a mid-run failure plan, a segmented
batch resumed lane by lane (from the port's and from the reference's
checkpoints), the 71-to-1 marking incast as one batch (DCTCP ``alpha``
in the carry), and ``batch_lanes`` with the refusals.  Tolerance: zero.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.sim.failures import FailureSchedule, sample_links  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402
from repro_torch.net.sim import types as TT  # noqa: E402

DF = make_dragonfly(4, 2, 2)
FLOWS = [B.Flow(e, 40 + (e % 3), 40 + 8 * (e % 2), start_tick=16 * e)
         for e in range(6)]
SCHEMES = ("minimal", "valiant", "ugal_l", "ecmp", "flicr_w", "ops_u",
           "ops_w", "spritz_scout", "spritz_spray_u", "spritz_spray_w",
           "reps")
SEEDS = (0, 3)
RESULT_FIELDS = ("fct_ticks", "delivered", "trims", "timeouts", "ooo",
                 "retx", "done")


def _port(spec, use_kernels=None):
    tspec = TT.spec_from_arrays(dataclasses.asdict(spec))
    tspec.use_kernels = use_kernels
    return tspec


def _same_result(got, want, ctx):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{ctx} {name}")
    assert (got.ticks_simulated, got.steps_executed, got.down_violations,
            got.rate_violations) == (want.ticks_simulated,
                                     want.steps_executed,
                                     want.down_violations,
                                     want.rate_violations), ctx
    # the CPU reads the stop flag after every step: no step past the stop
    # (a resumed run replays only its own steps)
    assert 0 <= got.replays <= got.steps_executed, ctx


def _same_state(got: dict, want: dict, ctx):
    for k, v in want.items():
        if k in ("policy", "spritz"):
            continue
        assert got[k].dtype == np.asarray(v).dtype, (ctx, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{ctx} {k}")
    assert list(got["policy"]) == list(want["policy"]), ctx
    for fam, sub in want["policy"].items():
        for k, v in sub.items():
            g = got["policy"][fam][k]
            assert g.dtype == v.dtype, (ctx, fam, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{ctx} {fam}.{k}")


def _same_batch(got, want, ctx):
    (res, st), (wres, wst) = got, want
    assert len(res) == len(wres) == len(st) == len(wst), ctx
    for i, (r, w) in enumerate(zip(res, wres)):
        _same_result(r, w, (ctx, i))
    for i, (s, w) in enumerate(zip(st, wst)):
        _same_state(s, w, (ctx, i))


@functools.lru_cache(maxsize=None)
def _sweep_reference():
    base = B.build_spec(DF, FLOWS, "spritz_spray_w", n_ticks=1 << 12)
    return base, E.run_batch(base, schemes=list(SCHEMES), seeds=list(SEEDS),
                             return_carry=True)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["torch_forms", "kernels"])
def test_run_batch_matches_reference(use_kernels):
    base, want = _sweep_reference()
    got = TE.run_batch(_port(base, use_kernels), schemes=list(SCHEMES),
                       seeds=list(SEEDS), return_carry=True, device="cpu")
    _same_batch(got, want, ("sweep", use_kernels))
    assert all(r.done.all() for r in want[0]), "the micro cell must finish"
    assert all(r.replays == r.steps_executed for r in got[0])
    # seeds differ where the scheme draws
    by_lane = dict(zip(TE.batch_lanes(SCHEMES, SEEDS), got[0]))
    assert any((by_lane[s, 0].fct_ticks != by_lane[s, 3].fct_ticks).any()
               for s in SCHEMES)


FAIL_FLOWS = [B.Flow(e, 40 + (e % 3), 96, start_tick=4 * e) for e in range(5)]
FAIL_SCHEMES = ("ecmp", "ops_u", "spritz_scout", "spritz_spray_w")


def test_per_lane_specs_under_midrun_failures_match_reference():
    """Lane specs passed one by one (``respec_scheme`` of a base built
    with a mid-run failure and recovery), against the reference's batch
    of the same specs; the base spec with the schemes gives the same
    lanes."""
    links = sample_links(DF, 4, seed=3)
    sched = FailureSchedule(DF).fail_links(30, links).recover(400)
    base = B.build_spec(DF, FAIL_FLOWS, "spritz_spray_w", n_ticks=1 << 12,
                        failure_plan=sched, block_ticks=512)
    specs = [B.respec_scheme(base, s) for s in FAIL_SCHEMES]
    want = E.run_batch(specs, return_carry=True)
    got = TE.run_batch([_port(s) for s in specs], return_carry=True,
                       device="cpu")
    _same_batch(got, want, "lane specs")
    by_base = TE.run_batch(_port(base), schemes=list(FAIL_SCHEMES),
                           return_carry=True, device="cpu")
    _same_batch(by_base, want, "base spec")
    res = got[0]
    assert all(r.down_violations == 0 for r in res)
    assert sum(int(r.trims.sum() + r.timeouts.sum()) for r in res) > 0, \
        "the failure must hit traffic"


def test_segmented_batch_resumes_bit_identical():
    """until_tick, then one Checkpoint per lane: equal to the unsegmented
    batch and to the reference's; a batch of the reference's checkpoints
    resumes in the port too."""
    schemes, seeds = ["ecmp", "spritz_spray_w"], [0, 1]
    base = B.build_spec(DF, FLOWS, "spritz_spray_w", n_ticks=1 << 12)
    tbase = _port(base)
    kw = dict(schemes=schemes, seeds=seeds, return_carry=True)
    want = E.run_batch(base, **kw)
    full = TE.run_batch(tbase, device="cpu", **kw)
    _same_batch(full, want, "unsegmented")
    res, st = TE.run_batch(tbase, device="cpu", until_tick=100, **kw)
    assert all(100 <= r.ticks_simulated < f.ticks_simulated
               for r, f in zip(res, full[0]))
    cps = [TE.checkpoint(r, s) for r, s in zip(res, st)]
    _same_batch(TE.run_batch(tbase, device="cpu", resume=cps, **kw), want,
                "resumed")
    wres, wst = E.run_batch(base, until_tick=100, **kw)
    _same_batch((res, st), (wres, wst), "first segment")
    wcps = [E.checkpoint(r, s) for r, s in zip(wres, wst)]
    _same_batch(TE.run_batch(tbase, device="cpu", resume=wcps, **kw), want,
                "resumed from the reference's checkpoints")


def test_marking_incast_batch_alpha_matches_reference():
    """The 71-to-1 incast under a low ECN threshold as one batch: the
    lanes' DCTCP alpha equals the reference's vmapped loop (which rounds
    it as its solo loop does) and every lane's solo run."""
    incast = [B.Flow(e, 0, 48, start_tick=0) for e in range(1, 72)]
    base = B.build_spec(DF, incast, "spritz_spray_w", n_ticks=768,
                        ecn_threshold=4)
    schemes = ["ecmp", "spritz_spray_w", "ugal_l"]
    want = E.run_batch(base, schemes=schemes, seeds=[0], return_carry=True)
    assert all((st["alpha"] != 0).any() for st in want[1]), \
        "no DCTCP round saw a mark"
    got = TE.run_batch(_port(base), schemes=schemes, seeds=[0],
                       return_carry=True, device="cpu")
    _same_batch(got, want, "incast")
    solo, solo_st = TE.run(_port(B.respec_scheme(base, "ugal_l")),
                           device="cpu", return_carry=True)
    _same_result(solo, got[0][2], "incast solo")
    _same_state(solo_st, got[1][2], "incast solo")


def test_batch_lanes_order_and_refusals():
    assert TE.batch_lanes(["ecmp", 9], [0, 3]) == \
        E.batch_lanes(["ecmp", 9], [0, 3]) == \
        [("ecmp", 0), ("ecmp", 3), (9, 0), (9, 3)]
    base = _port(B.build_spec(DF, FLOWS, "spritz_spray_w", n_ticks=64))
    other = _port(B.build_spec(DF, FLOWS[:3], "ecmp", n_ticks=64))
    with pytest.raises(ValueError, match="schemes only with a single"):
        TE.run_batch([base, base], schemes=["ecmp"], device="cpu")
    with pytest.raises(ValueError, match="share static shapes"):
        TE.run_batch([base, other], device="cpu")
    with pytest.raises(ValueError, match="one Checkpoint per lane"):
        TE.run_batch(base, schemes=["ecmp", "reps"], device="cpu",
                     resume=[None])
    with pytest.raises(ValueError, match="unknown scheme"):
        TE.run_batch(base, schemes=["nope"], device="cpu")
    with pytest.raises(ValueError, match="uniform-weight base spec"):
        TE.run_batch(_port(B.build_spec(DF, FLOWS, "spritz_spray_u",
                                        n_ticks=64)),
                     schemes=["ecmp"], device="cpu")
    # lane_arrays delegates to the registry's lane rules, as the reference
    for s in ("spritz_spray_u", "minimal", "ugal_l"):
        for got, want in zip(TE.lane_arrays(base, s),
                             E.lane_arrays(B.build_spec(
                                 DF, FLOWS, "spritz_spray_w", n_ticks=64),
                                 s)):
            np.testing.assert_array_equal(got, want)
    # shard=False and shard=None run the same lanes on one CPU
    a = TE.run_batch(base, schemes=["ecmp"], seeds=[0, 1], device="cpu",
                     shard=False)
    b = TE.run_batch(base, schemes=["ecmp"], seeds=[0, 1], device="cpu")
    for x, y in zip(a, b):
        _same_result(x, y, "shard")
