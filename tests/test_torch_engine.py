"""The port's packet engine on the CPU equals the JAX reference bit for bit.

Same spec (carried across with ``spec_from_arrays``) and seed in; every
``SimResult`` field, ``ticks_simulated``, ``steps_executed`` and every
final carry leaf, every policy family's substate included, out.
Covered: all 11 registered schemes x the compressed and dense steppers
x ``use_kernels`` False (the engine's torch forms) and True (the kernel
wrappers, which run the plain versions on CPU tensors), the
``_ONEHOT_CELLS`` form switch, a static link failure, an incast whose
DCTCP rounds see ECN marks (so ``alpha`` and ``cwnd`` move), a failed
link that only retransmission timeouts get past, and a one-tick
comparison from a mid-run reference state — the tool for bisecting a
divergence to its first tick.  Tolerance: zero.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.sim.types import enqueue_bound  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402
from repro_torch.net.sim import types as TT  # noqa: E402

DF = make_dragonfly(4, 2, 2)
FLOWS = [B.Flow(e, 40 + (e % 3), 40 + 8 * (e % 2), start_tick=16 * e)
         for e in range(6)]
SCHEMES = ("minimal", "valiant", "ugal_l", "ecmp", "flicr_w", "ops_u",
           "ops_w", "spritz_scout", "spritz_spray_u", "spritz_spray_w",
           "reps")
RESULT_FIELDS = ("fct_ticks", "delivered", "trims", "timeouts", "ooo",
                 "retx", "done")


def _spec(scheme, **kw):
    kw.setdefault("n_ticks", 1 << 12)
    return B.build_spec(DF, FLOWS, scheme, **kw)


def _port(spec, use_kernels):
    tspec = TT.spec_from_arrays(dataclasses.asdict(spec))
    tspec.use_kernels = use_kernels
    return tspec


def _same_state(got: dict, want: dict, ctx):
    for k, v in want.items():
        if k in ("policy", "spritz"):
            continue
        g = got[k]
        assert g.dtype == np.asarray(v).dtype, (ctx, k, g.dtype)
        np.testing.assert_array_equal(g, v, err_msg=f"{ctx} {k}")
    assert list(got["policy"]) == list(want["policy"]), ctx
    for fam, sub in want["policy"].items():
        assert list(got["policy"][fam]) == list(sub), (ctx, fam)
        for k, v in sub.items():
            g = got["policy"][fam][k]
            assert g.dtype == v.dtype, (ctx, fam, k, g.dtype)
            np.testing.assert_array_equal(g, v, err_msg=f"{ctx} {fam}.{k}")


def _same_result(got, want, ctx):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{ctx} {name}")
    assert got.steps_executed == want.steps_executed, ctx
    assert got.ticks_simulated == want.ticks_simulated, ctx
    assert got.down_violations == want.down_violations == 0, ctx


@functools.lru_cache(maxsize=None)
def _reference(scheme, dense):
    spec = _spec(scheme, n_ticks=(1 << 10) if dense else (1 << 12))
    res, state = E.run(spec, reference=dense, return_carry=True)
    return spec, res, state


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["torch_forms", "kernels"])
@pytest.mark.parametrize("dense", [False, True], ids=["compressed", "dense"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_matches_reference(scheme, dense, use_kernels):
    spec, want, want_state = _reference(scheme, dense)
    got, state = TE.run(_port(spec, use_kernels), device="cpu",
                        reference=dense, return_carry=True)
    ctx = (scheme, dense, use_kernels)
    _same_result(got, want, ctx)
    _same_state(state, want_state, ctx)
    assert all(want.done), "the micro cell must run to completion"


# 71-to-1 incast under a low ECN threshold: marked DCTCP rounds from
# about tick 500.  768 ticks is the shortest horizon at which the fma
# form of alpha's update (the reference's standalone jit) leaves the
# reference's loop in each of the six static and Spritz schemes; the run
# stops there, unfinished.
INCAST = [B.Flow(e, 0, 48, start_tick=0) for e in range(1, 72)]


@functools.lru_cache(maxsize=None)
def _marking_reference(scheme, seed):
    spec = B.build_spec(DF, INCAST, scheme, n_ticks=768, ecn_threshold=4)
    res, state = E.run(spec, seed=seed, return_carry=True)
    return spec, res, state


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["torch_forms", "kernels"])
@pytest.mark.parametrize("scheme,seed", [(s, 0) for s in SCHEMES]
                         + [("spritz_spray_w", 3)])
def test_marking_incast_matches_reference(scheme, seed, use_kernels):
    """DCTCP alpha and the cwnd cut it drives, in the final carry: inside
    the reference's loop XLA rounds ``(1 - g) * alpha + g * frac``
    unfused."""
    spec, want, want_state = _marking_reference(scheme, seed)
    assert (want_state["alpha"] != 0).any(), "no DCTCP round saw a mark"
    if scheme == "flicr_w":     # marks reached FLICR's counter: flows moved
        assert (want_state["policy"]["flicr"]["cur"]
                != spec.static_path).any()
    got, state = TE.run(_port(spec, use_kernels), device="cpu", seed=seed,
                        return_carry=True)
    ctx = ("incast", scheme, seed, use_kernels)
    _same_result(got, want, ctx)
    _same_state(state, want_state, ctx)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["torch_forms", "kernels"])
def test_timeouts_match_reference(use_kernels):
    """A failed link on the minimal path: flows 0 and 1 lose packets on
    it until their retransmission timeouts fire, run after run."""
    link = (0, int(DF.nbr[0, 1]))
    spec = _spec("minimal", failed_links=[link])
    want, want_state = E.run(spec, return_carry=True)
    assert want.timeouts.sum() > 0
    got, state = TE.run(_port(spec, use_kernels), device="cpu",
                        return_carry=True)
    _same_result(got, want, ("timeouts", use_kernels))
    _same_state(state, want_state, ("timeouts", use_kernels))


def test_onehot_cells_straddle(monkeypatch):
    """The one-hot rank / flow-sum forms and their argsort / scatter
    fallbacks, switched by ``_ONEHOT_CELLS`` on both sides."""
    spec = _spec("spritz_scout")
    want = E.run(spec)
    tspec = _port(spec, False)
    n_eps = int(spec.src_ep.max()) + 1
    m_cells = enqueue_bound(spec.n_pkt, spec.n_ports, n_eps) * spec.n_ports
    s_cells = spec.n_pkt * spec.n_flows
    lo, hi = sorted((m_cells, s_cells))
    assert TE._ONEHOT_CELLS > hi, "micro cell must default to one-hot forms"
    # between the two: one form falls back; 0: both fall back
    for thr in ((lo + hi) // 2, 0):
        monkeypatch.setattr(E, "_ONEHOT_CELLS", thr)
        monkeypatch.setattr(TE, "_ONEHOT_CELLS", thr)
        got = TE.run(tspec, device="cpu")
        _same_result(got, E.run(spec), thr)
        _same_result(got, want, thr)


@pytest.mark.parametrize("scheme", ["ecmp", "spritz_scout"])
def test_one_tick_from_reference_state(scheme):
    """Bisecting tool: a mid-run reference state, one transition on each
    side, at the next event tick and at t = 70,000 (where the reference's
    int32 ``t * 40503`` wraps)."""
    spec = _spec(scheme)
    res, state = E.run(spec, until_tick=120, return_carry=True)
    t_b = res.ticks_simulated
    ref_tick = jax.jit(E.build_tick(spec))
    ref_hor = jax.jit(E.build_horizon(spec))
    jcarry = E._carry_from_state(spec, state)
    h = int(ref_hor(jcarry, jnp.int32(t_b)))
    for use_kernels in (False, True):
        tspec = _port(spec, use_kernels)
        tcarry = TE.carry_from_state(tspec, state, "cpu")
        assert int(TE.build_horizon(tspec, "cpu")(tcarry, t_b)) == h
        for t in (h, 70000):
            want = E._carry_state(ref_tick(jcarry, jnp.int32(t)))
            got = TE.carry_state(TE.build_tick(tspec, "cpu")(tcarry, t))
            _same_state(got, want, (scheme, use_kernels, t))


def test_carry_state_roundtrip():
    tspec = _port(_spec("spritz_spray_w"), True)
    res, state = TE.run(tspec, device="cpu", return_carry=True)
    again = TE.carry_state(TE.carry_from_state(tspec, state, "cpu"))
    _same_state(again, state, "roundtrip")
    assert again["rng"].dtype == np.uint32


def test_static_failed_link_matches_reference():
    link = (0, int(DF.nbr[0, 0]))
    spec = _spec("spritz_spray_w", failed_links=[link], n_ticks=1 << 13)
    want, want_state = E.run(spec, return_carry=True)
    got, state = TE.run(_port(spec, True), device="cpu", return_carry=True)
    _same_result(got, want, "failed link")
    _same_state(state, want_state, "failed link")
    assert not state["port_up"].all()


def test_stop_flows_matches_reference():
    spec = _spec("spritz_scout")
    want = E.run(spec, stop_flows=[0, 1])
    got = TE.run(_port(spec, True), device="cpu", stop_flows=[0, 1])
    _same_result(got, want, "stop_flows")
    assert got.done[:2].all() and not got.done.all()


def test_dense_equals_compressed_in_the_port():
    tspec = _port(_spec("spritz_spray_u"), True)
    a = TE.run(tspec, device="cpu")
    b = TE.run(tspec, device="cpu", reference=True)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.ticks_simulated == b.ticks_simulated
    assert a.steps_executed < b.steps_executed


def test_unknown_scheme_raises():
    spec = dataclasses.replace(_port(_spec("ecmp"), True), scheme=11)
    with pytest.raises(ValueError, match="unknown scheme"):
        TE.run(spec, device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.run(_port(_spec("ecmp"), True))


def test_slimfly_spec_built_by_the_port_matches_reference():
    """An all-to-all on the reduced Slim Fly, its topology, flows and spec
    built by the port's own host layer, equals the reference's run."""
    from repro.net.topology.slimfly import make_slimfly
    from repro.net.workloads.collectives import alltoall
    from repro_torch.net.sim import build as TB
    from repro_torch.net.topology.slimfly import make_slimfly as t_slimfly
    from repro_torch.net.workloads.collectives import alltoall as t_alltoall
    jf, _ = alltoall(make_slimfly(5, p=2), 8, 128, seed=1, bg_pkts=16)
    tf, _ = t_alltoall(t_slimfly(5, p=2), 8, 128, seed=1, bg_pkts=16)
    spec = B.build_spec(make_slimfly(5, p=2), jf, "spritz_spray_w",
                        n_ticks=1 << 13)
    tspec = TB.build_spec(t_slimfly(5, p=2), tf, "spritz_spray_w",
                          n_ticks=1 << 13)
    assert tspec.use_kernels is None       # the kernels' plain versions
    want, want_state = E.run(spec, seed=2, return_carry=True)
    got, state = TE.run(tspec, seed=2, device="cpu", return_carry=True)
    _same_result(got, want, "slimfly")
    _same_state(state, want_state, "slimfly")
    assert all(want.done)
