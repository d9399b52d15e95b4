"""The port's gated loop and its device-side pieces, on the CPU.

The engine's loop is one gated step over static state (``_Loop``): on
the card a CUDA graph replays it with one read of the stop flag per
``STEPS_PER_READ`` steps, on the CPU it runs eagerly.  A step taken after
the stop must change nothing, so reading the flag every 1, 7 or 64 steps
gives the same result, ``steps_executed`` and final carry, whether the
run stops on its flows, on ``until_tick`` or on ``n_ticks`` in the middle
of a batch of steps; each is held against the reference's run.  The
pieces that moved onto the device for it: the tensor forms of
``fold_in`` / ``split`` / ``uniforms`` against ``jax.random``, the tick's
draws (``ops.tick_draws``), the RED/ECN wrappers with the tick in a 0-d
tensor, and the tick and horizon fed a tensor tick.  Tolerance: zero.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import ref as JREF  # noqa: E402
from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch import _parity as PAR  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.net.sim import engine as TE  # noqa: E402
from repro_torch.net.sim import types as TT  # noqa: E402

DF = make_dragonfly(4, 2, 2)
FLOWS = [B.Flow(e, 40 + (e % 3), 40 + 8 * (e % 2), start_tick=16 * e)
         for e in range(6)]
RNG = np.random.default_rng(20261017)


def _port(spec, use_kernels=None):
    tspec = TT.spec_from_arrays(dataclasses.asdict(spec))
    tspec.use_kernels = use_kernels
    return tspec


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _same(got, gst, want, wst, ctx):
    for name in ("fct_ticks", "delivered", "trims", "timeouts", "ooo",
                 "retx", "done"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{ctx} {name}")
    assert (got.ticks_simulated, got.steps_executed) == \
        (want.ticks_simulated, want.steps_executed), ctx
    for k, v in wst.items():
        if k not in ("policy", "spritz"):
            np.testing.assert_array_equal(gst[k], v, err_msg=f"{ctx} {k}")
    for fam, sub in wst["policy"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(gst["policy"][fam][k], v,
                                          err_msg=f"{ctx} {fam}.{k}")


def _gated(tspec, k, *, dense=False, until_tick=None, seed=0):
    """A run of the gated loop reading the stop flag every ``k`` steps."""
    loop = TE._Loop(tspec, torch.device("cpu"), dense)
    loop.load(TE.init_carry(tspec, seed, "cpu"), -1, 0,
              np.ones(tspec.n_flows, bool),
              tspec.n_ticks if until_tick is None else until_tick)
    return loop.result(loop.drive(k), True)


@functools.lru_cache(maxsize=None)
def _reference(scheme, n_ticks, until_tick, dense):
    spec = B.build_spec(DF, FLOWS, scheme, n_ticks=n_ticks)
    return spec, E.run(spec, reference=dense, until_tick=until_tick,
                       return_carry=True)


# (n_ticks, until_tick): the run stops on its flows (220 steps for
# spritz_spray_w: 28 into a batch of 64, 3 into one of 7), on until_tick
# (the first step at or past tick 101) and on n_ticks (the step that
# would reach tick 150 jumps there without a transition)
STOPS = {"flows": (1 << 12, None), "until_tick": (1 << 12, 101),
         "n_ticks": (150, None)}


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("scheme", ["spritz_spray_w", "ugal_l"])
def test_gated_loop_any_read_interval_matches_reference(scheme, stop, k):
    n_ticks, until = STOPS[stop]
    spec, (want, wst) = _reference(scheme, n_ticks, until, False)
    got, gst = _gated(_port(spec), k, until_tick=until)
    _same(got, gst, want, wst, (scheme, stop, k))
    # the flag is read after each batch of k: fewer than k steps past
    # the stop, and every step before it a transition
    assert got.replays % k == 0 and \
        0 <= got.replays - got.steps_executed < k
    if stop == "n_ticks":
        assert got.ticks_simulated == n_ticks and not want.done.all()


@pytest.mark.parametrize("k", [1, 7])
def test_gated_dense_loop_matches_reference(k):
    spec, (want, wst) = _reference("spritz_scout", 1 << 10, None, True)
    got, gst = _gated(_port(spec), k, dense=True)
    _same(got, gst, want, wst, ("dense", k))
    assert got.steps_executed == got.ticks_simulated + 1   # ticks 0..T


def test_step_after_the_stop_changes_nothing():
    spec = _port(B.build_spec(DF, FLOWS, "spritz_spray_w", n_ticks=1 << 12))
    loop = TE._Loop(spec, torch.device("cpu"), False)
    loop.load(TE.init_carry(spec, 0, "cpu"), -1, 0,
              np.ones(spec.n_flows, bool), 40)
    loop.drive()
    assert not bool(loop.run)
    before = [x.clone() for x in loop.leaves + [loop.t, loop.steps, loop.h]]
    for _ in range(3):
        loop._step()
    after = loop.leaves + [loop.t, loop.steps, loop.h]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_run_keeps_the_references_signature():
    spec = B.build_spec(DF, FLOWS, "ecmp", n_ticks=1 << 10)
    tspec = _port(spec)
    # chunk is accepted and ignored, as in the reference
    got, gst = TE.run(tspec, 0, 64, return_carry=True, device="cpu")
    want, wst = E.run(spec, 0, 64, return_carry=True)
    _same(got, gst, want, wst, "chunk")
    assert got.replays == got.steps_executed
    dense, dst = TE.run_reference(tspec, return_carry=True, device="cpu")
    _same(dense, dst, *E.run_reference(spec, return_carry=True), "dense")


def test_live_carry_bytes_counts_every_leaf():
    spec = B.build_spec(DF, FLOWS, "spritz_spray_w", n_ticks=1 << 10)
    got = TE.live_carry_bytes(TE.init_carry(_port(spec), 0, "cpu"))
    # the rng's two uint32 words are int64 in the port
    assert got == E.live_carry_bytes(E.init_carry(spec, 0)) + 8


@pytest.mark.parametrize("t", [0, 1, 513, 70000])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_tensor_keys_and_draws_match_jax_random(seed, t):
    key = jax.random.PRNGKey(seed)
    rng = torch.tensor(PAR.prng_key(seed), dtype=torch.int64)
    tt = torch.tensor(t, dtype=torch.int32)
    folded = PAR.fold_in((rng[0], rng[1]), tt)
    jfolded = jax.random.fold_in(key, t)
    assert all(isinstance(w, torch.Tensor) and w.ndim == 0 for w in folded)
    assert tuple(int(w) for w in folded) == \
        tuple(int(v) for v in np.asarray(jfolded))
    subs = PAR.split(folded, 2)
    jsubs = jax.random.split(jfolded, 2)
    assert [tuple(int(w) for w in k) for k in subs] == \
        [tuple(int(v) for v in np.asarray(k)) for k in jsubs]
    shapes = [(37, 1), (129,)]
    got = PAR.uniforms(list(zip(subs, shapes)), "cpu")
    for g, k, shape in zip(got, jsubs, shapes):
        np.testing.assert_array_equal(
            _bits(g.numpy()), _bits(jax.random.uniform(k, shape)))
    # the kernel wrapper's plain version: the same keys and draws
    u_path, unif = ops.tick_draws(rng, tt, n_flows=37, n_cand=129)
    assert tuple(u_path.shape) == (37, 1)
    np.testing.assert_array_equal(_bits(u_path.numpy()), _bits(got[0]))
    np.testing.assert_array_equal(_bits(unif.numpy()), _bits(got[1]))


def test_tick_draws_refuses_bad_inputs():
    rng = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="rng must be"):
        ops.tick_draws(rng[:1], 0, n_flows=1, n_cand=1)
    with pytest.raises(ValueError, match="rng must be"):
        ops.tick_draws(rng.int(), 0, n_flows=1, n_cand=1)
    with pytest.raises(ValueError, match="0-d int32"):
        ops.tick_draws(rng, torch.zeros(1, dtype=torch.int32), n_flows=1,
                       n_cand=1)
    u_path, unif = ops.tick_draws(rng, 5, n_flows=0, n_cand=0)
    assert u_path.shape == (0, 1) and unif.shape == (0,)


@pytest.mark.parametrize("t", [0, 37, 70000])
def test_red_ecn_wrappers_take_a_tensor_tick(t):
    M, P = 300, 40
    eport = RNG.integers(0, P + 3, M).astype(np.int32)
    rank = RNG.integers(0, 20, M).astype(np.int32)
    enq = RNG.random(M) < 0.8
    unif = RNG.random(M).astype(np.float32)
    tails = (t + RNG.integers(-10, 40, P)).astype(np.int32)
    kw = dict(qsize=24, kmin=4.0, kmax=16.0, n_ports=P)
    ins = [torch.as_tensor(a) for a in (eport, rank, enq, unif, tails)]
    tt = torch.tensor(t, dtype=torch.int32)
    want = jax.jit(JREF.red_ecn_reference,
                   static_argnames=("qsize", "kmin", "kmax", "n_ports"))(
        eport, rank, enq, unif, tails, t, **kw)
    for got in (ops.red_ecn(*ins, tt, **kw),
                TREF.red_ecn_reference(*ins, tt, **kw)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    port = torch.as_tensor(eport)
    fused = ops.tick_rank_red_ecn(port, ins[2], ins[3], ins[4], tt, **kw)
    by_int = ops.tick_rank_red_ecn(port, ins[2], ins[3], ins[4], t, **kw)
    for g, w in zip(fused, by_int):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="0-d int32"):
        ops.red_ecn(*ins, tt.long(), **kw)


def test_tick_and_horizon_take_a_tensor_tick():
    spec = B.build_spec(DF, FLOWS, "spritz_scout", n_ticks=1 << 12)
    tspec = _port(spec)
    res, st = TE.run(tspec, until_tick=90, return_carry=True, device="cpu")
    carry = TE.carry_from_state(tspec, st, "cpu")
    assert carry.rng.device.type == "cpu" and carry.rng.dtype == torch.int64
    t = res.ticks_simulated
    hor = TE.build_horizon(tspec, "cpu")
    h = hor(carry, torch.tensor(t, dtype=torch.int32))
    assert h.ndim == 0 and int(h) == int(hor(carry, t)) > t
    tick = TE.build_tick(tspec, "cpu")
    by_tensor = TE.carry_state(tick(carry, h))
    by_int = TE.carry_state(tick(carry, int(h)))
    # the step from a reference state equals the reference's step there
    want = E.run(spec, until_tick=int(h), resume=E.Checkpoint(
        st, t, res.steps_executed), return_carry=True)
    assert want[0].ticks_simulated == int(h)
    _same(res, by_tensor, res, by_int, "tensor tick")
    _same(want[0], by_tensor, want[0], want[1], "one tick")
