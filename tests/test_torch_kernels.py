"""The port's kernel wrappers and plain versions vs the JAX reference.

On the CPU each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain version (``repro_torch.kernels.ref``); both are held here against
``repro.kernels.ref`` and against the Pallas kernel itself in interpret
mode, bit for bit.  The reference oracles run under ``jax.jit``, as the
engine runs them: eagerly XLA divides by ``kmax - kmin``, jitted it
multiplies by the f32 reciprocal, and the port follows the engine.  The
CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RNG = np.random.default_rng(11)
RED_REF = jax.jit(JREF.red_ecn_reference,
                  static_argnames=("qsize", "kmin", "kmax", "n_ports"))


def _eq(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- flow_agg --
@pytest.mark.parametrize("K,N,F", [(6, 512, 16), (2, 700, 300),
                                   (6, 5000, 1056), (3, 1, 1)])
def test_flow_agg(K, N, F):
    rows = (RNG.integers(0, 1 << 12, (K, N))
            * (RNG.random((K, N)) < 0.3)).astype(np.int32)
    pflow = RNG.integers(-1, F + 2, N).astype(np.int32)   # incl. out of range
    got = ops.flow_agg(_t(rows), _t(pflow), n_flows=F)
    _eq(got, JREF.flow_agg_reference(jnp.asarray(rows), jnp.asarray(pflow),
                                     n_flows=F))
    _eq(got, JOPS.flow_agg(jnp.asarray(rows), jnp.asarray(pflow), n_flows=F,
                           block_n=256, interpret=True))


# ------------------------------------------------------------ tick_rank --
@pytest.mark.parametrize("M,P", [(64, 8), (1000, 128), (5024, 3960),
                                 (37, 3960), (1, 1)])
def test_tick_rank(M, P):
    port = RNG.integers(-1, P + 2, M).astype(np.int32)
    got = ops.tick_rank(_t(port), n_ports=P)
    _eq(got, JREF.tick_rank_reference(jnp.asarray(port), n_ports=P))
    _eq(got, JOPS.tick_rank(jnp.asarray(port), n_ports=P, block_m=256,
                            interpret=True))


def test_tick_rank_is_stable_fifo_rank():
    got = ops.tick_rank(torch.tensor([3, 1, 3, 3, 0, 1], dtype=torch.int32),
                        n_ports=4)
    assert got.tolist() == [0, 0, 1, 2, 0, 1]


def test_tick_rank_matches_engine_onehot_form_on_valid_entries():
    # the engine's jnp one-hot rank gives sentinel entries rank 0, the
    # kernel its overflow-bucket position; callers mask the sentinels,
    # so only valid entries must agree
    P, M = 40, 300
    port = np.full(M, P, np.int32)
    port[:220] = RNG.integers(0, P, 220)
    oh = port[:, None] == np.arange(P)[None, :]
    onehot = np.maximum((np.cumsum(oh, 0) * oh).sum(-1) - 1, 0)
    got = ops.tick_rank(_t(port), n_ports=P).numpy()
    valid = port < P
    np.testing.assert_array_equal(got[valid], onehot[valid])
    assert (got[~valid] != onehot[~valid]).any()


# -------------------------------------------------------------- red_ecn --
@pytest.mark.parametrize("M,P", [(512, 32), (5024, 3960), (17, 4)])
@pytest.mark.parametrize("t", [0, 70000])
def test_red_ecn(M, P, t):
    eport = RNG.integers(0, P + 1, M).astype(np.int32)     # incl. sentinel
    rank = RNG.integers(0, 8, M).astype(np.int32)
    enq = RNG.random(M) < 0.5
    unif = RNG.random(M).astype(np.float32)
    tails = (t + RNG.integers(-100, 200, P)).astype(np.int32)
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    got = ops.red_ecn(_t(eport), _t(rank), _t(enq), _t(unif), _t(tails), t,
                      **kw)
    args = [jnp.asarray(a) for a in (eport, rank, enq, unif, tails)]
    _eq(got, RED_REF(*args, t, **kw))
    _eq(got, JOPS.red_ecn(*args, t, block_n=128, interpret=True, **kw))


def test_red_ecn_every_occupancy_marks_like_the_reference():
    # every occupancy below qsize, with the uniform draw set right at the
    # reference's probability and one f32 step below it: any rounding
    # difference in the RED probability flips a mark
    qsize, kmin, kmax = 102, 20.4, 81.6
    occ = np.arange(qsize + 332, dtype=np.int32)
    pr = np.asarray(jax.jit(lambda o: jnp.clip(
        (o.astype(jnp.float32) - kmin) / max(kmax - kmin, 1e-9), 0.0,
        1.0))(occ))
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=1)
    for unif in (pr, np.nextafter(pr, np.float32(0))):
        args = (np.zeros_like(occ), occ, np.ones(len(occ), bool),
                unif.astype(np.float32), np.array([0], np.int32))
        got = ops.red_ecn(*map(_t, args), 0, **kw)
        _eq(got, RED_REF(*map(jnp.asarray, args), 0, **kw))


# -------------------------------------------------------- spritz_select --
@pytest.mark.parametrize("F,P", [(16, 8), (100, 37), (256, 64), (1000, 64),
                                 (33, 1)])
@pytest.mark.parametrize("explore_all", [False, True])
def test_spritz_select(F, P, explore_all):
    w = (np.exp(RNG.normal(0, 3, (F, P)))
         * (RNG.random((F, P)) < 0.8)).astype(np.float32)
    w[:3] = 0.0                                           # all-zero rows
    u = RNG.random(F).astype(np.float32)
    front = RNG.integers(-1, P, F).astype(np.int32)
    cnt = (np.full(F, 44) if explore_all
           else RNG.integers(0, 60, F)).astype(np.int32)
    got = ops.spritz_select(_t(w), _t(u), _t(front), _t(cnt),
                            explore_threshold=44)
    args = [jnp.asarray(a) for a in (w, u, front, cnt)]
    _eq(got, JREF.spritz_select_reference(*args, explore_threshold=44))
    _eq(got, JOPS.spritz_select(*args, explore_threshold=44, block_f=64,
                                interpret=True))


# ------------------------------------------------------ input validation --
def test_wrappers_reject_bad_inputs():
    i32 = torch.int32
    with pytest.raises(ValueError):
        ops.flow_agg(torch.zeros((2, 8), dtype=i32),
                     torch.zeros(7, dtype=i32), n_flows=4)
    with pytest.raises(ValueError):
        ops.flow_agg(torch.zeros((2, 8)), torch.zeros(8, dtype=i32),
                     n_flows=4)
    with pytest.raises(ValueError):
        ops.tick_rank(torch.zeros(4), n_ports=4)
    with pytest.raises(ValueError):
        ops.tick_rank(torch.zeros(4, dtype=i32), n_ports=0)
    z = torch.zeros(8, dtype=i32)
    with pytest.raises(ValueError):
        ops.red_ecn(z, z[:7], z.bool(), z.float(), torch.zeros(3, dtype=i32),
                    0, qsize=8, kmin=1.0, kmax=4.0, n_ports=3)
    with pytest.raises(ValueError):
        ops.red_ecn(z, z, z.bool(), z.float(), torch.zeros(4, dtype=i32),
                    0, qsize=8, kmin=1.0, kmax=4.0, n_ports=3)
    with pytest.raises(ValueError):
        ops.spritz_select(torch.zeros((8, 4)), torch.zeros(7), z, z,
                          explore_threshold=4)
    with pytest.raises(ValueError):
        ops.spritz_select(torch.zeros((8, 300)), torch.zeros(8), z, z,
                          explore_threshold=4)


def test_cpu_tensors_never_launch():
    ops.reset_launches()
    rows = torch.ones((2, 16), dtype=torch.int32)
    ops.flow_agg(rows, torch.zeros(16, dtype=torch.int32), n_flows=3)
    ops.tick_rank(torch.zeros(16, dtype=torch.int32), n_ports=3)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
