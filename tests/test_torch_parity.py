"""Bitwise parity of ``repro_torch._parity`` with what JAX/XLA computes.

The port reproduces the reference's arithmetic operation for operation;
these are the four places where a plain torch op would differ: the
threefry random stream, XLA's f32 prefix-sum order, the fma that XLA
contracts the EWMAs into, and the RED divide that XLA turns into a
multiply by an f32 reciprocal.  Tolerance: zero (bit for bit).
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net.sim.types import enqueue_bound  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro_torch import _parity as PAR  # noqa: E402

RNG = np.random.default_rng(20261016)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def test_threefry_partitionable_flag_is_on():
    # the replica implements the partitionable layout; jax 0.4.x defaulted
    # to the other one
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("t", [0, 1, 513, 70000])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_threefry_matches_jax_random(seed, t):
    key = jax.random.PRNGKey(seed)
    pkey = PAR.prng_key(seed)
    assert _key(key) == pkey
    folded = jax.random.fold_in(key, t)
    pfolded = PAR.fold_in(pkey, t)
    assert _key(folded) == pfolded
    subs = jax.random.split(folded, 2)
    psubs = PAR.split(pfolded, 2)
    assert [_key(k) for k in subs] == psubs
    for shape in [(37, 1), (129,), (5024,)]:
        for k, pk in zip(subs, psubs):
            want = jax.random.uniform(k, shape)
            got = PAR.uniform(pk, shape, "cpu")
            assert tuple(got.shape) == shape and got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("P", [1, 2, 15, 16, 17, 31, 32, 33, 48, 63, 64])
def test_xla_cumsum_matches_jnp_cumsum(P):
    w = (RNG.random((300, P)) * RNG.integers(0, 2, (300, P))
         * np.exp(RNG.normal(0, 4, (300, P)))).astype(np.float32)
    w[:7] = 0.0                                     # zero rows
    want = jax.jit(lambda x: jnp.cumsum(x, axis=1))(w)
    got = PAR.xla_cumsum_f32(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_xla_cumsum_every_width_up_to_64():
    ws = [RNG.uniform(0, 9, (64, P)).astype(np.float32) for P in range(1, 65)]
    for w in ws:
        w[0] = 0.0
    wants = jax.jit(lambda xs: [jnp.cumsum(x, axis=1) for x in xs])(ws)
    for w, want in zip(ws, wants):
        got = PAR.xla_cumsum_f32(torch.from_numpy(w))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"P={w.shape[1]}")


def test_torch_cumsum_is_not_xla_order():
    # why the replica exists: torch's own cumsum rounds differently
    w = RNG.uniform(0, 9, (2048, 64)).astype(np.float32)
    want = _bits(jax.jit(lambda x: jnp.cumsum(x, axis=1))(w))
    plain = _bits(torch.cumsum(torch.from_numpy(w), 1).numpy())
    assert (plain != want).sum() > 0


@pytest.mark.parametrize("g", [1.0 / 16.0, 0.3])
def test_fma_matches_jitted_ewma(g):
    n = 65536
    a = RNG.random(n).astype(np.float32)
    f = RNG.random(n).astype(np.float32)
    a[:512] *= np.float32(1e-30)
    want = jax.jit(lambda a, f: (1 - g) * a + g * f)(a, f)
    got = PAR.fma_f32(torch.full((n,), PAR.f32(1 - g)), torch.from_numpy(a),
                      torch.from_numpy(f) * PAR.f32(g))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fma_matches_jitted_exp_alpha_form():
    # engine.py: (1 - g2) * exp_alpha + g2 * n_bad / max(n_exp, 1)
    g = 1.0 / 16.0
    n = 65536
    a = RNG.random(n).astype(np.float32)
    bad = RNG.integers(0, 9, n).astype(np.int32)
    ne = RNG.integers(0, 9, n).astype(np.int32)
    want = jax.jit(lambda a, b, e: (1 - g) * a + g * b / jnp.maximum(e, 1))(
        a, bad, ne)
    got = PAR.fma_f32(torch.full((n,), PAR.f32(1 - g)), torch.from_numpy(a),
                      (torch.from_numpy(bad) * PAR.f32(g))
                      / torch.from_numpy(ne).clamp_min(1))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _round_f32(q: Fraction) -> np.float32:
    """Exact round-to-nearest-even of a rational to f32 (normal and
    subnormal range)."""
    if q == 0:
        return np.float32(0.0)
    sign = -1 if q < 0 else 1
    q = abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    m = q / quantum
    m_int = m.numerator // m.denominator
    rem = m - m_int
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and m_int % 2):
        m_int += 1
    return np.float32(sign * float(m_int * quantum))


def test_fma_rounds_once_against_exact_arithmetic():
    n = 3000
    a = (RNG.normal(size=n) * np.exp2(RNG.integers(-60, 60, n))
         ).astype(np.float32)
    b = (RNG.normal(size=n) * np.exp2(RNG.integers(-60, 60, n))
         ).astype(np.float32)
    c = (RNG.normal(size=n) * np.exp2(RNG.integers(-120, 120, n))
         ).astype(np.float32)
    # near-cancellation and near-tie cases: c close to -a*b
    c[:1000] = -(a[:1000].astype(np.float64)
                 * b[:1000].astype(np.float64)).astype(np.float32)
    c[1000:1500] = (a[1000:1500].astype(np.float64)
                    * b[1000:1500]).astype(np.float32) * np.float32(-1e-7)
    got = PAR.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dims", [(4, 2, 2), (8, 4, 4)],
                         ids=["df422", "df1056"])
def test_red_reciprocal_every_occupancy(dims):
    topo = make_dragonfly(*dims)
    qsize = topo.bdp_packets()
    kmin, kmax = 0.2 * qsize, 0.8 * qsize          # build_spec's thresholds
    M = enqueue_bound(1 << 30, topo.n_ports, topo.n_endpoints)
    occ = np.arange(0, qsize + M + 1, dtype=np.int32)
    want = jax.jit(lambda o: jnp.clip(
        (o.astype(jnp.float32) - kmin) / max(kmax - kmin, 1e-9), 0.0, 1.0))(
            occ)
    got = ((torch.from_numpy(occ).float() - PAR.f32(kmin))
           * PAR.red_recip(kmin, kmax)).clamp(0.0, 1.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_red_probability_rounds_differently_eager_and_jitted():
    # why the port multiplies: the reference engine runs jitted, where
    # XLA replaces the division by the constant with a multiply by its
    # f32 reciprocal; eager jnp divides and rounds some values otherwise
    qsize = make_dragonfly(4, 2, 2).bdp_packets()
    kmin, kmax = 0.2 * qsize, 0.8 * qsize
    occ = np.arange(0, qsize + 6000, dtype=np.int32)

    def pr(o):
        return jnp.clip((o.astype(jnp.float32) - kmin)
                        / max(kmax - kmin, 1e-9), 0.0, 1.0)

    eager = _bits(pr(jnp.asarray(occ)))
    jitted = _bits(jax.jit(pr)(occ))
    port = _bits(((torch.from_numpy(occ).float() - PAR.f32(kmin))
                  * PAR.red_recip(kmin, kmax)).clamp(0.0, 1.0).numpy())
    np.testing.assert_array_equal(port, jitted)
    assert (eager != jitted).any()
