"""The tick's random draws made inside the launches that read them.

With the engine's kernels on, the fused rank + RED/ECN launch draws the
RED uniforms (``ops.tick_rank_red_ecn(rng=)``) and the samplers draw the
path uniforms (``ops.spritz_select(rng=, t=)``, ``ops.weighted_sample``)
from the carry's key and the tick, in place of a ``tick_draws`` launch.
On the CPU each wrapper runs ``tick_draws``' plain version and then its
consumer's plain version; these tests hold that to the two-step form and
the sampler to the JAX reference's ``weighted_sample_rows`` on the
tick's ``k_path``, bit for bit, check that each wrapper takes exactly
one of the given uniforms and the key, and count the engine's calls: no
``tick_draws`` at full rate, one with ``n_flows=0`` a step under a
capacity plan, one sampler call a step.  The engine with kernels on
equals the reference for all 11 schemes in ``tests/test_torch_engine.py``
and under a degraded plan in ``tests/test_torch_capacity.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.net.policies import base as JPB  # noqa: E402
from repro.net.sim import engine as JE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.net.policies import base as PB  # noqa: E402
from repro_torch.net.sim import build as B  # noqa: E402
from repro_torch.net.sim import engine as E  # noqa: E402
from repro_torch.net.sim import failures as FF  # noqa: E402
from repro_torch.net.topology.dragonfly import make_dragonfly  # noqa: E402

RNG = np.random.default_rng(29)
CASES = [(1056, 5024, 0, 0), (37, 129, 513, 7), (1, 1, 2**31 - 1, 2**31 - 1),
         (6, 0, 70000, 12345)]       # (F, M, t, seed)
KW = dict(qsize=88, kmin=17.6, kmax=70.4)


def _key(seed):
    return torch.tensor([0, seed], dtype=torch.int64)


def _weights(F, P):
    w = np.exp(RNG.normal(0, 4, (F, P))) * (RNG.random((F, P)) < 0.7)
    w[RNG.integers(0, F, 2)] = 0.0                        # all-zero rows
    return torch.as_tensor(w, dtype=torch.float32)


@pytest.mark.parametrize("F,M,t,seed", CASES)
def test_fused_launch_draws_unif_like_tick_draws(F, M, t, seed):
    n_ports = max(M // 3, 1)
    port = torch.as_tensor(RNG.integers(-1, n_ports + 2, M), dtype=torch.int32)
    enq = torch.as_tensor((RNG.random(M) < 0.7) & (port.numpy() < n_ports))
    tails = torch.as_tensor(t + RNG.integers(-50, 100, n_ports).clip(
        -t, 2**31 - 1 - t), dtype=torch.int32)
    tt = torch.tensor(t, dtype=torch.int32)
    kw = dict(KW, n_ports=n_ports)
    unif = ref.tick_draws_reference(_key(seed), tt, n_flows=F, n_cand=M)[1]
    got = ops.tick_rank_red_ecn(port, enq, q_tail=tails, t=tt,
                                rng=_key(seed), **kw)
    want = ops.tick_rank_red_ecn(port, enq, unif, tails, tt, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("F,M,t,seed", CASES)
@pytest.mark.parametrize("P", [1, 17, 64])
def test_samplers_draw_u_path_like_tick_draws(F, M, t, seed, P):
    w = _weights(F, P)
    front = torch.as_tensor(RNG.integers(-1, P, F), dtype=torch.int32)
    count = torch.as_tensor(RNG.integers(0, 60, F), dtype=torch.int32)
    tt = torch.tensor(t, dtype=torch.int32)
    u_path = ref.tick_draws_reference(_key(seed), tt, n_flows=F,
                                      n_cand=M)[0]
    got = ops.spritz_select(w, None, front, count, explore_threshold=44,
                            rng=_key(seed), t=tt)
    want = ops.spritz_select(w, u_path[:, 0], front, count,
                             explore_threshold=44)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and torch.equal(g, v)
    sampled = ops.weighted_sample(w, _key(seed), t)
    assert sampled.dtype == torch.int32
    assert torch.equal(sampled, PB.weighted_sample_rows(u_path, w))
    # the reference's sampler on the tick's k_path
    k_path = JE._tick_keys(jax.random.PRNGKey(seed), jnp.int32(t))[0]
    jw = np.asarray(JPB.weighted_sample_rows(k_path, jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(sampled.numpy(), jw)


@pytest.mark.parametrize("P", [1, 17, 64, 256])
@pytest.mark.parametrize("F,t,seed", [(1056, 0, 0), (37, 2**31 - 1, 7),
                                      (3, 513, 2**31 - 1)])
def test_weighted_sample_rows_up_to_256_paths(F, t, seed, P):
    """The sampler at P 1 to 256 (a lane's eight registers full), on a
    tensor tick, with all-zero rows, equals the torch form and the
    reference's sampler on the tick's k_path."""
    w = _weights(F, P)
    w[0] = 0.0
    tt = torch.tensor(t, dtype=torch.int32)
    u_path = ref.tick_draws_reference(_key(seed), tt, n_flows=F, n_cand=0)[0]
    sampled = ops.weighted_sample(w, _key(seed), tt)
    assert sampled.dtype == torch.int32
    assert torch.equal(sampled, PB.weighted_sample_rows(u_path, w))
    assert torch.equal(sampled, ops.weighted_sample(w, _key(seed), t))
    k_path = JE._tick_keys(jax.random.PRNGKey(seed), jnp.int32(t))[0]
    jw = np.asarray(JPB.weighted_sample_rows(k_path, jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(sampled.numpy(), jw)


@pytest.mark.parametrize("drawn", [True, False], ids=["in_place", "given"])
def test_sample_path_equals_weighted_sample_rows(drawn):
    F, P, t = 40, 24, 777
    w = _weights(F, P)
    tt = torch.tensor(t, dtype=torch.int32)
    u_path = ref.tick_draws_reference(_key(3), tt, n_flows=F, n_cand=0)[0]
    z = torch.zeros(F, dtype=torch.int32)
    ctx = PB.SendCtx(u=None if drawn else u_path, t=tt, active=z.bool(),
                     occ=z, weights=w, static_path=z, rng=_key(3))
    assert torch.equal(PB.sample_path(ctx, w),
                       PB.weighted_sample_rows(u_path, w))


def test_wrappers_take_exactly_one_source_of_uniforms():
    M, F = 8, 4
    z = torch.zeros(M, dtype=torch.int32)
    u, key, tt = torch.zeros(M), _key(1), torch.tensor(0, dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    kw = dict(KW, n_ports=3)
    with pytest.raises(ValueError, match="exactly one"):
        ops.tick_rank_red_ecn(z, z.bool(), u, q, tt, rng=key, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        ops.tick_rank_red_ecn(z, z.bool(), None, q, tt, **kw)
    w, zf = torch.ones((F, 5)), torch.zeros(F, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        ops.spritz_select(w, u[:F], zf, zf, explore_threshold=4, rng=key,
                          t=tt)
    with pytest.raises(ValueError, match="exactly one"):
        ops.spritz_select(w, None, zf, zf, explore_threshold=4)
    with pytest.raises(ValueError, match="needs t"):
        ops.spritz_select(w, None, zf, zf, explore_threshold=4, rng=key)
    with pytest.raises(ValueError):
        ops.weighted_sample(w, key[:1], tt)                  # not [2]
    with pytest.raises(ValueError):
        ops.weighted_sample(w, key.int(), tt)                # not int64
    with pytest.raises(ValueError):
        ops.weighted_sample(torch.ones((F, 300)), key, tt)   # P > 256


def test_consumers_without_a_draw_raise():
    """With the kernels on the engine passes no ``u``: a torch-form
    consumer raises instead of drawing on its own."""
    from repro_torch.net.policies import spritz as SP
    F, P = 4, 6
    st = SP.init_state(torch.ones((F, P)))
    tt = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs the path draw"):
        SP.send_logic(st, SP.SpritzConfig(use_kernels=False), None, tt,
                      torch.ones(F, dtype=torch.bool), _key(0))
    with pytest.raises(TypeError):
        PB.weighted_sample_rows(None, torch.ones((F, P)))


DF = make_dragonfly(4, 2, 2)
FLOWS = [B.Flow(e, 40 + (e % 3), 64, start_tick=8 * e) for e in range(5)]


@pytest.fixture
def calls(monkeypatch):
    """The engine's calls of the draws and of the two samplers (on the
    CPU each runs its plain version), with tick_draws' sizes."""
    seen = {"tick_draws": [], "weighted_sample": 0, "spritz_select": 0}
    draws = ops.tick_draws

    def tick_draws(rng, t, *, n_flows, n_cand):
        seen["tick_draws"].append(n_flows)
        return draws(rng, t, n_flows=n_flows, n_cand=n_cand)
    monkeypatch.setattr(ops, "tick_draws", tick_draws)
    for name in ("weighted_sample", "spritz_select"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            assert _name != "spritz_select" or kw.get("rng") is not None
            seen[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    return seen


@pytest.mark.parametrize("plan", ["none", "degraded"])
@pytest.mark.parametrize("scheme", ["ecmp", "ugal_l", "spritz_spray_w"])
def test_engine_draws_in_the_consumers(calls, plan, scheme):
    sched = None
    if plan == "degraded":
        sched = FF.FailureSchedule(DF).degrade_links(
            60, FF.sample_links(DF, 3, seed=3), 0.25, until=900)
    spec = B.build_spec(DF, FLOWS, scheme, n_ticks=1 << 11,
                        failure_plan=sched, block_ticks=512)
    res = E._eager_run(spec, 0, device="cpu")
    n = res.steps_executed
    assert n > 0
    # the capacity plan's torch RED math reads unif: drawn alone there
    assert calls["tick_draws"] == ([0] * n if plan == "degraded" else [])
    assert calls["weighted_sample"] == (n if scheme == "ugal_l" else 0)
    assert calls["spritz_select"] == (n if scheme.startswith("spritz")
                                      else 0)
