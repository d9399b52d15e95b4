"""The port's flow-level engine (``repro_torch.fabric.flowsim``) equals
the reference's (``repro.fabric.flowsim``) bit for bit on the CPU.

The water-filler with and without live capacities on random
incidences, both samplers from the same seed (all-zero rows and tied
weights included), the hot-link quantile on integer loads with ties,
the path tables, every registered scheme's ``FlowResult`` (the ``fct``
bytes, ``reselections``, ``epochs``, ``forced``, ``rate_violations``) on
contended flow sets over DF(4,2,2) and SF(5, p=2), ``simulate_batch``
lanes against solo runs and against the reference's sweep, and the
reference's own regressions (``t_end``, fct relative to start, the
zero-epoch run, a scheme given by code or ``PolicyDef``).  Failure and
capacity plans are in ``test_torch_flowsim_failures.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fabric import flowsim as JF  # noqa: E402
from repro.net.policies import registry as JREG  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly as j_df  # noqa: E402
from repro.net.topology.slimfly import make_slimfly as j_sf  # noqa: E402
from repro_torch.fabric import flowsim as TF  # noqa: E402
from repro_torch.net.policies import registry as TREG  # noqa: E402
from repro_torch.net.topology.dragonfly import make_dragonfly as t_df  # noqa: E402
from repro_torch.net.topology.slimfly import make_slimfly as t_sf  # noqa: E402

TOPOS = {"df": (j_df(4, 2, 2), t_df(4, 2, 2)),
         "sf": (j_sf(5, p=2), t_sf(5, p=2))}
SCHEMES = JREG.names()
RESULT_FIELDS = ("reselections", "epochs", "forced", "rate_violations")


def contended(topo_key, seed=7, pkts=24, start_step=0.0):
    """Two permutations' worth of flows that share links (the reference's
    ``_contended_flows``), as both packages' FlowSpecs."""
    rng = np.random.default_rng(seed)
    n = TOPOS[topo_key][0].n_endpoints
    out = [(int(s), int(d), 4096.0 * pkts, i * start_step)
           for i, (s, d) in enumerate(zip(rng.permutation(n),
                                          rng.permutation(n))) if s != d]
    return ([JF.FlowSpec(*f) for f in out], [TF.FlowSpec(*f) for f in out])


def assert_same_result(a, b, ctx=""):
    """Every reference field equal; fct byte for byte."""
    assert [f.name for f in dataclasses.fields(b)] == \
        [f.name for f in dataclasses.fields(a)]
    assert a.fct.dtype == b.fct.dtype and a.fct.shape == b.fct.shape, ctx
    assert a.fct.tobytes() == b.fct.tobytes(), (ctx, np.flatnonzero(
        a.fct != b.fct)[:5])
    for k in RESULT_FIELDS:
        assert getattr(a, k) == getattr(b, k), (ctx, k, getattr(a, k),
                                                getattr(b, k))


# ------------------------------------------------------------ water-filling

def _incidence(seed, F=40, H=5, n_links=30):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_links, (F, H))
    valid = rng.random((F, H)) < 0.8
    valid[:, 0] = True
    idx = np.where(valid, idx, -1)
    active = rng.random(F) < 0.85
    return idx, valid, active, n_links


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("caps", ["none", "fractional", "with_zeros"])
def test_maxmin_dense_equal(seed, caps):
    idx, valid, active, n_links = _incidence(seed)
    rng = np.random.default_rng(100 + seed)
    cap0 = None
    if caps != "none":
        cap0 = 1.0 / rng.integers(1, 5, n_links)
        if caps == "with_zeros":
            cap0[rng.random(n_links) < 0.15] = 0.0
    want = JF._maxmin_rates_dense(idx, valid, active, n_links, cap0=cap0)
    reads = TF._Reads()
    got = TF._maxmin_rates_dense(
        torch.as_tensor(idx), torch.as_tensor(valid),
        torch.as_tensor(active), n_links,
        cap0=None if cap0 is None else torch.as_tensor(cap0), reads=reads)
    assert got.dtype == torch.float64
    assert got.numpy().tobytes() == want.tobytes()
    assert reads.level >= 1 and reads.epoch == 0     # one read a level


@pytest.mark.parametrize("seed", range(4))
def test_maxmin_front_end_equal(seed):
    """The list front end (the signature ``tests/test_property.py`` pins
    on the reference), with an empty link list and inactive flows."""
    rng = np.random.default_rng(seed)
    n_links = 7
    fl = [np.unique(rng.integers(0, n_links, rng.integers(1, 4)))
          for _ in range(12)] + [np.zeros(0, np.int64)]
    active = rng.random(len(fl)) < 0.9
    want = JF._maxmin_rates(fl, n_links, active)
    got = TF._maxmin_rates(fl, n_links, active, device="cpu")
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------- samplers

def _weights(seed, n=50, p=9):
    rng = np.random.default_rng(seed)
    w = rng.random((n, p)) * (rng.random((n, p)) < 0.7)
    w[1::5, :4] = 0.5                   # tied weights
    w[2::9] = 1.0                       # a whole row tied
    w[::7] = 0.0                        # all-zero rows -> -1
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_rows_equal(seed):
    w = _weights(seed)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    want = JF._sample_rows(r1, w)
    got = TF._sample_rows(r2, torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[::7] == -1).all()
    assert r1.random() == r2.random()        # the same draws consumed


@pytest.mark.parametrize("k", [1, 4, 9, 12])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_rows_topk_equal(k, seed):
    w = _weights(seed)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    want = JF._sample_rows_topk(r1, w, k)
    logw = torch.as_tensor(np.log(np.maximum(w, 1e-300)))   # the engine's
    got = TF._sample_rows_topk(r2, torch.as_tensor(w), k, logw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert r1.random() == r2.random()


def test_hot_quantile_on_integer_loads():
    """The hot set is the reference's ``load >= max(1, quantile)`` on
    integer loads with many ties, capacity-normalized ones and none."""
    rng = np.random.default_rng(0)
    for i in range(2000):
        n = int(rng.integers(1, 60))
        load = rng.integers(0, int(rng.integers(1, 9)), n).astype(np.float64)
        if i % 3 == 0:
            load = load / np.where(rng.random(n) < 0.3, 0.25, 1.0)
        frac = (0.85, 0.5, 0.99, 0.0, 1.0)[i % 5]
        pos = load[load > 0]
        want = load >= max(1.0, np.quantile(pos, frac)) if len(pos) \
            else np.zeros(n, bool)
        got = TF._hot_links(torch.as_tensor(load), load, frac)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ path tables

def test_flow_table_equal():
    ja, ta = TOPOS["df"]
    jf, tf = contended("df", seed=3)
    for mp in (64, 8):
        a = JF.build_flow_table(ja, jf, max_paths=mp)
        b = TF.build_flow_table(ta, tf, max_paths=mp)
        for f in dataclasses.fields(a):
            if f.name == "topo":
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, f.name
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name
        for s in (1.0, 3.0):
            np.testing.assert_array_equal(a.weights(s), b.weights(s))
    db_j, db_t = JF.PathDB(ja), TF.PathDB(ta)
    for fj, ft in zip(jf[:10], tf[:10]):
        assert db_j.ports_of(fj, 0) == db_t.ports_of(ft, 0)
    for s, d in [(0, 5), (3, 3), (7, 30), (12, 13)]:
        np.testing.assert_array_equal(db_j.table(s, d).minimal_mask(),
                                      db_t.table(s, d).minimal_mask())


# ------------------------------------------------------------ all schemes

@pytest.mark.parametrize("topo", ["df", "sf"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_equals_reference(topo, scheme):
    ja, ta = TOPOS[topo]
    jf, tf = contended(topo)
    for seed in (0, 3):
        a = JF.simulate(ja, jf, scheme, seed=seed)
        b = TF.simulate(ta, tf, scheme, seed=seed, device="cpu")
        assert_same_result(a, b, (topo, scheme, seed))
        st = b.stats
        assert (st.scheme, st.seed, st.epochs, st.device) == \
            (scheme, seed, b.epochs, "cpu/cpu")
        # one read a level, plus the read that ends each fill
        assert st.reads_level >= st.levels > 0
    if JREG.flow_rule(scheme).kind != "static":
        assert a.reselections > 0


def test_registry_flow_rules_equal():
    assert TREG.names() == JREG.names()
    for name in SCHEMES:
        assert dataclasses.asdict(TREG.flow_rule(name)) == \
            dataclasses.asdict(JREG.flow_rule(name))


def test_simulate_batch_lane_equals_solo():
    ja, ta = TOPOS["df"]
    jf, tf = contended("df", seed=4, pkts=12)
    names = ["ecmp", "ugal_l", "spritz_spray_w", "reps"]
    want = JF.simulate_batch(ja, jf, names, seeds=[0, 5])
    got = TF.simulate_batch(ta, tf, names, seeds=[0, 5], device="cpu")
    assert list(got) == list(want) == names
    for name in names:
        for seed, a, b in zip([0, 5], want[name], got[name]):
            assert_same_result(a, b, (name, seed))
            solo = TF.simulate(ta, tf, name, seed=seed, device="cpu")
            assert_same_result(solo, b, (name, seed, "solo"))
    with pytest.raises(ValueError, match="duplicate"):
        TF.simulate_batch(ta, tf, ["ecmp", TREG.by_name("ecmp").code],
                          device="cpu")


# ------------------------------------------- the reference's regressions

@pytest.mark.parametrize("scheme", ["ecmp", "ugal_l", "spritz_spray_w"])
def test_t_end_horizon_equal(scheme):
    """Staggered starts stopped at a serving horizon: completions up to
    t_end record, flows in flight keep -1."""
    ja, ta = TOPOS["df"]
    jf, tf = contended("df", seed=5, pkts=16, start_step=6000.0)
    for t_end in (2.5e5, 4e5):
        a = JF.simulate(ja, jf, scheme, seed=2, t_end=t_end)
        b = TF.simulate(ta, tf, scheme, seed=2, t_end=t_end, device="cpu")
        assert_same_result(a, b, (scheme, t_end))
        assert (b.fct < 0).any() and (b.fct >= 0).any()


def test_fct_is_relative_to_start():
    ja, ta = TOPOS["df"]
    spec = dict(src_ep=0, dst_ep=40, size_bytes=50000.0, start=1 << 20)
    a = JF.simulate(ja, [JF.FlowSpec(**spec)], "minimal")
    b = TF.simulate(ta, [TF.FlowSpec(**spec)], "minimal", device="cpu")
    assert_same_result(a, b)
    assert b.fct[0] == pytest.approx(50000.0)


def test_zero_epoch_run_is_defined():
    ja, ta = TOPOS["df"]
    a = JF.simulate(ja, [JF.FlowSpec(0, 40, 1000.0)], "ecmp", max_epochs=0)
    b = TF.simulate(ta, [TF.FlowSpec(0, 40, 1000.0)], "ecmp", max_epochs=0,
                    device="cpu")
    assert_same_result(a, b)
    assert b.epochs == 0 and (b.fct == -1).all()
    assert b.stats.levels == 0


def test_empty_flow_set():
    ja, ta = TOPOS["df"]
    a = JF.simulate(ja, [], "spritz_spray_w")
    b = TF.simulate(ta, [], "spritz_spray_w", device="cpu")
    assert_same_result(a, b)


def test_scheme_accepts_code_and_policydef():
    ta = TOPOS["df"][1]
    flows = [TF.FlowSpec(0, 40, 4096.0)]
    by_name = TF.simulate(ta, flows, "ecmp", device="cpu")
    by_code = TF.simulate(ta, flows, TREG.by_name("ecmp").code, device="cpu")
    by_def = TF.simulate(ta, flows, TREG.by_name("ecmp"), device="cpu")
    assert by_name.fct[0] == by_code.fct[0] == by_def.fct[0] == 4096.0
    assert by_code.stats.scheme == by_def.stats.scheme == "ecmp"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ta = TOPOS["df"][1]
    flows = [TF.FlowSpec(0, 40, 4096.0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.simulate(ta, flows, "ecmp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.simulate_batch(ta, flows, ["ecmp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF._maxmin_rates([np.array([0])], 1, np.ones(1, bool))
