"""The port on the card equals the port on the CPU.

The CPU port is held against the JAX reference by the other
``test_torch_*`` files; these tests carry that to the card without JAX:
each CUDA kernel against its plain version at small and ragged shapes
(the tick kernels bit for bit, attention and RWKV-6 within the
tolerances of ``tests/test_kernels.py``), the whole engine on DF(4,2,2)
on ``cuda`` against the same run on ``cpu`` for all 11 schemes, for the
kernels and for the engine's torch forms, and under a mid-run failure
plan and a degraded (capacity) plan with the launches of each phase-E
form and of the draws (made inside the launches that read them: the
fused phase-E launch and the samplers; ``tick_draws`` only under a
capacity plan), the flow-level engine on ``cuda`` against ``cpu`` for all 11
schemes (plain, under a capacity plan, stopped at ``t_end``) with a
cut-down cross-engine cell, the reduced dense and RWKV models on
``cuda`` against ``cpu`` within 1e-4, attention's backward kernel
against its plain version (and its bits stable from call to call), the
Mamba scan's kernels against their plain versions and the reduced
Jamba's loss and gradients, and three train steps of reduced models on
``cuda`` against ``cpu``.  They
need a card and skip without one.  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.fabric import flowsim as FS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.net.sim import build as B  # noqa: E402
from repro_torch.net.sim import engine as E  # noqa: E402
from repro_torch.net.sim import failures as FF  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.net.topology.dragonfly import make_dragonfly  # noqa: E402

pytestmark = pytest.mark.cuda

FLOWS = [(e, 40 + (e % 3), 40 + 8 * (e % 2), 16 * e) for e in range(6)]
# the schemes that sample a weighted path per packet (ops.weighted_sample)
SAMPLERS = ("valiant", "ugal_l", "flicr_w", "ops_u", "ops_w", "reps")
RNG = np.random.default_rng(3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(a, dtype, dev):
    t = torch.as_tensor(np.ascontiguousarray(a)).to(dtype)
    return t, t.to(dev)


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("K,N,F", [(6, 513, 16), (2, 7000, 1056), (1, 1, 1),
                                   (6, 33856, 1056), (3, 0, 40),
                                   (6, 3000, 9700)])
@pytest.mark.parametrize("dtype", ["int32", "bool", "uint8"])
def test_flow_agg_kernel(cuda, K, N, F, dtype):
    rows = RNG.random((K, N)) < 0.2
    if dtype != "bool":
        rows = rows * RNG.integers(1, 50 if dtype == "int32" else 256, (K, N))
    rows_c, rows_g = _pair(rows, getattr(torch, dtype), cuda)
    pf_c, pf_g = _pair(RNG.integers(-1, F + 2, N), torch.int32, cuda)
    _equal(ops.flow_agg(rows_g, pf_g, n_flows=F),
           ref.flow_agg_reference(rows_c, pf_c, n_flows=F))


def _stable_rank(port, n_ports):
    """The rank by a stable sort: position in the sorted run of equal
    buckets (for shapes whose one-hot plain version is too large)."""
    b = np.where((port < 0) | (port >= n_ports), n_ports, port)
    order = np.argsort(b, kind="stable")
    srt = b[order]
    rank = np.empty(len(b), np.int32)
    rank[order] = np.arange(len(b)) - np.searchsorted(srt, srt, "left")
    return torch.from_numpy(rank)


@pytest.mark.parametrize("M,P,kind", [
    (1, 1, "random"), (257, 8, "random"), (5024, 3960, "random"),
    (5024, 3960, "one_port"), (3960, 3960, "distinct"),
    (5024, 3960, "sentinel"), (5023, 3960, "random"),
    (65536, 64, "random"), (2000, 70000, "random")])
def test_tick_rank_kernel(cuda, M, P, kind):
    port = {"random": lambda: RNG.integers(-1, P + 2, M),
            "one_port": lambda: np.full(M, 5),
            "distinct": lambda: RNG.permutation(P)[:M],
            "sentinel": lambda: np.full(M, P)}[kind]()
    pc, pg = _pair(port, torch.int32, cuda)
    path = ops.tick_rank_plan(M, P)[0]
    ops.reset_launches()
    got = ops.tick_rank(pg, n_ports=P)
    assert ops.TICK_RANK_PATHS[path] == 1
    assert path == ("pairwise" if P == 70000 else "smem")
    want = (_stable_rank(port, P) if M * (P + 1) > 1 << 26
            else ref.tick_rank_reference(pc, n_ports=P))
    _equal(got, want)


@pytest.mark.parametrize("M,P,t", [(17, 4, 0), (5024, 3960, 70000)])
def test_red_ecn_kernel(cuda, M, P, t):
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    ins = [_pair(RNG.integers(0, P + 1, M), torch.int32, cuda),
           _pair(RNG.integers(0, 90, M), torch.int32, cuda),
           _pair(RNG.random(M) < 0.7, torch.bool, cuda),
           _pair(RNG.random(M), torch.float32, cuda),
           _pair(t + RNG.integers(-50, 100, P), torch.int32, cuda)]
    _equal(ops.red_ecn(*[g for _, g in ins], t, **kw),
           ref.red_ecn_reference(*[c for c, _ in ins], t, **kw))


@pytest.mark.parametrize("M,P,t,kind", [
    (5024, 3960, 0, "random"), (5024, 3960, 70000, "random"),
    (17, 4, 0, "random"), (1, 1, 0, "random"), (5024, 3960, 0, "sentinel"),
    (65536, 64, 500, "random"), (2000, 70000, 500, "random")])
def test_tick_rank_red_ecn_kernel(cuda, M, P, t, kind):
    # the fused launch against tick_rank's then red_ecn's plain versions,
    # on the smem path and (P 70,000) the pairwise one
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    port = (np.full(M, P) if kind == "sentinel"
            else RNG.integers(-1, P + 2, M))
    ins = [_pair(port, torch.int32, cuda),
           _pair((RNG.random(M) < 0.7) & (port < P), torch.bool, cuda),
           _pair(RNG.random(M), torch.float32, cuda),
           _pair(t + RNG.integers(-50, 100, P), torch.int32, cuda)]
    path = ops.tick_rank_plan(M, P)[0]
    ops.reset_launches()
    got = ops.tick_rank_red_ecn(*[g for _, g in ins], t, **kw)
    assert ops.TICK_RANK_PATHS[path] == ops.LAUNCHES["tick_rank_red_ecn"] == 1
    assert path == ("pairwise" if P == 70000 else "smem")
    pc = ins[0][0]
    rank = (_stable_rank(port, P) if M * (P + 1) > 1 << 26
            else ref.tick_rank_reference(pc, n_ports=P))
    _equal(got, ref.red_ecn_reference(pc, rank, *[c for c, _ in ins[1:]], t,
                                      **kw)[1:])


@pytest.mark.parametrize("F,P", [(1, 1), (100, 37), (1056, 64), (9, 256),
                                 (64, 16), (50, 17), (300, 256)])
@pytest.mark.parametrize("u_kind", ["random", "zero", "below_one"])
def test_spritz_select_kernel(cuda, F, P, u_kind):
    w = np.exp(RNG.normal(0, 5, (F, P))) * (RNG.random((F, P)) < 0.8)
    u = {"random": RNG.random(F), "zero": np.zeros(F),
         "below_one": np.full(F, np.nextafter(np.float32(1),
                                              np.float32(0)))}[u_kind]
    ins = [_pair(w, torch.float32, cuda),
           _pair(u, torch.float32, cuda),
           _pair(RNG.integers(-1, P, F), torch.int32, cuda),
           _pair(RNG.integers(0, 60, F), torch.int32, cuda)]
    _equal(ops.spritz_select(*[g for _, g in ins], explore_threshold=44),
           ref.spritz_select_reference(*[c for c, _ in ins],
                                       explore_threshold=44))


@pytest.mark.parametrize("use_kernels", [None, False],
                         ids=["kernels", "torch_forms"])
@pytest.mark.parametrize("dense", [False, True], ids=["compressed", "dense"])
@pytest.mark.parametrize("scheme", ["minimal", "valiant", "ugal_l", "ecmp",
                                    "flicr_w", "ops_u", "ops_w",
                                    "spritz_scout", "spritz_spray_u",
                                    "spritz_spray_w", "reps"])
def test_engine_on_card_equals_cpu(cuda, scheme, dense, use_kernels):
    topo = make_dragonfly(4, 2, 2)
    flows = [B.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    spec = B.build_spec(topo, flows, scheme, n_ticks=1 << 12,
                        use_kernels=use_kernels)
    launched, got = _card_equals_cpu(spec, cuda, reference=dense)
    if use_kernels is None:     # phase E: one fused launch, no other
        assert launched["flow_agg"] > 0 and launched["tick_rank_red_ecn"] > 0
        assert launched["tick_rank"] == launched["red_ecn"] == 0
        # the draws are made in the launches that read them
        assert launched["tick_draws"] == 0
        assert (launched["weighted_sample"] > 0) == (scheme in SAMPLERS)
        assert (launched["spritz_select"] > 0) == scheme.startswith("spritz")
    else:
        assert sum(launched.values()) == 0


def _card_equals_cpu(spec, cuda, **kw):
    """Runs ``spec`` on the card, then on the CPU; every result field,
    counter and carry leaf (every policy substate) equal.  Returns the
    card run's launches and result."""
    ops.reset_launches()
    got, gst = E.run(spec, device=cuda, return_carry=True, **kw)
    launched = dict(ops.LAUNCHES)
    want, wst = E.run(spec, device="cpu", return_carry=True, **kw)
    for f in ("fct_ticks", "delivered", "trims", "timeouts", "ooo", "retx",
              "done"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.ticks_simulated, got.steps_executed, got.down_violations,
            got.rate_violations) == (want.ticks_simulated,
                                     want.steps_executed,
                                     want.down_violations,
                                     want.rate_violations)
    for k, v in wst.items():
        if k not in ("policy", "spritz"):
            np.testing.assert_array_equal(gst[k], v, err_msg=k)
    for fam, sub in wst["policy"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(gst["policy"][fam][k], v,
                                          err_msg=f"{fam}.{k}")
    return launched, got


@pytest.mark.parametrize("plan", ["midrun", "degraded"])
@pytest.mark.parametrize("scheme", ["ugal_l", "reps", "spritz_spray_w"])
def test_timeline_on_card_equals_cpu(cuda, plan, scheme):
    """A mid-run failure plan (binary: phase E stays the fused launch) and
    a degraded plan (a capacity plan: the standalone tick_rank once a
    step), card against CPU, with the launches of each."""
    topo = make_dragonfly(4, 2, 2)
    flows = [B.Flow(e, 40 + (e % 3), 96, start_tick=8 * e)
             for e in range(5)]
    links = FF.sample_links(topo, 3, seed=3)
    sched = FF.FailureSchedule(topo)
    if plan == "midrun":
        sched.fail_links(60, links).recover(2500)
    else:
        sched.degrade_links(60, links, 0.25, until=2500)
    spec = B.build_spec(topo, flows, scheme, n_ticks=1 << 13,
                        failure_plan=sched, block_ticks=1024)
    launched, got = _card_equals_cpu(spec, cuda)
    assert got.down_violations == got.rate_violations == 0
    # the graph loop replays one gated step; each replay launches the
    # step's kernels, the replays past the stop (fewer than a read's
    # batch) included
    n = got.replays
    assert 0 <= n - got.steps_executed < E.STEPS_PER_READ
    # the draws are made in place; a capacity plan's torch RED math reads
    # unif, drawn by tick_draws (n_flows 0)
    rank = "tick_rank" if plan == "degraded" else "tick_rank_red_ecn"
    want = dict.fromkeys(launched, 0)
    want.update({"flow_agg": 2 * n, rank: n,
                 "tick_draws": n if plan == "degraded" else 0})
    if scheme.startswith("spritz"):
        want["spritz_select"] = n
    if scheme in SAMPLERS:
        want["weighted_sample"] = n
    assert launched == want
    assert ops.TICK_RANK_PATHS == {"smem": n, "pairwise": 0}


@pytest.mark.parametrize("F,M", [(1056, 5024), (6, 329), (1, 0), (0, 7),
                                 (300, 1)])
@pytest.mark.parametrize("seed,t", [(0, 0), (7, 513), (12345, 70000),
                                    (2**31 - 1, 2**31 - 1)])
def test_tick_draws_kernel(cuda, F, M, seed, t):
    rng = torch.tensor([0, seed], dtype=torch.int64)
    tt = torch.tensor(t, dtype=torch.int32)
    got = ops.tick_draws(rng.to(cuda), tt.to(cuda), n_flows=F, n_cand=M)
    _equal(got, ref.tick_draws_reference(rng, tt, n_flows=F, n_cand=M))


def _rank_red_drawn(port, enq, tails, rng, t, kw):
    """tick_rank's, then red_ecn's plain versions on the tick's unif."""
    unif = ref.tick_draws_reference(rng, t, n_flows=0,
                                    n_cand=port.shape[0])[1]
    rank = (_stable_rank(port.numpy(), kw["n_ports"])
            if port.shape[0] * (kw["n_ports"] + 1) > 1 << 26
            else ref.tick_rank_reference(port, n_ports=kw["n_ports"]))
    return ref.red_ecn_reference(port, rank, enq, unif, tails, t, **kw)[1:]


@pytest.mark.parametrize("M,P", [(5024, 3960), (17, 4), (1, 1),
                                 (2000, 70000)])
@pytest.mark.parametrize("seed,t", [(0, 0), (12345, 70000),
                                    (2**31 - 1, 2**31 - 1)])
def test_tick_rank_red_ecn_draws_in_place(cuda, M, P, seed, t):
    """The fused launch with ``rng=`` (unif drawn in the launch) against
    the tick's ``unif`` from tick_draws' plain version, then tick_rank's
    and red_ecn's; occupancies on both sides of the RED band."""
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    port = torch.as_tensor(RNG.integers(-1, P + 2, M), dtype=torch.int32)
    enq = torch.as_tensor((RNG.random(M) < 0.7) & (port.numpy() < P))
    tails = torch.as_tensor(                        # no int32 overflow
        t + RNG.integers(-50, 100, P).clip(-t, 2**31 - 1 - t),
        dtype=torch.int32)
    rng = torch.tensor([0, seed], dtype=torch.int64)
    tt = torch.tensor(t, dtype=torch.int32)
    ops.reset_launches()
    got = ops.tick_rank_red_ecn(port.to(cuda), enq.to(cuda),
                                q_tail=tails.to(cuda), t=tt.to(cuda),
                                rng=rng.to(cuda), **kw)
    assert ops.LAUNCHES["tick_rank_red_ecn"] == 1
    assert ops.TICK_RANK_PATHS[ops.tick_rank_plan(M, P)[0]] == 1
    _equal(got, _rank_red_drawn(port, enq, tails, rng, tt, kw))


@pytest.mark.parametrize("F,P", [(1056, 64), (1, 1), (100, 37), (9, 256),
                                 (50, 17)])
@pytest.mark.parametrize("seed,t", [(0, 0), (7, 513),
                                    (2**31 - 1, 2**31 - 1)])
def test_samplers_draw_in_place(cuda, F, P, seed, t):
    """``spritz_select`` with ``rng=`` and ``weighted_sample`` against
    the tick's ``u_path`` from tick_draws' plain version, then the plain
    selection and sample."""
    w = np.exp(RNG.normal(0, 5, (F, P))) * (RNG.random((F, P)) < 0.8)
    w[RNG.integers(0, F, 2)] = 0.0                     # all-zero rows
    w = torch.as_tensor(w, dtype=torch.float32)
    front = torch.as_tensor(RNG.integers(-1, P, F), dtype=torch.int32)
    count = torch.as_tensor(RNG.integers(0, 60, F), dtype=torch.int32)
    rng = torch.tensor([0, seed], dtype=torch.int64)
    tt = torch.tensor(t, dtype=torch.int32)
    u = ref.tick_draws_reference(rng, tt, n_flows=F, n_cand=0)[0]
    g = [x.to(cuda) for x in (w, front, count, rng, tt)]
    ops.reset_launches()
    _equal(ops.spritz_select(g[0], None, g[1], g[2], explore_threshold=44,
                             rng=g[3], t=g[4]),
           ref.spritz_select_reference(w, u[:, 0], front, count,
                                       explore_threshold=44))
    _equal(ops.weighted_sample(g[0], g[3], g[4]),
           ref.spritz_select_reference(
               w, u[:, 0], torch.full_like(front, -1),
               torch.zeros_like(count), explore_threshold=44)[0])
    assert ops.LAUNCHES["spritz_select"] == ops.LAUNCHES["weighted_sample"] \
        == 1


@pytest.mark.parametrize("F,P", [(1056, 64), (1, 1), (100, 37), (9, 256),
                                 (50, 17)])
@pytest.mark.parametrize("seed,t", [(0, 0), (2**31 - 1, 2**31 - 1)])
def test_weighted_sample_kernel(cuda, F, P, seed, t):
    """The sampler's own kernel against its plain version."""
    w = np.exp(RNG.normal(0, 5, (F, P))) * (RNG.random((F, P)) < 0.8)
    w[RNG.integers(0, F, 2)] = 0.0                     # all-zero rows
    w = torch.as_tensor(w, dtype=torch.float32)
    rng = torch.tensor([0, seed], dtype=torch.int64)
    tt = torch.tensor(t, dtype=torch.int32)
    want = ref.weighted_sample_reference(w, rng, tt)
    g = [x.to(cuda) for x in (w, rng, tt)]
    ops.reset_launches()
    got = ops.weighted_sample(*g)
    _equal(got, want)
    assert ops.LAUNCHES["weighted_sample"] == 1


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_step_gradients_repeat_on_card(cuda, plain):
    """The reduced Jamba's step gradients (microbatch 0 and 2) on the card
    are the same bits twice, through the kernels and through their plain
    versions: the embedding's backward sums in a fixed order, as every
    other op of the step does (``chip_smoke.py`` phase 6b holds the
    ``dt_bias`` gradients of both paths against the f64 step)."""
    import contextlib

    from repro_torch.train import step as STEP
    from repro_torch.train import yardstick as Y
    cfg = dataclasses.replace(C.get_reduced("jamba_1_5_large"),
                              dtype=torch.float32)
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(0)).to(cuda)
    model.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 65)), device=cuda)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = STEP.make_loss_fn(cfg)
    ctx = Y.plain_versions() if plain else contextlib.nullcontext()
    with ctx:
        for mb in (0, 2):
            g1, g2 = (STEP.step_grads(loss_fn, model, b, mb)
                      for _ in range(2))
            assert [n for n in g1 if not torch.equal(g1[n], g2[n])] == []


def test_captured_kernels_read_each_replays_tick(cuda):
    """The tick is read from device memory: a graph that captured the
    fused rank + RED/ECN launch (unif given, and drawn in place), the
    draws launch and the samplers drawing in place gives, at each
    replay, the plain versions' results at the tick it holds then."""
    M, P, F = 5024, 3960, 1056
    port = torch.as_tensor(RNG.integers(0, P + 1, M), dtype=torch.int32)
    enq = torch.as_tensor(RNG.random(M) < 0.7)
    unif = torch.as_tensor(RNG.random(M), dtype=torch.float32)
    tails = torch.as_tensor(RNG.integers(0, 90, P), dtype=torch.int32)
    rng = torch.tensor([0, 5], dtype=torch.int64)
    w = torch.as_tensor(RNG.random((F, 64)) * 8, dtype=torch.float32)
    front = torch.as_tensor(RNG.integers(-1, 64, F), dtype=torch.int32)
    count = torch.as_tensor(RNG.integers(0, 60, F), dtype=torch.int32)
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    ins = [x.to(cuda) for x in (port, enq, unif, tails, rng)]
    sel = [x.to(cuda) for x in (w, front, count)]
    t = torch.zeros((), dtype=torch.int32, device=cuda)

    def step():
        return (ops.tick_rank_red_ecn(*ins[:4], t, **kw),
                ops.tick_draws(ins[4], t, n_flows=F, n_cand=M),
                ops.tick_rank_red_ecn(*ins[:2], q_tail=ins[3], t=t,
                                      rng=ins[4], **kw),
                ops.spritz_select(sel[0], None, sel[1], sel[2],
                                  explore_threshold=44, rng=ins[4], t=t),
                ops.weighted_sample(sel[0], ins[4], t))
    step()                                            # build and warm up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, draws, drawn, selected, sampled = step()
    for tick in (0, 40, 70000):
        t.fill_(tick)
        graph.replay()
        torch.cuda.synchronize()
        tc = torch.tensor(tick, dtype=torch.int32)
        rank = ref.tick_rank_reference(port, n_ports=P)
        _equal(out, ref.red_ecn_reference(port, rank, enq, unif, tails, tc,
                                          **kw)[1:])
        _equal(draws, ref.tick_draws_reference(rng, tc, n_flows=F,
                                               n_cand=M))
        _equal(drawn, _rank_red_drawn(port, enq, tails, rng, tc, kw))
        u = draws[0][:, 0].cpu()
        _equal(selected, ref.spritz_select_reference(
            w, u, front, count, explore_threshold=44))
        _equal(sampled, ref.weighted_sample_reference(w, rng, tc))


def _same_runs(a, ast, b, bst):
    for f in ("fct_ticks", "delivered", "trims", "timeouts", "ooo", "retx",
              "done"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.ticks_simulated, a.steps_executed) == \
        (b.ticks_simulated, b.steps_executed)
    for k, v in bst.items():
        if k not in ("policy", "spritz"):
            np.testing.assert_array_equal(ast[k], v, err_msg=k)
    for fam, sub in bst["policy"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(ast["policy"][fam][k], v,
                                          err_msg=f"{fam}.{k}")


@pytest.mark.parametrize("use_kernels", [None, False],
                         ids=["kernels", "torch_forms"])
@pytest.mark.parametrize("scheme", ["ecmp", "ugal_l", "spritz_scout",
                                    "spritz_spray_w", "reps"])
def test_graph_loop_equals_eager_loop(cuda, scheme, use_kernels):
    """``run`` replays a captured step; the private eager loop calls the
    same step's wrappers: equal results and final carry, and a replay
    launches what one eager step launches."""
    topo = make_dragonfly(4, 2, 2)
    flows = [B.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    spec = B.build_spec(topo, flows, scheme, n_ticks=1 << 12,
                        use_kernels=use_kernels)
    ops.reset_launches()
    got, gst = E.run(spec, device=cuda, return_carry=True)
    graph_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    want, wst = E._eager_run(spec, device=cuda, return_carry=True)
    eager_launches = dict(ops.LAUNCHES)
    _same_runs(got, gst, want, wst)
    assert want.replays == want.steps_executed
    assert 0 <= got.replays - got.steps_executed < E.STEPS_PER_READ
    for k, n in eager_launches.items():
        assert graph_launches[k] * want.replays == n * got.replays, k


def test_run_batch_on_card_equals_cpu(cuda):
    """A sweep on the card, one captured graph a lane spec, equal to the
    same sweep on the CPU; then segmented, lane by lane."""
    topo = make_dragonfly(4, 2, 2)
    flows = [B.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    base = B.build_spec(topo, flows, "spritz_spray_w", n_ticks=1 << 12)
    kw = dict(schemes=["ecmp", "spritz_spray_w", "reps"], seeds=[0, 1],
              return_carry=True, shard=False)
    got = E.run_batch(base, device=cuda, **kw)
    want = E.run_batch(base, device="cpu", **kw)
    for a, ast, b, bst in zip(*got, *want):
        _same_runs(a, ast, b, bst)
    res, st = E.run_batch(base, device=cuda, until_tick=100, **kw)
    cps = [E.checkpoint(r, s) for r, s in zip(res, st)]
    again = E.run_batch(base, device=cuda, resume=cps, **kw)
    for a, ast, b, bst in zip(*again, *want):
        _same_runs(a, ast, b, bst)


def test_run_batch_sharded_equals_one_card(cuda):
    """``shard=None`` with several cards runs the lanes round-robin, one
    thread a card; each lane equals the same lane on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    topo = make_dragonfly(4, 2, 2)
    flows = [B.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    base = B.build_spec(topo, flows, "spritz_spray_w", n_ticks=1 << 12)
    kw = dict(schemes=["ecmp", "spritz_spray_w", "ugal_l", "reps",
                       "spritz_scout"], seeds=[0, 1], return_carry=True)
    E._LOOPS.clear()
    ops.reset_launches()
    got = E.run_batch(base, device=cuda, **kw)
    sharded = dict(ops.LAUNCHES)
    assert {k[2] for k in E._LOOPS} == {f"cuda:{i}" for i in
                                        range(torch.cuda.device_count())}
    ops.reset_launches()
    want = E.run_batch(base, device=cuda, shard=False, **kw)
    assert sharded == dict(ops.LAUNCHES)
    for a, ast, b, bst in zip(*got, *want):
        _same_runs(a, ast, b, bst)


# ------------------------------------------------------ flow-level engine

def _flow_pair(seed=7, pkts=24, start_step=0.0):
    rng = np.random.default_rng(seed)
    n = 72
    return [FS.FlowSpec(int(s), int(d), 4096.0 * pkts, i * start_step)
            for i, (s, d) in enumerate(zip(rng.permutation(n),
                                           rng.permutation(n))) if s != d]


def _same_flow_result(a, b):
    assert a.fct.tobytes() == b.fct.tobytes()
    for k in ("reselections", "epochs", "forced", "rate_violations"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("case", ["plain", "capacity", "t_end"])
@pytest.mark.parametrize("scheme", ["minimal", "valiant", "ugal_l", "ecmp",
                                    "flicr_w", "ops_u", "ops_w",
                                    "spritz_scout", "spritz_spray_u",
                                    "spritz_spray_w", "reps"])
def test_flow_engine_on_card_equals_cpu(cuda, scheme, case):
    """``flowsim.simulate`` with its state on the card equals the CPU
    port bit for bit (the CPU port equals the reference): plain, under a
    capacity plan (a brownout, then an outage with recovery) and stopped
    at a ``t_end`` horizon.  The state lived on the card."""
    topo = make_dragonfly(4, 2, 2)
    kw = {}
    flows = _flow_pair()
    if case == "capacity":
        links = FF.sample_links(topo, 4, seed=2)
        kw["failure_plan"] = (FF.FailureSchedule(topo)
                              .degrade_links(32, links[:2], 0.25, until=900)
                              .fail_links(64, links[2:]).recover(4000))
    if case == "t_end":
        flows = _flow_pair(seed=5, pkts=16, start_step=6000.0)
        kw["t_end"] = 2.5e5
    got = FS.simulate(topo, flows, scheme, seed=3, device=cuda, **kw)
    want = FS.simulate(topo, flows, scheme, seed=3, device="cpu", **kw)
    _same_flow_result(got, want)
    assert got.stats.device == "cuda/cuda" and want.stats.device == "cpu/cpu"
    assert (got.stats.levels, got.stats.reads_level,
            got.stats.reads_epoch) == (want.stats.levels,
                                       want.stats.reads_level,
                                       want.stats.reads_epoch)


def test_argmin_ties_take_the_first_index(cuda):
    """Hot-link eviction picks ``argmin`` over candidate loads that tie
    often (integer counts): on the card, as numpy, the first index."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 3, (4096, 4)).astype(np.float64)
    key[rng.random((4096, 4)) < 0.2] = np.inf
    got = torch.as_tensor(key, device=cuda).argmin(dim=1, keepdim=True)
    np.testing.assert_array_equal(got.cpu().numpy()[:, 0],
                                  np.argmin(key, axis=1))


def test_flow_batch_and_cross_cell_on_card_equal_cpu(cuda, tmp_path):
    """``simulate_batch`` on the card equals the CPU port lane for lane,
    and a cut-down cross-engine cell (both engines on the card) gives the
    CPU port's rows, wall fields excluded."""
    from repro_torch import data as GOLD
    from repro_torch.exp import matrix, runner

    topo = make_dragonfly(4, 2, 2)
    flows = _flow_pair(seed=4, pkts=12)
    names = ["ecmp", "ugal_l", "spritz_spray_w", "reps"]
    got = FS.simulate_batch(topo, flows, names, seeds=[0, 5], device=cuda)
    want = FS.simulate_batch(topo, flows, names, seeds=[0, 5], device="cpu")
    for name in names:
        for a, b in zip(got[name], want[name]):
            _same_flow_result(a, b)
    cell = dataclasses.replace(
        matrix.CELLS["fabric.dragonfly1056.cross.full"],
        cell_id="fabric.dragonfly1056.cross.cut",
        workload_kw={"n_chips": 32, "tp": 16, "shard": 4e4},
        n_ticks=1 << 10)
    a = runner.run_cell(cell, out=tmp_path / "cuda", force=True,
                        verbose=False, device=cuda)
    b = runner.run_cell(cell, out=tmp_path / "cpu", force=True,
                        verbose=False, device="cpu")
    assert GOLD.comparable(a.rows) == GOLD.comparable(b.rows)
    assert a.guards == b.guards


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol


def _within_2x_sdpa(got, q, k, v, kw):
    """bf16: the kernel's max and mean error against the f32 reference on
    the same inputs are within 2x of SDPA's.  The 5e-2 gate alone is
    about the size of a late row's output, so it would pass a kernel
    that is ~10 % off there.  SDPA gets the reference's masking as an
    additive -1e30 bias, so a row with no unmasked key averages V."""
    want = ref.mha_reference(q[0].float(), k[0].float(), v[0].float(), **kw)
    Sq, Sk = q[0].shape[1], k[0].shape[1]
    qpos = kw["q_offset"] + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    keep = kpos <= qpos if kw["causal"] else torch.ones((Sq, Sk), dtype=bool)
    if kw["sliding_window"]:
        keep &= kpos > qpos - kw["sliding_window"]
    bias = torch.zeros((Sq, Sk)).masked_fill(~keep, -1e30)
    qt, kt, vt = (t[1].transpose(1, 2) for t in (q, k, v))
    lib = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(qt), enable_gqa=True).transpose(1, 2)
    ek = (got.cpu().float() - want).abs()
    es = (lib.cpu().float() - want).abs()
    assert float(ek.max()) <= 2 * float(es.max())
    assert float(ek.mean()) <= 2 * float(es.mean())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window,q_offset", [
    (1, 128, 128, 4, 4, 64, 0, 0), (2, 100, 100, 8, 2, 128, 0, 0),
    (2, 1, 300, 8, 2, 128, 0, 250), (3, 77, 333, 4, 1, 32, 0, 256),
    (1, 256, 256, 4, 2, 64, 64, 0), (2, 1, 1, 4, 4, 32, 0, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(cuda, B, Sq, Sk, Hq, Hkv, D, window,
                                q_offset, dtype):
    dt = getattr(torch, dtype)
    q = _pair(RNG.normal(0, 1, (B, Sq, Hq, D)), dt, cuda)
    k = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    v = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    kw = dict(causal=True, sliding_window=window, q_offset=q_offset)
    got = ops.flash_attention(q[1], k[1], v[1], **kw)
    _close(got, ref.mha_reference(q[0], k[0], v[0], **kw),
           2e-5 if dtype == "float32" else 5e-2)
    if dtype == "bfloat16":
        _within_2x_sdpa(got, q, k, v, kw)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window,q_offset,paths,causal", [
    (2, 200, 200, 8, 2, 128, 0, 0, ("wgmma", "simt"), True),  # 800 rows
    (2, 100, 300, 8, 2, 64, 0, 200, ("wgmma", "simt"), True),  # Sk % 64
    (2, 128, 128, 8, 2, 64, 0, 0, ("wgmma", "simt"), True),    # D = 64
    (1, 256, 256, 8, 2, 128, 64, 0, ("wgmma", "simt"), True),  # window
    (1, 64, 1000, 8, 2, 128, 0, 900, ("wgmma", "simt"), True),  # past a cache
    (2, 1, 1024, 8, 2, 128, 0, 0, ("split", "split"), True),   # decode, G 4
    (2, 1, 1024, 8, 2, 128, 0, 63, ("split", "split"), True),
    (2, 1, 1024, 8, 2, 128, 0, 64, ("split", "split"), True),
    (2, 1, 1024, 8, 2, 128, 0, 1000, ("split", "split"), True),
    (2, 1, 100, 8, 2, 64, 16, 300, ("split", "split"), True),  # all masked
    (2, 100, 100, 14, 2, 128, 0, 0, ("wgmma", "simt"), True),  # G = 7
    (1, 300, 300, 14, 2, 128, 64, 0, ("wgmma", "simt"), True),  # G 7, window
    (2, 100, 100, 4, 4, 128, 0, 0, ("wgmma", "simt"), True),   # G = 1
    (2, 1, 1024, 14, 2, 128, 0, 700, ("split", "split"), True),  # decode G 7
    # non-causal (Whisper): cross-attention of a 448-token prefill to
    # 1,500 frames (Sk % 64 = 28), of a decode row to them, and the
    # encoder's self-attention over ragged frames
    (1, 448, 1500, 12, 12, 64, 0, 0, ("wgmma", "simt"), False),
    (2, 1, 1500, 12, 12, 64, 0, 0, ("split", "split"), False),
    (2, 150, 150, 12, 12, 64, 0, 0, ("wgmma", "simt"), False),
], ids=["rows_ragged", "sk_ragged", "d64", "window", "offset", "decode_0",
        "decode_63", "decode_64", "decode_1000", "decode_all_masked", "g7",
        "g7_window", "g1", "decode_g7", "cross_prefill", "cross_decode",
        "encoder"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_paths(cuda, B, Sq, Sk, Hq, Hkv, D, window, q_offset,
                               paths, causal, dtype):
    """Each case reaches the path it is meant for (``ops.FLASH_PATHS``)
    and agrees with the plain version."""
    dt = getattr(torch, dtype)
    q = _pair(RNG.normal(0, 1, (B, Sq, Hq, D)), dt, cuda)
    k = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    v = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    want_path = paths[0] if dtype == "bfloat16" else paths[1]
    ops.reset_launches()
    got = ops.flash_attention(q[1], k[1], v[1], **kw)
    assert ops.FLASH_PATHS == {p: int(p == want_path)
                               for p in ops.FLASH_PATHS}
    assert bool(torch.isfinite(got).all())
    _close(got, ref.mha_reference(q[0], k[0], v[0], **kw),
           2e-5 if dtype == "float32" else 5e-2)
    if dtype == "bfloat16":
        _within_2x_sdpa(got, q, k, v, kw)


@pytest.mark.parametrize("B,S,H,chunk,lo,dtype", [
    (1, 64, 1, 16, 0.7, "float32"), (2, 128, 2, 32, 0.7, "float32"),
    (1, 256, 4, 64, 0.7, "float32"), (2, 48, 3, 16, 0.7, "float32"),
    (1, 128, 1, 32, 0.3, "float32"), (1, 48, 1, 24, 0.7, "float32"),
    (2, 64, 2, 8, 0.7, "float32"), (1, 48, 1, 48, 0.7, "float32"),
    (1, 128, 3, 64, 0.7, "float32"), (2, 128, 2, 16, 0.7, "bfloat16")])
def test_rwkv6_chunked_kernel(cuda, B, S, H, chunk, lo, dtype):
    """The kernel against its plain version on the same inputs, at 1e-4:
    both compute in f32, from bf16 inputs too (their widening is exact),
    so the bf16 case is held as tightly as f32."""
    dt = getattr(torch, dtype)
    raw = [RNG.normal(0, 0.5, (B, S, H, 64)) for _ in range(3)]
    raw.append(RNG.uniform(lo, 0.999 if lo > 0.5 else 0.6, (B, S, H, 64)))
    raw.append(RNG.normal(0, 0.1, (H, 64)))
    ins = [_pair(a, dt, cuda) for a in raw]
    ins.append(_pair(RNG.normal(0, 0.1, (B, H, 64, 64)), torch.float32,
                     cuda))
    ops.reset_launches()
    y, sf = ops.rwkv6_chunked(*[g for _, g in ins], chunk=chunk)
    assert ops.LAUNCHES["rwkv6_chunked"] == 1
    assert bool(torch.isfinite(y).all())
    y2, sf2 = ref.rwkv6_chunked_reference(*[c for c, _ in ins], chunk=chunk)
    _close(y, y2, 1e-4)
    _close(sf, sf2, 1e-4)


@pytest.mark.parametrize("B,S,H,chunk,lo,s0,fin,tiny", [
    (1, 64, 1, 16, 0.7, 0.0, False, False),
    (2, 128, 2, 32, 0.3, 0.1, True, False),
    (2, 48, 3, 16, 0.7, 0.1, True, False),
    (1, 48, 1, 24, 0.7, 0.0, False, False),
    (2, 64, 2, 8, 0.7, 0.0, True, False),
    # w below 1e-30; a single chunk; B H = 300 blocks, more than two an
    # SM hold resident; chunk 32 with wkv0 and d wkv_final
    (1, 64, 2, 16, 0.7, 0.1, True, True),
    (2, 16, 2, 16, 0.7, 0.1, True, False),
    (3, 32, 100, 16, 0.7, 0.0, False, False),
    (1, 64, 3, 32, 0.7, 0.1, True, False)])
def test_rwkv6_chunked_bwd_kernel(cuda, B, S, H, chunk, lo, s0, fin, tiny):
    """The backward kernel on the forward kernel's chunk-start states
    against the plain backward on the CPU, each gradient within 1e-4 of
    its largest entry, finite; the same bits twice; dw exactly 0 where w
    is below 1e-30 (``tiny``: once a chunk in every fifth channel); and
    the same gradient through autograd of ``ops.rwkv6_chunked`` (one
    forward launch with the states, one backward launch)."""
    raw = [RNG.normal(0, 0.5, (B, S, H, 64)) for _ in range(3)]
    raw.append(RNG.uniform(lo, 0.999 if lo > 0.5 else 0.6, (B, S, H, 64)))
    if tiny:
        raw[3][:, 3::chunk, :, ::5] = 1e-35
    raw.append(RNG.normal(0, 0.1, (H, 64)))
    raw.append(RNG.normal(0, s0, (B, H, 64, 64)))
    ins = [_pair(a, torch.float32, cuda) for a in raw]
    dy = _pair(RNG.normal(0, 1, (B, S, H, 64)), torch.float32, cuda)
    dfin = (_pair(RNG.normal(0, 1, (B, H, 64, 64)), torch.float32, cuda)
            if fin else (None, None))
    y, sf, states = ops.rwkv6_chunked_states(*[g for _, g in ins],
                                             chunk=chunk)
    _, _, want_states = ref.rwkv6_chunked_reference(
        *[c for c, _ in ins], chunk=chunk, states=True)
    _close(states, want_states, 1e-4)
    ops.reset_launches()
    args = [g for _, g in ins[:5]]
    got = ops.rwkv6_chunked_bwd(*args, states, dy[1], dfin[1], chunk=chunk)
    again = ops.rwkv6_chunked_bwd(*args, states, dy[1], dfin[1],
                                  chunk=chunk)
    assert ops.LAUNCHES["rwkv6_chunked_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.rwkv6_chunked_backward_reference(
        *[c for c, _ in ins[:5]], states.cpu(), dy[0], dfin[0], chunk=chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dwkv0"), got,
                          want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.cpu() - w).abs().max()) / scale <= 1e-4, name
    if tiny:
        below = ins[3][0] < 1e-30
        assert bool(below.any()) and bool((got[3].cpu()[below] == 0).all())
    leaves = [g.clone().requires_grad_(True) for _, g in ins]
    ops.reset_launches()
    y2, sf2 = ops.rwkv6_chunked(*leaves, chunk=chunk)
    loss = (y2 * dy[1]).sum() + ((sf2 * dfin[1]).sum() if fin else 0.0)
    auto = torch.autograd.grad(loss, leaves)
    assert ops.LAUNCHES["rwkv6_chunked"] == 1
    assert ops.LAUNCHES["rwkv6_chunked_bwd"] == 1
    assert torch.equal(y2, y)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


@pytest.mark.parametrize("B,S,E,h0,fin", [
    (1, 64, 64, False, False), (2, 77, 200, True, True),
    (1, 1, 64, True, True), (3, 300, 130, True, False),
    # more blocks than two an SM hold resident
    (2, 48, 64 * 300, False, True),
    # the tiles' edges: S under one 16-token sub-tile with d_in 4 past a
    # multiple of the blocks' 64 channels, B 3 with S not a multiple of the
    # sub-tile, a ragged last 64-token forward tile
    (1, 5, 4100, True, True), (3, 40, 96, False, True),
    (2, 130, 252, True, False)])
def test_mamba_scan_kernel(cuda, B, S, E, h0, fin):
    """The scan's forward kernel (with and without its checkpoint states)
    and its backward kernel on those states against the plain versions on
    the CPU: y, the final state, the checkpoints and every gradient within
    1e-4 of its largest entry, finite; the same bits twice; autograd
    through ``ops.mamba_scan`` one forward and one backward launch, the
    same outputs and gradients."""
    x, Bm, Cm = (RNG.normal(0, 1, (B, S, n)) for n in (E, 16, 16))
    dt = np.log1p(np.exp(RNG.normal(-1, 1, (B, S))))
    A = -np.exp(np.log(np.arange(1, 17))[None] + RNG.normal(0, 0.2, (E, 16)))
    h = RNG.normal(0, 1, (B, E, 16)) * h0
    ins = [_pair(a, torch.float32, cuda) for a in (x, dt, A, Bm, Cm, h)]
    dy = _pair(RNG.normal(0, 1, (B, S, E)), torch.float32, cuda)
    dfin = (_pair(RNG.normal(0, 1, (B, E, 16)), torch.float32, cuda)
            if fin else (None, None))
    cpu_ins, card = [c for c, _ in ins], [g for _, g in ins]
    ops.reset_launches()
    y, hT, st = ops.mamba_scan_states(*card)
    y2, hT2 = ops.mamba_scan(*card)
    got = ops.mamba_scan_bwd(*card[:5], st, dy[1], dfin[1])
    again = ops.mamba_scan_bwd(*card[:5], st, dy[1], dfin[1])
    assert (ops.LAUNCHES["mamba_scan"], ops.LAUNCHES["mamba_scan_bwd"]) == \
        (2, 2)
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    wy, whT, wst = ref.mamba_scan_reference(*cpu_ins, states=True)
    want = ref.mamba_scan_backward_reference(*cpu_ins, dy[0], dfin[0])
    for name, g, w in zip(("y", "hT", "states", "dx", "ddt", "dA", "dB",
                           "dC", "dh0"), (y, hT, st, *got),
                          (wy, whT, wst, *want)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.cpu() - w).abs().max()) / scale <= 1e-4, name
    leaves = [g.clone().requires_grad_(True) for g in card]
    ops.reset_launches()
    ya, ha = ops.mamba_scan(*leaves)
    loss = (ya * dy[1]).sum() + ((ha * dfin[1]).sum() if fin else 0.0)
    auto = torch.autograd.grad(loss, leaves)
    assert (ops.LAUNCHES["mamba_scan"], ops.LAUNCHES["mamba_scan_bwd"]) == \
        (1, 1)
    assert torch.equal(ya, y)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


def test_mamba_scan_kernel_refuses_unaligned_inputs(cuda):
    """A, B, C and h0 (or the states) that start 4 bytes past a 16-byte
    boundary (contiguous views into a larger buffer) raise on the card,
    forward and backward: the kernels copy them by 16 bytes."""
    B, S, E = 1, 8, 64
    shapes = ((B, S, E), (B, S), (E, 16), (B, S, 16), (B, S, 16),
              (B, E, 16))
    ins = [torch.zeros(s, device=cuda) for s in shapes]
    states = ops.mamba_scan_states(*ins)[2]
    dy = torch.zeros(B, S, E, device=cuda)

    def off(t):
        v = torch.zeros(t.numel() + 1, device=cuda)[1:].view(t.shape)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        return v
    for i in (2, 3, 4, 5):
        bad = ins[:i] + [off(ins[i])] + ins[i + 1:]
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.mamba_scan(*bad)
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.mamba_scan_bwd(*bad[:5], off(states) if i == 5 else states,
                               dy)


def test_mamba_scan_kernel_refuses_what_it_does_not_take(cuda):
    """bf16 inputs and a d_state other than 16 raise on the card (the
    plain version on the CPU takes both)."""
    B, S, E = 1, 8, 64
    ins = [torch.zeros(s, device=cuda) for s in
           ((B, S, E), (B, S), (E, 16), (B, S, 16), (B, S, 16), (B, E, 16))]
    with pytest.raises(ValueError, match="must be torch.float32"):
        ops.mamba_scan(ins[0].bfloat16(), *ins[1:])
    eight = [torch.zeros(s, device=cuda) for s in
             ((B, S, E), (B, S), (E, 8), (B, S, 8), (B, S, 8), (B, E, 8))]
    with pytest.raises(ValueError, match="d_state must be 16"):
        ops.mamba_scan(*eight)
    ops.mamba_scan(*[t.cpu() for t in eight])


def test_hybrid_loss_and_grads_on_card_equal_cpu(cuda):
    """The reduced Jamba in f32: the loss and every gradient of
    ``make_loss_fn`` (remat) on the card within 1e-4 of the CPU's, each
    relative to its tensor's largest entry; the Mamba scan launched twice
    a Mamba layer (the forward and remat's recomputation) and its
    backward once."""
    from repro_torch.train import step as STEP
    cfg = dataclasses.replace(C.get_reduced("jamba_1_5_large"),
                              dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (4, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = STEP.make_loss_fn(cfg)
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        model.requires_grad_(True)
        ops.reset_launches()
        loss, _ = loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
        named = dict(model.named_parameters())
        out.append((float(loss.detach()), dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))))
    n_mamba = sum(b.kind.startswith("mamba") for b in cpu.blocks)
    assert (ops.LAUNCHES["mamba_scan"], ops.LAUNCHES["mamba_scan_bwd"]) == \
        (2 * n_mamba, n_mamba)
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) <= 1e-4
    for n, w in gc.items():
        err = float((gg[n].cpu() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        assert err <= 1e-4, (n, err)


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "qwen2_5_32b",
                                  "granite_34b", "rwkv6_7b",
                                  "deepseek_moe_16b", "mixtral_8x7b",
                                  "llava_next_34b", "jamba_1_5_large",
                                  "whisper_small"])
def test_reduced_model_on_card_equals_cpu(cuda, arch):
    cfg = dataclasses.replace(C.get_reduced(arch), dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 40)))
    pe = {}
    fr = {}
    if cfg.family == "vlm":
        pe["prefix_embed"] = torch.as_tensor(np.random.default_rng(5).normal(
            0, 1, (2, cfg.n_patches, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "encdec":
        fr["enc_frames"] = torch.as_tensor(np.random.default_rng(6).normal(
            0, 1, (2, 64, cfg.d_model)), dtype=torch.float32)
        pe.update(fr)
    ops.reset_launches()
    _close(gpu(toks[:, :32].to(cuda),
               **{k: v.to(cuda) for k, v in pe.items()}),
           cpu(toks[:, :32], **pe), 1e-4)
    cg, cc = gpu.init_cache(2, 16), cpu.init_cache(2, 16)
    fr_gpu = {k: v.to(cuda) for k, v in fr.items()}
    for i in range(8):
        tok = toks[:, 32 + i:33 + i]
        _close(gpu.decode_step(tok.to(cuda), cg, **fr_gpu)[0],
               cpu.decode_step(tok, cc, **fr)[0], 1e-4)
    kernel = "rwkv6_chunked" if cfg.family == "rwkv" else "flash_attention"
    assert ops.LAUNCHES[kernel] > 0


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("t,E,k", [(4, 64, 6), (4096, 64, 6), (37, 8, 2),
                                   (4608, 8, 2)])
def test_moe_dispatch_on_card_equals_cpu(cuda, kind, t, E, k):
    """The sort dispatch's buffers, ``dst``, ``keep``, gates, counts and
    top-k experts on the card equal the CPU's for the same probabilities
    (stable sorts, lowest-index-first ties, the sentinel row never
    read)."""
    rng = np.random.default_rng(t + E + k)
    logits = (rng.normal(0, 1, (t, E)) if kind == "random"
              else rng.integers(0, 2, (t, E)).astype(np.float64))
    probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32), -1)
    xt = torch.as_tensor(rng.normal(0, 1, (t, 32)), dtype=torch.bfloat16)
    cap = MOE.capacity(1.25, k, t, E)
    want = MOE.local_dispatch(xt, probs, k, cap, E)
    got = MOE.local_dispatch(xt.to(cuda), probs.to(cuda), k, cap, E)
    names = ("buf", "dst", "keep", "gate", "counts", "topi")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.device.type == "cuda", name
        assert torch.equal(g.cpu(), w), name


def _grad_close(got, want, tol):
    """Each gradient within ``tol`` of the plain backward's, relative to
    that tensor's largest entry."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = max(float(w.float().abs().max()), 1e-30)
        err = float((g.cpu().float() - w.float()).abs().max()) / scale
        assert err <= tol, (name, err)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (1, 128, 128, 4, 4, 64, True, 0), (2, 100, 100, 8, 2, 128, True, 0),
    (2, 77, 333, 4, 1, 32, False, 0), (1, 256, 256, 4, 2, 64, True, 64),
    (2, 65, 65, 14, 2, 128, True, 0), (1, 40, 90, 6, 3, 64, True, 0),
    (2, 150, 150, 12, 12, 64, False, 0), (1, 33, 33, 2, 2, 32, False, 7),
    (1, 20, 20, 4, 2, 64, True, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel(cuda, B, Sq, Sk, Hq, Hkv, D, causal,
                                    window, dtype):
    """The backward kernel (two launches) against the plain backward on
    the same inputs and the forward's own LSE: 1e-4 in f32, 5e-2 in bf16
    (the outputs round to bf16), relative to each tensor's max; both
    launches on the wgmma path for bf16 with D 64 or 128 and at least 64
    rows (Sq * G), else on the simt path; its gradient through
    ``ops.flash_attention`` under autograd is the same launches, and
    twice the same bits."""
    dt = getattr(torch, dtype)
    q = _pair(RNG.normal(0, 1, (B, Sq, Hq, D)), dt, cuda)
    k = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    v = _pair(RNG.normal(0, 1, (B, Sk, Hkv, D)), dt, cuda)
    do = _pair(RNG.normal(0, 1, (B, Sq, Hq, D)), dt, cuda)
    kw = dict(causal=causal, sliding_window=window)
    ops.reset_launches()
    o, lse = ops.flash_attention_lse(q[1], k[1], v[1], **kw)
    assert ops.FLASH_PATHS["split"] == 0
    assert torch.equal(o, ops.flash_attention(q[1], k[1], v[1], **kw))
    _close(lse, ref.mha_lse(q[0], k[0], **kw), 1e-4)
    got = ops.flash_attention_bwd(q[1], k[1], v[1], o, lse, do[1], **kw)
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    path = ("wgmma" if dtype == "bfloat16" and D in (64, 128)
            and Sq * (Hq // Hkv) >= 64 else "simt")
    assert ops.FLASH_BWD_PATHS == {"wgmma": 0, "simt": 0, path: 2}
    want = ref.mha_backward_reference(q[0], k[0], v[0], o.cpu(), lse.cpu(),
                                      do[0], **kw)
    tol = 1e-4 if dtype == "float32" else 5e-2
    _grad_close(got, want, tol)
    # the same through autograd, twice: the same bits (no atomics)
    tq, tk, tv = (t[1].clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    g1 = torch.autograd.grad(out, (tq, tk, tv), do[1])
    out = ops.flash_attention(tq, tk, tv, **kw)
    g2 = torch.autograd.grad(out, (tq, tk, tv), do[1])
    _grad_close(g1, want, tol)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(tq, tk, tv, q_offset=1)


@pytest.mark.parametrize("arch,microbatch", [
    ("minicpm_2b", 0), ("minicpm_2b", 2), ("phi3_medium_14b", 0),
    ("llava_next_34b", 0), ("deepseek_moe_16b", 0), ("whisper_small", 2),
    ("rwkv6_7b", 0)])
def test_train_step_on_card_equals_cpu(cuda, arch, microbatch):
    """Reduced config in f32 from the same weights: three train steps on
    the card (attention's forward with its LSE and the backward kernel)
    and on the CPU (autograd through the plain versions), each from the
    CPU's state copied to the card.  Before each step the gradient the
    step takes (microbatch mean included) on the card equals the CPU's
    within 1e-4 of each tensor's largest entry, every element: that
    holds the kernels.  After it, losses within 1e-4, the parameters and
    ``m`` / ``v`` within 1e-4 of each tensor's largest entry, but for
    the elements where AdamW's ``g / (|g| + eps)`` amplifies a gradient
    gap: a nonzero gradient within 1e-5 of its tensor's largest (Adam's
    ``sign(g)`` may differ there), or one at most 100 x AdamW's ``eps``
    that is past that tolerance (there a 1e-10 gap moves the step): at
    most 1 in 1,000 a step (for the MoE, enc-dec and RWKV families, at
    most 1 in 1,000 that moved apart), each within 2 x the summed lr (as
    ``chip_smoke.py`` phase 6b)."""
    from repro_torch.train import optim, step as STEP
    cfg = dataclasses.replace(C.get_reduced(arch), dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    fn = STEP.make_train_step(cfg, warmup=1, total=3, microbatch=microbatch)
    oc = optim.adamw_init(dict(cpu.named_parameters()))
    loss_fn = STEP.make_loss_fn(cfg)
    cpu.requires_grad_(True)
    total = sum(p.numel() for p in cpu.parameters())
    lr_sum = 0.0

    def rel(got, want, skip=None):
        gap = (got.detach().cpu() - want.detach()).abs()
        if skip is not None:
            gap = gap.masked_fill(skip, 0)
        return float(gap.max()) / max(float(want.detach().abs().max()),
                                      1e-30)

    def step_grads(model, b):
        """The gradient the step takes: with microbatches the mean of
        its row shards' (a shard's loss is normalized by its own count)."""
        named = dict(model.named_parameters())
        n_mb = max(microbatch, 1)
        total = [0.0] * len(named)
        for i in range(n_mb):
            loss, _ = loss_fn(model, {k: v.reshape(n_mb, -1, *v.shape[1:])[i]
                                      for k, v in b.items()})
            total = [a + g for a, g in zip(total, torch.autograd.grad(
                loss, list(named.values())))]
        return {n: g * optim.recip(n_mb) for n, g in zip(named, total)}
    # AdamW's eps (optim.adamw_update's default, as the step uses it)
    eps = inspect.signature(optim.adamw_update).parameters["eps"].default
    ops.reset_launches()
    for _ in range(3):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 33)))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            b["prefix_embed"] = torch.as_tensor(rng.normal(
                0, 0.02, (4, cfg.n_patches, cfg.d_model)),
                dtype=torch.float32)
        if cfg.family == "encdec":
            b["enc_frames"] = torch.as_tensor(rng.normal(
                0, 1, (4, 24, cfg.d_model)), dtype=torch.float32)
        step_g = step_grads(cpu, b)
        near = {n: (g.abs() <= 1e-5 * g.abs().max()) & (g != 0)
                for n, g in step_g.items()}
        in_eps = {n: (g.abs() <= 100 * eps) & (g != 0)
                  for n, g in step_g.items()}
        # each step from the CPU's state: a flipped sign moves a weight by
        # ~lr, which would reach every later gradient and moment
        gpu = copy.deepcopy(cpu).to(cuda)
        gpu_g = step_grads(gpu, {k: v.to(cuda) for k, v in b.items()})
        for name, g in step_g.items():
            assert rel(gpu_g[name], g) <= 1e-4, ("grad", name)
        og = optim.AdamWState(m={k: t.to(cuda) for k, t in oc.m.items()},
                              v={k: t.to(cuda) for k, t in oc.v.items()},
                              step=oc.step.to(cuda))
        cpu, oc, mc = fn(cpu, oc, b)
        gpu, og, mg = fn(gpu, og, {k: v.to(cuda) for k, v in b.items()})
        lr_sum += float(mc["lr"])
        assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4
        own = dict(gpu.named_parameters())
        moved = n_masked = 0
        for name, p in cpu.named_parameters():
            pairs = (("p", own[name], p), ("m", og.m[name], oc.m[name]),
                     ("v", og.v[name], oc.v[name]))
            # AdamW's eps regime joins the mask where it is past the
            # tolerance, so the bound below counts only those
            past = torch.zeros_like(p, dtype=torch.bool)
            for _, g, w in pairs:
                past |= (g.detach().cpu() - w.detach()).abs() > \
                    1e-4 * w.detach().abs().max()
            mask = near[name] | (in_eps[name] & past)
            n_masked += int(mask.sum())
            gap = (own[name].detach().cpu() - p.detach()).abs()
            assert float(gap.max()) <= 2 * lr_sum + 1e-4, name
            moved += int((gap[mask] > 1e-4 * float(mc["lr"])).sum())
            for what, g, w in pairs:
                assert g.dtype == w.dtype and g.shape == w.shape, \
                    (what, name)
                assert rel(g, w, mask) <= 1e-4, (what, name)
        if cfg.family in ("dense", "vlm"):
            assert n_masked <= total / 1000
        # the other families hold about one near-zero gradient in 1,000
        # at these widths: for them the 1 in 1,000 bounds those that moved
        # apart (tests/test_torch_train_families.moved_apart)
        assert moved <= total / 1000
    assert ops.LAUNCHES["rwkv6_chunked_bwd" if cfg.family == "rwkv"
                        else "flash_attention_bwd"] > 0


# ------------------------------------------- head alignment, EP over NCCL

def test_tp_align_padded_model_on_card(cuda):
    """Reduced Phi-3 padded for tp 16 equals the exact model from the same
    seed on the card: the forward and 6 decode steps through the padded
    cache, within 1e-4 (f32)."""
    from repro_torch.models import tp_align
    cfg = dataclasses.replace(C.get_reduced("phi3_medium_14b"),
                              dtype=torch.float32)
    pad = tp_align.aligned(cfg, 16)
    assert pad.head_maps is not None and pad.n_kv % 16 == 0
    exact, padded = (LM(c, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
                     for c in (cfg, pad))
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 12)), device=cuda)
    with torch.no_grad():
        assert float((padded(toks) - exact(toks)).abs().max()) <= 1e-4
        ce, cp = exact.init_cache(2, 6), padded.init_cache(2, 6)
        for i in range(6):
            a, ce = exact.decode_step(toks[:, i:i + 1], ce)
            b, cp = padded.decode_step(toks[:, i:i + 1], cp)
            assert float((a - b).abs().max()) <= 1e-4


_EP_RANK = r"""
import dataclasses, json, os, sys
import torch
import torch.distributed as dist
from repro_torch import configs as C
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as M
from repro_torch.models.lm import LM

d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl", init_method="file://" + os.path.join(
    d, "rdv"), world_size=world, rank=rank,
    device_id=torch.device("cuda", rank))
mesh = make_mesh((1, world), ("data", "model"), backend="nccl")
dev = mesh.device
out = {}
with torch.no_grad():
    base = dataclasses.replace(C.get_reduced("mixtral_8x7b"),
                               dtype=torch.float32)
    for E in (2 * world, 3 * world // 2):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, n_experts=E, capacity_factor=float(E)))
        g = [torch.Generator(device=dev).manual_seed(s) for s in (0, 0, 1)]
        part = M.MoE(cfg, device=dev, generator=g[0], mesh=mesh)
        one = M.MoE(cfg, device=dev, generator=g[1])
        for S in (16, 1):               # an EP path, then the decode path
            x = torch.randn((4, S, cfg.d_model), generator=g[2], device=dev)
            out[f"{part.split} S{S}"] = float(
                (part(x)[0] - one(x)[0]).abs().max())
        models = [LM(cfg, mesh=mesh, generator=torch.Generator(
            device=dev).manual_seed(2)), LM(cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))]
        toks = torch.randint(0, cfg.vocab, (2, 8), generator=g[2],
                             device=dev)
        out[f"{part.split} lm"] = float(
            (models[0](toks) - models[1](toks)).abs().max())
json.dump(out, open(os.path.join(d, f"rank{rank}.json"), "w"))
dist.barrier()
dist.destroy_process_group()
"""


def test_moe_ep_over_nccl_equals_one_card(cuda, tmp_path):
    """The MoE layer and a reduced Mixtral on a (1, W) mesh over NCCL (W
    = 4 with four cards, else 2), each path (whole experts, f slices; the
    EP prefill and the decode path), equal the same seed's one-card
    module on each rank within 1e-5 (f32, dropless)."""
    import json
    import os
    import subprocess
    import sys
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    world = 4 if n >= 4 else 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _EP_RANK, str(tmp_path),
                               str(r), str(world)], cwd=root, env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    for r in range(world):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(got) == 6
        for k, e in got.items():
            assert e <= 1e-5, (r, k, e)
