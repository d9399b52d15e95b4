"""The port's kernel wrappers and plain versions vs the JAX reference.

On the CPU each ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain version (``repro_torch.kernels.ref``); both are held here against
``repro.kernels.ref`` and against the Pallas kernel itself in interpret
mode: the tick kernels bit for bit, attention and RWKV-6 within the
tolerances of ``tests/test_kernels.py``.  The reference oracles run under ``jax.jit``, as the
engine runs them: eagerly XLA divides by ``kmax - kmin``, jitted it
multiplies by the f32 reciprocal, and the port follows the engine.  The
CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402

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


@pytest.mark.parametrize("dtype", ["bool", "uint8"])
@pytest.mark.parametrize("K,N,F", [(6, 700, 40), (2, 5000, 1056)])
def test_flow_agg_byte_rows(dtype, K, N, F):
    # the engine's stacked indicators go in as bool rows, uncast; the
    # Pallas kernel takes any integer-valued rows the same way
    rows = RNG.random((K, N)) < 0.3
    if dtype == "uint8":
        rows = rows * RNG.integers(1, 256, (K, N))
    rows = rows.astype(dtype)
    pflow = RNG.integers(-1, F + 2, N).astype(np.int32)
    got = ops.flow_agg(_t(rows), _t(pflow), n_flows=F)
    _eq(got, JOPS.flow_agg(jnp.asarray(rows), jnp.asarray(pflow), n_flows=F,
                           block_n=256, interpret=True))
    _eq(got, ops.flow_agg(_t(rows.astype(np.int32)), _t(pflow), n_flows=F))


@pytest.mark.parametrize("K,N", [(3, 0), (0, 40)])
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_flow_agg_empty(K, N, dtype):
    # no slots: every flow sums to 0; no rows: an empty [0, F] result
    rows = np.ones((K, N), dtype)
    pflow = np.zeros(N, np.int32)
    got = ops.flow_agg(_t(rows), _t(pflow), n_flows=5)
    assert got.shape == (K, 5) and not got.any()
    _eq(got, JREF.flow_agg_reference(jnp.asarray(rows), jnp.asarray(pflow),
                                     n_flows=5))


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


@pytest.mark.parametrize("M,P", [(5024, 3960), (37, 3960), (1, 1),
                                 (65536, 64), (2000, 58111), (4095, 300)])
def test_tick_rank_plan_fits(M, P):
    path, segs, smem = ops.tick_rank_plan(M, P)
    assert path == "smem"
    assert 1 <= segs <= ops.TICK_RANK_SEGS
    # one row of counts a segment, padded to 16 bytes, inside the opt-in
    stride = -(-(P + 1) // 4) * 4
    assert smem == segs * stride * 4 <= ops.SMEM_OPTIN
    # the kernel's segments (32-entry steps) cover [0, M), none empty
    seg_len = -(-(-(-M // segs)) // 32) * 32
    assert (segs - 1) * seg_len < M <= segs * seg_len


def test_tick_rank_plan_paths():
    # DF-1056's compacted enqueues take the shared-memory path
    assert ops.tick_rank_plan(5024, 3960) == ("smem", 11, 11 * 3964 * 4)
    # a row of counts that does not fit even alone: the pairwise body
    assert ops.tick_rank_plan(2000, 70000) == ("pairwise", 0, 0)
    assert ops.tick_rank_plan(2000, 58112)[0] == "pairwise"
    # nothing to rank: nothing to launch
    assert ops.tick_rank_plan(0, 3960) == ("none", 0, 0)
    with pytest.raises(ValueError):
        ops.tick_rank_plan(-1, 8)
    with pytest.raises(ValueError):
        ops.tick_rank_plan(8, 0)


def test_tick_rank_empty():
    ops.reset_launches()
    got = ops.tick_rank(torch.zeros(0, dtype=torch.int32), n_ports=8)
    assert got.shape == (0,) and got.dtype == torch.int32
    assert ops.LAUNCHES["tick_rank"] == 0
    assert ops.TICK_RANK_PATHS == dict.fromkeys(ops.TICK_RANK_PATHS, 0)


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


# ---------------------------------------- tick_rank + red_ecn, one launch --
def _jax_rank_red(port, enq, unif, tails, t, **kw):
    """The reference's two Pallas kernels in turn (interpret mode), as
    the reference engine's phase E calls them; (trim, mark, slot)."""
    jport = jnp.asarray(port)
    rank = JOPS.tick_rank(jport, n_ports=kw["n_ports"], block_m=256,
                          interpret=True)
    return JOPS.red_ecn(jport, rank, jnp.asarray(enq), jnp.asarray(unif),
                        jnp.asarray(tails), t, block_n=128, interpret=True,
                        **kw)[1:]


@pytest.mark.parametrize("M,P", [(512, 32), (5024, 3960), (17, 4)])
@pytest.mark.parametrize("t", [0, 70000])
def test_tick_rank_red_ecn(M, P, t):
    # sentinel (P), out-of-range (P + 1) and negative (-1) ports, with
    # enq set on some of them too
    port = RNG.integers(-1, P + 2, M).astype(np.int32)
    port[:M // 8] = RNG.integers(0, 3, M // 8)     # long same-port runs
    enq = RNG.random(M) < 0.7
    unif = RNG.random(M).astype(np.float32)
    tails = (t + RNG.integers(-100, 200, P)).astype(np.int32)
    kw = dict(qsize=88, kmin=17.6, kmax=70.4, n_ports=P)
    got = ops.tick_rank_red_ecn(_t(port), _t(enq), _t(unif), _t(tails), t,
                                **kw)
    _eq(got, _jax_rank_red(port, enq, unif, tails, t, **kw))
    rank = ops.tick_rank(_t(port), n_ports=P)
    _eq(got, ops.red_ecn(_t(port), rank, _t(enq), _t(unif), _t(tails), t,
                         **kw)[1:])


@pytest.mark.parametrize("form", ["one_port", "distinct_ports"])
def test_tick_rank_red_ecn_every_occupancy_marks_like_the_reference(form):
    # every occupancy up to qsize + 331, from the rank (all on one port
    # whose tail is t) or from the tails (each entry on its own port),
    # with the uniform draw at the reference's probability and one f32
    # step below it
    qsize, kmin, kmax, t = 102, 20.4, 81.6, 500
    n = qsize + 332
    occ = np.arange(n, dtype=np.int32)
    pr = np.asarray(jax.jit(lambda o: jnp.clip(
        (o.astype(jnp.float32) - kmin) / max(kmax - kmin, 1e-9), 0.0,
        1.0))(occ))
    if form == "one_port":
        port, tails = np.zeros(n, np.int32), np.array([t], np.int32)
    else:
        port, tails = occ.copy(), (t + occ).astype(np.int32)
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=len(tails))
    enq = np.ones(n, bool)
    marks = []
    for unif in (pr, np.nextafter(pr, np.float32(0))):
        unif = unif.astype(np.float32)
        got = ops.tick_rank_red_ecn(_t(port), _t(enq), _t(unif), _t(tails),
                                    t, **kw)
        jport = jnp.asarray(port)
        want = RED_REF(jport, JREF.tick_rank_reference(jport,
                                                       n_ports=len(tails)),
                       jnp.asarray(enq), jnp.asarray(unif),
                       jnp.asarray(tails), t, **kw)
        _eq(got, want[1:])
        marks.append(int(got[1].sum()))
    # at the probability nothing marks; one step below, every accepted
    # occupancy above kmin does
    assert marks == [0, qsize - 21]


def test_tick_rank_red_ecn_empty():
    ops.reset_launches()
    z = torch.zeros(0, dtype=torch.int32)
    got = ops.tick_rank_red_ecn(z, z.bool(), z.float(),
                                torch.zeros(8, dtype=torch.int32), 0,
                                qsize=8, kmin=1.0, kmax=4.0, n_ports=8)
    assert [(g.shape, g.dtype) for g in got] == [
        ((0,), torch.bool), ((0,), torch.bool), ((0,), torch.int32)]
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


# -------------------------------------------------------- spritz_select --
@pytest.mark.parametrize("F,P", [(16, 8), (100, 37), (256, 64), (1000, 64),
                                 (33, 1), (64, 16), (50, 17), (40, 256)])
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


@pytest.mark.parametrize("P", [16, 17, 33, 256])
@pytest.mark.parametrize("u_edge", ["zero", "below_one"])
def test_spritz_select_edge_u(P, u_edge):
    # u = 0 samples the first entry whose prefix is above 0; u just below
    # 1 sits on the row total, where one rounding step of the prefix sum
    # moves the sample
    F = 48
    w = np.exp(RNG.normal(0, 6, (F, P))).astype(np.float32)
    w[:, RNG.random(P) < 0.2] = 0.0
    w[:2] = 0.0
    u = np.full(F, 0.0 if u_edge == "zero" else
                np.nextafter(np.float32(1), np.float32(0)), np.float32)
    front = RNG.integers(-1, P, F).astype(np.int32)
    cnt = np.full(F, 44, np.int32)                  # every row samples
    got = ops.spritz_select(_t(w), _t(u), _t(front), _t(cnt),
                            explore_threshold=44)
    args = [jnp.asarray(a) for a in (w, u, front, cnt)]
    _eq(got, JREF.spritz_select_reference(*args, explore_threshold=44))
    _eq(got, JOPS.spritz_select(*args, explore_threshold=44, block_f=16,
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
    for dt in (torch.float32, torch.int64, torch.int16):   # not int32/1-byte
        with pytest.raises(ValueError):
            ops.flow_agg(torch.zeros((2, 8), dtype=dt),
                         torch.zeros(8, dtype=i32), n_flows=4)
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
    kw = dict(qsize=8, kmin=1.0, kmax=4.0, n_ports=3)
    q3 = torch.zeros(3, dtype=i32)
    for bad in ((z[:7], z.bool(), z.float(), q3),       # ragged
                (z.float(), z.bool(), z.float(), q3),   # port not int32
                (z, z, z.float(), q3),                  # enq not bool
                (z, z.bool(), z.double(), q3),          # unif not f32
                (z, z.bool(), z.float(), q3[:2]),       # q_tail length
                (z, z.bool(), z.float(), q3.long()),    # q_tail not int32
                (z[None], z[None].bool(), z[None].float(), q3)):  # 2-D
        with pytest.raises(ValueError):
            ops.tick_rank_red_ecn(*bad, 0, **kw)
    with pytest.raises(ValueError):
        ops.tick_rank_red_ecn(z, z.bool(), z.float(), q3[:0], 0,
                              **dict(kw, n_ports=0))
    with pytest.raises(ValueError):
        ops.spritz_select(torch.zeros((8, 4)), torch.zeros(7), z, z,
                          explore_threshold=4)
    with pytest.raises(ValueError):
        ops.spritz_select(torch.zeros((8, 300)), torch.zeros(8), z, z,
                          explore_threshold=4)


def test_build_reports_ptxas_when_reused(tmp_path, monkeypatch):
    # a stand-in for nvcc writes each library and a ptxas line; a second
    # build() reuses the libraries and must still report ptxas, which
    # chip_smoke.py reads on every run from a checkout
    from repro_torch.kernels import _build

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out, self.returncode = Path(cmd[cmd.index("-o") + 1]), 0

        def communicate(self):
            self.out.write_text("library")
            return "ptxas info    : Used 27 registers\n", None

    def never(*a, **kw):
        raise AssertionError("a reused build ran nvcc")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    libs = _build.build()
    assert all(p.exists() for p in libs.values())
    first = dict(_build.BUILD_INFO["ptxas"])
    assert sorted(first) == sorted(_build.SIGNATURES)
    assert all("Used 27 registers" in log for log in first.values())
    monkeypatch.setattr(_build.subprocess, "Popen", never)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    assert _build.build() == libs
    assert _build.BUILD_INFO["ptxas"] == first


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    # the build directory's hash covers every file under csrc/, so an
    # edit to a header that two sources include rebuilds both
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert (csrc / "red_ecn.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest()
    assert _build._digest() == before
    with open(csrc / "red_ecn.cuh", "a") as f:
        f.write("// edited\n")
    edited = _build._digest()
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest() not in (before, edited)


def test_cpu_tensors_never_launch():
    ops.reset_launches()
    rows = torch.ones((2, 16), dtype=torch.int32)
    ops.flow_agg(rows, torch.zeros(16, dtype=torch.int32), n_flows=3)
    ops.flow_agg(rows.bool(), torch.zeros(16, dtype=torch.int32), n_flows=3)
    ops.tick_rank(torch.zeros(16, dtype=torch.int32), n_ports=3)
    z = torch.zeros(16, dtype=torch.int32)
    ops.red_ecn(z, z, z.bool(), z.float(), z[:3], 0, qsize=8, kmin=1.0,
                kmax=4.0, n_ports=3)
    ops.tick_rank_red_ecn(z, z.bool(), z.float(), z[:3], 0, qsize=8,
                          kmin=1.0, kmax=4.0, n_ports=3)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    assert ops.TICK_RANK_PATHS == dict.fromkeys(ops.TICK_RANK_PATHS, 0)


# ------------------------------------------------------ flash_attention --
def _rand(shape, scale=1.0):
    return RNG.normal(0, scale, shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),      # MHA
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (1, 128, 128, 4, 1, 128),     # MQA, d_head 128
    (2, 128, 384, 4, 2, 64),      # cross-length (decode-ish block)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_shapes(B, Sq, Sk, Hq, Hkv, D, causal):
    q, k, v = _rand((B, Sq, Hq, D)), _rand((B, Sk, Hkv, D)), \
        _rand((B, Sk, Hkv, D))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, JREF.mha_reference(jq, jk, jv, causal=causal), 2e-5)
    _close(got, JOPS.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                     block_k=64, interpret=True), 2e-5)


def test_flash_attention_bf16():
    q, k, v = _rand((1, 128, 4, 64)), _rand((1, 128, 2, 64)), \
        _rand((1, 128, 2, 64))
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32))
                  .to(torch.bfloat16) for a in bf)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, JOPS.flash_attention(*bf, causal=True, interpret=True), 5e-2)
    _close(got, JREF.mha_reference(*(a.astype(jnp.float32) for a in bf),
                                   causal=True), 5e-2)


@pytest.mark.parametrize("window,Sq,Sk,q_offset", [
    (64, 256, 256, 0),            # sliding window, prefill
    (0, 128, 384, 256),           # decode block at an offset
    (0, 1, 100, 57),              # one query, ragged Sk (decode step)
    (16, 1, 100, 57),             # decode step under a window
])
def test_flash_attention_masks(window, Sq, Sk, q_offset):
    q, k, v = _rand((2, Sq, 4, 64)), _rand((2, Sk, 2, 64)), \
        _rand((2, Sk, 2, 64))
    kw = dict(causal=True, sliding_window=window, q_offset=q_offset)
    got = ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, JREF.mha_reference(jq, jk, jv, **kw), 2e-5)
    _close(got, JOPS.flash_attention(jq, jk, jv, block_q=min(64, Sq),
                                     block_k=Sk, interpret=True, **kw), 2e-5)


H100_SMS = 132            # streaming multiprocessors of an H100 SXM


def _split_bounds(split_len, n_split, kend):
    return [(i * split_len, min(kend, (i + 1) * split_len))
            for i in range(n_split)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window,q_offset,bounds", [
    (2, 1, 100, 8, 2, 64, 0, 57, [(0, 100)]),                  # one split
    (2, 1, 256, 8, 2, 64, 0, 200,
     [(0, 64), (64, 128), (128, 192), (192, 256)]),            # many splits
    (2, 3, 200, 8, 2, 32, 0, 150, [(0, 64), (64, 128), (128, 153)]),  # ragged
    (1, 1, 100, 4, 1, 64, 0, 99, [(0, 64), (64, 100), (100, 164)]),   # padding
    (2, 1, 128, 8, 2, 64, 0, 40, [(0, 64), (64, 128)]),        # causal-masked
    (2, 1, 128, 8, 2, 64, 16, 120, [(0, 64), (64, 128)]),      # window-masked
    (2, 2, 100, 8, 2, 64, 16, 300, [(0, 64), (64, 100)]),      # no unmasked key
    (2, 1, 701, 8, 2, 32, 0, 700, "plan"),                     # Sq = 1, G = 4
], ids=["one", "many", "ragged", "padding", "causal_masked",
        "window_masked", "all_masked", "decode_plan"])
def test_flash_split_partials(B, Sq, Sk, Hq, Hkv, D, window, q_offset,
                              bounds):
    """The split path's two passes, combined, equal the reference and the
    Pallas kernel (f32, 2e-5) whatever the splits hold."""
    q, k, v = _rand((B, Sq, Hq, D)), _rand((B, Sk, Hkv, D)), \
        _rand((B, Sk, Hkv, D))
    kw = dict(causal=True, sliding_window=window, q_offset=q_offset)
    if bounds == "plan":
        path, split_len, n_split = ops.flash_plan(
            B, Sq, Sk, Hq, Hkv, D, torch.float32, q_offset=q_offset,
            num_sms=H100_SMS)
        assert path == "split" and n_split > 1
        bounds = _split_bounds(split_len, n_split, min(Sk, q_offset + Sq))
    m, l, acc = TREF.mha_partials(_t(q), _t(k), _t(v), bounds, **kw)
    assert m.shape == l.shape == (len(bounds), B, Sq, Hq)
    assert bool(torch.isfinite(acc).all()) and bool((m >= -1e30).all())
    got = TREF.combine_partials(m, l, acc)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, JREF.mha_reference(jq, jk, jv, **kw), 2e-5)
    _close(got, JOPS.flash_attention(jq, jk, jv, block_q=Sq, block_k=Sk,
                                     interpret=True, **kw), 2e-5)
    for i, (lo, hi) in enumerate(bounds):
        if lo >= Sk:                         # padding alone: l = 0
            assert float(l[i].abs().max()) == 0.0
            assert float(m[i].max()) == float(np.float32(-1e30))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,dtype,q_offset,want", [
    (4, 1024, 1024, 40, 10, 128, "bfloat16", 0, "wgmma"),   # Phi-3 prefill
    (4, 1024, 1024, 40, 10, 64, "bfloat16", 0, "wgmma"),
    (2, 200, 200, 8, 2, 128, "bfloat16", 0, "wgmma"),       # 800 rows
    (4, 1, 1024, 40, 10, 128, "bfloat16", 700, "split"),    # Phi-3 decode
    (4, 1, 1024, 40, 10, 128, "float32", 700, "split"),
    (2, 1, 1024, 8, 2, 32, "bfloat16", 0, "split"),
    (4, 1024, 1024, 40, 10, 128, "float32", 0, "simt"),     # f32 prefill
    (1, 8, 64, 8, 2, 32, "bfloat16", 0, "simt"),            # D = 32
    (2, 10, 64, 8, 2, 64, "bfloat16", 0, "simt"),           # 40 rows
    (64, 1, 1024, 40, 10, 128, "bfloat16", 700, "simt"),    # 640 blocks
])
def test_flash_plan_paths(B, Sq, Sk, Hq, Hkv, D, dtype, q_offset, want):
    path, _, _ = ops.flash_plan(B, Sq, Sk, Hq, Hkv, D, getattr(torch, dtype),
                                q_offset=q_offset, num_sms=H100_SMS)
    assert path == want


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv", [
    (0, 1, 1024, 40, 10), (4, 0, 1024, 40, 10), (4, 16, 0, 40, 10),
    (0, 1024, 1024, 40, 10)])
def test_flash_plan_rejects_empty_shapes(B, Sq, Sk, Hq, Hkv):
    """Nothing to plan without rows or keys (the division by B * Hkv
    would fail); the wrapper returns an empty output before planning."""
    with pytest.raises(ValueError, match="no work"):
        ops.flash_plan(B, Sq, Sk, Hq, Hkv, 128, torch.bfloat16,
                       num_sms=H100_SMS)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,dtype,want", [
    (8, 2048, 2048, 36, 36, 64, "bfloat16", "wgmma"),   # MiniCPM-2B trained
    (1, 2048, 2048, 40, 10, 128, "bfloat16", "wgmma"),  # Phi-3 trained
    (2, 100, 300, 8, 2, 128, "bfloat16", "wgmma"),      # Sq != Sk
    (1, 16, 16, 4, 1, 64, "bfloat16", "wgmma"),         # 64 rows, G = 4
    (8, 2048, 2048, 36, 36, 64, "float32", "simt"),     # f32
    (2, 77, 77, 8, 2, 64, "float32", "simt"),
    (2, 100, 100, 8, 2, 32, "bfloat16", "simt"),        # D = 32
    (1, 15, 15, 4, 1, 64, "bfloat16", "simt"),          # 60 rows
    (1, 60, 200, 4, 4, 128, "bfloat16", "simt"),
])
def test_flash_bwd_plan_paths(B, Sq, Sk, Hq, Hkv, D, dtype, want):
    assert ops.flash_bwd_plan(B, Sq, Sk, Hq, Hkv, D,
                              getattr(torch, dtype)) == want


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv", [
    (0, 2048, 2048, 36, 36), (8, 0, 2048, 36, 36), (8, 2048, 0, 36, 36),
    (8, 2048, 2048, 0, 36), (8, 2048, 2048, 36, 0)])
def test_flash_bwd_plan_rejects_empty_shapes(B, Sq, Sk, Hq, Hkv):
    with pytest.raises(ValueError, match="no work"):
        ops.flash_bwd_plan(B, Sq, Sk, Hq, Hkv, 64, torch.bfloat16)


@pytest.mark.parametrize("B,Sq", [(0, 1), (0, 1024), (2, 0)])
def test_flash_attention_empty_rows(B, Sq):
    """No rows: an empty output of q's shape and dtype, no launch."""
    ops.reset_launches()
    q = torch.zeros((B, Sq, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((B, 5, 2, 64), dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, k, q_offset=4)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert sum(ops.LAUNCHES.values()) == sum(ops.FLASH_PATHS.values()) == 0


@pytest.mark.parametrize("B,Hkv,Sq,Sk,q_offset,causal", [
    (4, 10, 1, 1024, 700, True), (4, 10, 1, 1024, 0, True),
    (2, 2, 1, 1024, 63, True), (2, 2, 1, 1024, 64, True),
    (2, 2, 1, 1024, 1000, True), (1, 1, 4, 5000, 4000, True),
    (3, 5, 2, 333, 0, False), (8, 16, 1, 100, 300, True)])
@pytest.mark.parametrize("num_sms", [H100_SMS, 114])   # SXM and PCIe
def test_flash_plan_splits_cover_keys(B, Hkv, Sq, Sk, q_offset, causal,
                                      num_sms):
    path, split_len, n_split = ops.flash_plan(
        B, Sq, Sk, 4 * Hkv, Hkv, 128, torch.bfloat16, causal=causal,
        q_offset=q_offset, num_sms=num_sms)
    assert path == "split"
    kend = min(Sk, q_offset + Sq) if causal else Sk
    bounds = _split_bounds(split_len, n_split, kend)
    assert split_len % ops.SPLIT_KEYS == 0
    assert all(hi > lo for lo, hi in bounds)
    assert [j for lo, hi in bounds for j in range(lo, hi)] == \
        list(range(kend))
    # about two blocks per SM, never more splits than the keys need
    assert B * Hkv * (n_split - 1) < 2 * num_sms
    assert n_split <= -(-kend // ops.SPLIT_KEYS)


# --------------------------------------------------------- rwkv6_chunked --
def _rwkv_inputs(B, S, H, lo=0.7, s0_scale=0.1):
    r, k, v = (_rand((B, S, H, 64), 0.5) for _ in range(3))
    w = RNG.uniform(lo, 0.999 if lo > 0.5 else 0.6,
                    (B, S, H, 64)).astype(np.float32)
    u = _rand((H, 64), 0.1)
    s0 = _rand((B, H, 64, 64), s0_scale)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,S,H,chunk", [(1, 64, 1, 16), (2, 128, 2, 32),
                                         (1, 256, 4, 64), (2, 48, 1, 16),
                                         (1, 48, 1, 24), (2, 64, 2, 8),
                                         (1, 48, 1, 48)])
def test_rwkv6_chunked_shapes(B, S, H, chunk):
    ins = _rwkv_inputs(B, S, H)
    y, sf = ops.rwkv6_chunked(*map(_t, ins), chunk=chunk)
    y_seq, sf_seq = TREF.rwkv6_reference(*map(_t, ins))
    jins = list(map(jnp.asarray, ins))
    for want_y, want_s in (
            JOPS.rwkv6_chunked(*jins, chunk=chunk, interpret=True),
            JREF.rwkv6_reference(*jins),
            JSSM.rwkv6_chunked_jnp(*jins, chunk=chunk)):
        _close(y, want_y, 1e-4)
        _close(sf, want_s, 1e-4)
        _close(y_seq, want_y, 1e-4)
        _close(sf_seq, want_s, 1e-4)


def test_rwkv6_chunked_strong_decay_stability():
    ins = _rwkv_inputs(1, 128, 1, lo=0.3, s0_scale=0.0)
    y, _ = ops.rwkv6_chunked(*map(_t, ins), chunk=32)
    want, _ = JREF.rwkv6_reference(*map(jnp.asarray, ins))
    _close(y, want, 1e-4)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("chunk", [32, 8])
def test_rwkv6_chunked_reference_log2_form(chunk):
    """The plain version in the CUDA kernel's arithmetic (log2 decays, the
    bonus as the scores' diagonal) against the sequential JAX recurrence at
    strong decay, y and the final state."""
    ins = _rwkv_inputs(1, 128, 1, lo=0.3)
    y, sf = TREF.rwkv6_chunked_reference(*map(_t, ins), chunk=chunk)
    want_y, want_s = JREF.rwkv6_reference(*map(jnp.asarray, ins))
    _close(y, want_y, 1e-4)
    _close(sf, want_s, 1e-4)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_chunked_dtypes(dtype):
    r, k, v, w, u, _ = _rwkv_inputs(1, 64, 2)
    s0 = np.zeros((1, 2, 64, 64), np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j = [jnp.asarray(a, jdt) for a in (r, k, v, w, u)]
    tt = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for a in j]
    y, _ = ops.rwkv6_chunked(*tt, _t(s0), chunk=16)
    assert y.dtype == torch.float32
    f32 = [a.astype(jnp.float32) for a in j]
    want, _ = JREF.rwkv6_reference(*f32, jnp.asarray(s0))
    _close(y, want, 1e-4 if dtype == "float32" else 5e-2)
    got_pallas, _ = JOPS.rwkv6_chunked(*j, jnp.asarray(s0), chunk=16,
                                       interpret=True)
    _close(y, got_pallas, 1e-4)


def test_model_kernel_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 4, 4, 32))
    with pytest.raises(ValueError, match="mismatch"):
        ops.flash_attention(q, torch.zeros((1, 4, 2, 16)),
                            torch.zeros((1, 4, 2, 16)))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros((1, 4, 3, 32)),
                            torch.zeros((1, 4, 3, 32)))
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], q[0], q[0])
    x = torch.zeros((1, 48, 1, 64))
    u, s0 = torch.zeros((1, 64)), torch.zeros((1, 1, 64, 64))
    with pytest.raises(ValueError, match="does not divide"):
        ops.rwkv6_chunked(x, x, x, x, u, s0, chunk=32)
    with pytest.raises(ValueError, match="hd = 64"):
        ops.rwkv6_chunked(x, x, x, x, torch.zeros((1, 32)), s0)
    ops.reset_launches()
    ops.flash_attention(q, q, q)
    ops.rwkv6_chunked(x, x, x, x, u, s0, chunk=16)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    assert ops.FLASH_PATHS == dict.fromkeys(ops.FLASH_PATHS, 0)


# ------------------------------------------------- attention's backward --
# (B, Sq, Sk, Hq, Hkv, D, causal, window): the training masks; GQA; a
# query block shorter than the keys (Sq != Sk, rows at positions 0..Sq-1)
BWD_CASES = [
    (2, 24, 24, 4, 4, 32, True, 0),       # MHA, causal
    (1, 40, 40, 8, 2, 16, True, 0),       # GQA 4:1
    (2, 17, 29, 6, 3, 32, False, 0),      # not causal, Sq != Sk
    (1, 33, 33, 4, 1, 32, True, 7),       # MQA, sliding window
    (1, 20, 45, 4, 2, 16, True, 0),       # causal, Sq < Sk
    (2, 31, 31, 2, 2, 64, False, 9),      # window, not causal
]


def _bwd_inputs(B, Sq, Sk, Hq, Hkv, D):
    return (_rand((B, Sq, Hq, D)), _rand((B, Sk, Hkv, D)),
            _rand((B, Sk, Hkv, D)), _rand((B, Sq, Hq, D)))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", BWD_CASES)
def test_mha_backward_reference_matches_autograd_and_jax(B, Sq, Sk, Hq, Hkv,
                                                        D, causal, window):
    """The plain backward (the formula the CUDA kernel computes) against
    autograd through the plain forward and against ``jax.grad`` of the
    reference's ``chunked_attention``, which the reference trains
    through; f32, 2e-5 (sums in another order)."""
    from repro.models.common import chunked_attention
    q, k, v, do = _bwd_inputs(B, Sq, Sk, Hq, Hkv, D)
    kw = dict(causal=causal, sliding_window=window)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = TREF.mha_reference(tq, tk, tv, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    lse = TREF.mha_lse(_t(q), _t(k), **kw)
    got = TREF.mha_backward_reference(_t(q), _t(k), _t(v), o.detach(), lse,
                                      _t(do), **kw)

    def f(q, k, v):
        return jnp.vdot(chunked_attention(q, k, v, causal=causal, q_offset=0,
                                          block_q=16, sliding_window=window),
                        jnp.asarray(do))
    jgrads = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w, j in zip(got, want, jgrads):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w.numpy(), 2e-5)
        _close(g, np.asarray(j), 2e-5)


def test_mha_lse_is_the_softmax_normaliser():
    q, k, v, _ = _bwd_inputs(2, 12, 12, 4, 2, 16)
    lse = TREF.mha_lse(_t(q), _t(k), causal=True, sliding_window=5)
    s = TREF._masked_scores(_t(q), _t(k), causal=True, sliding_window=5,
                            q_offset=0)
    p = torch.exp(s - lse.reshape(2, 2, 2, 12, 1))
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_flash_attention_gradient_on_the_cpu():
    """On the CPU ``ops.flash_attention`` under grad is the plain version
    under autograd; ``flash_attention_lse`` and ``flash_attention_bwd``
    are the plain LSE and backward, and nothing launches."""
    q, k, v, do = _bwd_inputs(1, 16, 16, 4, 2, 32)
    kw = dict(causal=True, sliding_window=6)
    ops.reset_launches()
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    o2, lse = ops.flash_attention_lse(_t(q), _t(k), _t(v), **kw)
    assert torch.equal(o2, o.detach()) and lse.shape == (1, 4, 16)
    got = ops.flash_attention_bwd(_t(q), _t(k), _t(v), o2, lse, _t(do), **kw)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 2e-5)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(_t(q), _t(k), _t(v), o2, lse[:, :, :3],
                                _t(do), **kw)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv", [(1, 1, 700, 40, 10),
                                            (4, 4, 64, 8, 8), (2, 2, 9, 2, 1)])
def test_flash_plan_under_grad_never_splits(B, Sq, Sk, Hq, Hkv):
    """The split path writes no row log-sum-exp, so a forward whose
    gradient will be taken takes simt or wgmma."""
    assert ops.flash_plan(B, Sq, Sk, Hq, Hkv, 64, torch.bfloat16,
                          num_sms=132)[0] == "split"
    path = ops.flash_plan(B, Sq, Sk, Hq, Hkv, 64, torch.bfloat16,
                          num_sms=132, grad=True)[0]
    assert path == ("wgmma" if Sq * (Hq // Hkv) >= ops.WGMMA_ROWS
                    else "simt")
