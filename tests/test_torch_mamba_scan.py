"""The Mamba scan's wrapper (``ops.mamba_scan``), its plain versions and
the ``Mamba`` layer's gradients against the JAX reference, on the CPU.

- The plain backward (``ref.mamba_scan_backward_reference``, the
  formula of the backward kernel) against autograd of the plain forward,
  within 1e-5 of each gradient's largest entry (the same f32 terms
  summed in another order), with h0 zero and not, with and without the
  final state's gradient, at ragged S and channel counts;
- the checkpoint states (every 16th token's) are the token loop's;
- the ``Mamba`` layer's input and parameter gradients (``A_log``,
  ``dt_bias`` and ``D`` included) against ``jax.grad`` of
  ``apply_mamba`` at reduced Jamba's widths, at S 24 and 512 (one and
  two 256-token chunks of the reference's scan) and a ragged S, of a
  loss on the output and on the final state: within 1e-4 of each
  tensor's largest entry in f32 (the reference's associative scan
  multiplies the decays in another order, the GEMMs sum in another);
- the wrapper rejects bad inputs; on ``meta`` it credits
  ``work.mamba_scan_work``'s work and launches nothing.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 5b).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from test_torch_hybrid import MambaPair  # noqa: E402

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(B, S, E, seed, h0=True, N=16):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32))
    x = t(B, S, E)
    dt = torch.nn.functional.softplus(t(B, S) - 1.0)
    A = -torch.exp(torch.log(torch.arange(1, N + 1).float()).repeat(E, 1)
                   + t(E, N, scale=0.2))
    Bm, Cm = t(B, S, N), t(B, S, N)
    h0 = t(B, E, N) if h0 else torch.zeros(B, E, N)
    return [x, dt, A, Bm, Cm, h0]


BWD_CASES = {"h0_zero": (2, 40, 24, False, False),
             "h0_and_dh_final": (1, 37, 70, True, True),
             "one_token": (2, 1, 8, True, True),
             "whole_segments": (2, 48, 64, False, True),
             "ragged_channels": (1, 21, 130, True, False)}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_backward_reference_matches_autograd(name):
    B, S, E, h0, fin = BWD_CASES[name]
    ins = _inputs(B, S, E, seed=len(name), h0=h0)
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.normal(0, 1, (B, S, E)).astype(np.float32))
    dfin = (torch.from_numpy(rng.normal(0, 1, (B, E, 16)).astype(
        np.float32)) if fin else None)
    leaves = [a.clone().requires_grad_(True) for a in ins]
    y, hT = R.mamba_scan_reference(*leaves)
    loss = (y * dy).sum() + ((hT * dfin).sum() if fin else 0.0)
    auto = torch.autograd.grad(loss, leaves)
    got = R.mamba_scan_backward_reference(*ins, dy, dfin)
    for n, g, w in zip(NAMES, got, auto):
        assert g.shape == w.shape, n
        assert _rel(g, w) <= 1e-5, (n, _rel(g, w))


@pytest.mark.parametrize("S", [1, 16, 33])
def test_states_are_the_token_loops(S):
    """``states=True`` leaves y and the final state as they are and gives
    the state before tokens 0, 16, 32, ...; ``ops.mamba_scan_states`` and
    ``ops.mamba_scan_bwd`` take the plain versions on the CPU."""
    ins = _inputs(2, S, 12, seed=S)
    y, hT = R.mamba_scan_reference(*ins)
    y2, hT2, st = ops.mamba_scan_states(*ins)
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    assert st.shape == (2, -(-S // 16), 12, 16)
    for s in range(st.shape[1]):
        want = ins[5] if s == 0 else R.mamba_scan_reference(
            *[a[:, :16 * s] if a.ndim >= 2 and a.shape[:2] == (2, S) else a
              for a in ins])[1]
        assert torch.equal(st[:, s], want), s
    dy = torch.ones_like(y)
    got = ops.mamba_scan_bwd(*ins[:5], st, dy)
    want = R.mamba_scan_backward_reference(*ins, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _mamba_grads(pair, S, seed, B=2):
    """The reference's and the port's gradients of ``sum(out r) +
    sum(ssm r2)`` with respect to every parameter and the input."""
    x = pair.x(B, S, seed)
    rng = np.random.default_rng(seed + 1)
    d, d_in = pair.jcfg.d_model, 2 * pair.jcfg.d_model
    r = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    r2 = rng.normal(0, 1, (B, d_in, 16)).astype(np.float32)

    def f(p, xx):
        out, st = JSSM.apply_mamba(p, xx, pair.jcfg)
        return jnp.sum(out * r) + jnp.sum(st["ssm"] * r2)
    jg_p, jg_x = jax.jit(jax.grad(f, argnums=(0, 1)))(pair.params,
                                                      jnp.asarray(x))
    layer = pair.layer
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, st = layer(xt)
    loss = (out * torch.from_numpy(r)).sum() + \
        (st["ssm"] * torch.from_numpy(r2)).sum()
    named = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [xt, *named.values()])
    layer.requires_grad_(False)
    got = {"x": grads[0], **dict(zip(named, grads[1:]))}
    want = {"x": jg_x, **{n: jg_p[n] for n in named}}
    return got, want


@pytest.fixture(scope="module")
def pair():
    return MambaPair(seed=3)


@pytest.mark.parametrize("S", [24, 512, 37])
def test_mamba_grads_match_reference(pair, S):
    got, want = _mamba_grads(pair, S, seed=S)
    assert set(got) == {"x", "in_proj", "conv_w", "x_proj", "dt_bias",
                        "A_log", "D", "out_proj"}
    for n in got:
        assert float(np.abs(np.asarray(want[n])).max()) > 0, n
        err = _rel(got[n].numpy(), want[n])
        assert err <= TOL, (n, err)


def test_wrapper_rejects_bad_inputs():
    ins = _inputs(2, 8, 12, seed=0)
    bad = {1: torch.zeros(2, 7), 2: torch.zeros(12, 8),
           3: torch.zeros(2, 8, 15), 4: torch.zeros(1, 8, 16),
           5: torch.zeros(2, 12, 8)}
    for i, t in bad.items():
        args = list(ins)
        args[i] = t
        with pytest.raises(ValueError):
            ops.mamba_scan(*args)
    with pytest.raises(ValueError, match="S must be"):
        ops.mamba_scan(*_inputs(2, 0, 12, seed=0))
    with pytest.raises(ValueError, match="several devices"):
        ops.mamba_scan(*ins[:5], ins[5].to("meta"))
    with pytest.raises(ValueError):
        ops.mamba_scan(ins[0][0], *ins[1:])
    _, _, st = ops.mamba_scan_states(*ins)
    dy = torch.zeros(2, 8, 12)
    with pytest.raises(ValueError, match="states must be"):
        ops.mamba_scan_bwd(*ins[:5], st[:, 0], dy)
    with pytest.raises(ValueError, match="need states"):
        ops.mamba_scan_bwd(*ins[:5], st, dy, torch.zeros(2, 12, 4))
    with pytest.raises(ValueError, match="need states"):
        ops.mamba_scan_bwd(*ins[:5], torch.cat([st, st], 1), dy)


@pytest.mark.parametrize("grad", [False, True])
def test_meta_credits_the_scan_work(grad):
    """On ``meta``: empty outputs of the card path's shapes, the work of
    ``work.mamba_scan_work`` credited (its FLOPs and exponentials as
    FLOPs), the forward with its checkpoints under grad and the backward
    in ``backward``; nothing launched."""
    B, S, E = 2, 40, 64
    ins = [a.to("meta") for a in _inputs(B, S, E, seed=1)]
    seen = []
    ops.reset_launches()
    with work.listen(lambda *a: seen.append(a)):
        leaves = [a.requires_grad_(grad) for a in ins]
        y, hT = ops.mamba_scan(*leaves)
        assert y.shape == (B, S, E) and hT.shape == (B, E, 16)
        assert y.is_meta and hT.is_meta
        if grad:
            gs = torch.autograd.grad((y.sum() + hT.sum()), leaves)
            assert [tuple(g.shape) for g in gs] == \
                [tuple(a.shape) for a in ins]
    f, x, nb = work.mamba_scan_work(B, S, E, 16, states=grad)
    want = [("mamba_scan", f + x, nb, False)]
    if grad:
        fb, xb, nbb = work.mamba_scan_work(B, S, E, 16, backward=True)
        want.append(("mamba_scan_bwd", fb + xb, nbb, False))
    assert seen == want
    assert not any(ops.LAUNCHES.values())


def test_scan_work_and_bound_at_jamba_width():
    """At Jamba-1.5-Large's width (E 16,384) and 1 x 2,048 tokens the
    forward takes 537 M exponentials: bound by them, 0.127 ms at the
    SFU's rate, above its bytes' 0.080 ms."""
    f, x, nb = work.mamba_scan_work(1, 2048, 16384, 16)
    assert x == 2048 * 16384 * 16 == 536_870_912
    ms, by = work.mamba_scan_bound(f, x, nb)
    assert by == "operations"
    assert ms == pytest.approx(x / work.EXP_PER_S * 1e3)
    assert 0.12 < ms < 0.13 and nb / work.HBM_BYTES_PER_S * 1e3 < ms
    fb, xb, nbb = work.mamba_scan_work(1, 2048, 16384, 16, backward=True)
    assert xb == x and fb > f and nbb > nb


@pytest.mark.parametrize("S,calls", [(1, 0), (5, 1), (300, 1)])
def test_parallel_form_calls_the_scan(S, calls):
    """``Mamba.forward`` runs the scan through ``ops.mamba_scan`` for S >
    1 (on ``meta``: one credit a layer) and the one-token recurrence in
    torch ops."""
    cfg = MambaPair().tcfg
    layer = TSSM.Mamba(cfg, device="meta")
    seen = []
    with work.listen(lambda *a: seen.append(a[0])):
        out, st = layer(torch.empty(2, S, cfg.d_model, device="meta"))
    assert out.shape == (2, S, cfg.d_model)
    assert st["ssm"].shape == (2, 2 * cfg.d_model, cfg.d_state)
    assert seen == ["mamba_scan"] * calls
