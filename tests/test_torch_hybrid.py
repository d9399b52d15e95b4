"""The port's Mamba layer (``repro_torch.models.ssm.Mamba``) vs the JAX
reference's ``repro.models.ssm.apply_mamba``.

Weights from ``init_mamba`` at reduced Jamba's widths (d 128, d_in 256,
d_state 16), carried into the port by ``convert.to_tensor``; inputs from
numpy.  The parallel form scans 256-token chunks (one chunk at S = 24,
two at S = 512); the recurrent form takes one token from a carried
state.  Tolerances: 1e-4 in f32 (the reference's associative scan and
the port's sequential one multiply the decays in another order; the
GEMMs sum in another order), 5e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

ARCH = "jamba_1_5_large"


class MambaPair:
    """One Mamba layer on both sides with the reference's weights."""

    def __init__(self, bf16=False, seed=0):
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                    else (jnp.float32, torch.float32))
        self.jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=jdt)
        self.tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=tdt)
        self.params = JSSM.init_mamba(jax.random.PRNGKey(seed), self.jcfg)
        # the reference's dt_bias and D start at 0 and 1: draw them, so
        # that the mean of dt_bias and the skip term are exercised
        rng = np.random.default_rng(seed)
        d_in = 2 * self.jcfg.d_model
        self.params = dict(
            self.params,
            dt_bias=jnp.asarray(rng.normal(0, 0.5, d_in), jnp.float32),
            D=jnp.asarray(rng.normal(1, 0.2, d_in), jnp.float32))
        self.layer = TSSM.Mamba(self.tcfg, device="cpu")
        for name, p in self.layer.named_parameters():
            t = convert.to_tensor(np.asarray(self.params[name]), device="cpu")
            assert t.shape == p.shape and t.dtype == p.dtype, name
            p.data.copy_(t)
        self.japply = jax.jit(lambda p, x, st: JSSM.apply_mamba(
            p, x, self.jcfg, state=st))

    def x(self, B, S, seed):
        return np.random.default_rng(seed).normal(
            0, 1, (B, S, self.jcfg.d_model)).astype(np.float32)

    def ref(self, x, state=None):
        st = None if state is None else {k: jnp.asarray(v)
                                         for k, v in state.items()}
        out, new = self.japply(self.params,
                               jnp.asarray(x, self.jcfg.dtype), st)
        return (np.array(out.astype(jnp.float32)),
                {k: np.array(v.astype(jnp.float32)) for k, v in new.items()})

    def port(self, x, state=None):
        st = None if state is None else {
            "conv": torch.from_numpy(state["conv"]).to(self.tcfg.dtype),
            "ssm": torch.from_numpy(state["ssm"])}
        out, new = self.layer(torch.from_numpy(x).to(self.tcfg.dtype), st)
        return out.float().numpy(), {k: v.float().numpy()
                                     for k, v in new.items()}


@pytest.fixture(scope="module")
def pair():
    return MambaPair()


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def test_parameters_match_the_reference_layout(pair):
    names = {n: tuple(p.shape) for n, p in pair.layer.named_parameters()}
    assert names == {k: tuple(v.shape) for k, v in pair.params.items()}
    fresh = TSSM.Mamba(pair.tcfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    ref = JSSM.init_mamba(jax.random.PRNGKey(0), pair.jcfg)
    for name in ("A_log", "dt_bias", "D"):
        assert getattr(fresh, name).dtype == torch.float32
        np.testing.assert_allclose(getattr(fresh, name).numpy(),
                                   np.asarray(ref[name]), rtol=1e-7)


@pytest.mark.parametrize("S", [24, 512])     # one / two scan chunks
def test_parallel_form_matches_reference(pair, S):
    x = pair.x(2, S, seed=S)
    want, wst = pair.ref(x)
    got, st = pair.port(x)
    assert got.shape == (2, S, pair.jcfg.d_model)
    _close(got, want, 1e-4)
    _close(st["conv"], wst["conv"], 1e-5, "conv")   # in_proj's GEMM
    _close(st["ssm"], wst["ssm"], 1e-4, "ssm")


def test_recurrent_form_from_a_carried_state(pair):
    """The reference's parallel form over 40 tokens gives the state; 16
    one-token steps follow on both sides, each from its own side's
    state, and the port's steps equal its own parallel form's last 16
    outputs over all 56 tokens."""
    x = pair.x(2, 56, seed=3)
    _, wst = pair.ref(x[:, :40])
    st = dict(wst)
    outs = []
    for t in range(40, 56):
        want, wst = pair.ref(x[:, t:t + 1], wst)
        got, st = pair.port(x[:, t:t + 1], st)
        _close(got, want, 1e-4, str(t))
        outs.append(got)
    _close(st["conv"], wst["conv"], 1e-5, "conv")
    _close(st["ssm"], wst["ssm"], 1e-4, "ssm")
    full, _ = pair.port(x)
    _close(np.concatenate(outs, axis=1), full[:, 40:], 1e-4)


def test_recurrent_form_takes_one_token(pair):
    st = {"conv": np.zeros((1, 3, 2 * pair.jcfg.d_model), np.float32),
          "ssm": np.zeros((1, 2 * pair.jcfg.d_model, pair.jcfg.d_state),
                          np.float32)}
    with pytest.raises(ValueError, match="one token"):
        pair.port(pair.x(1, 2, seed=0), st)


def test_bf16_matches_reference():
    p = MambaPair(bf16=True, seed=1)
    assert p.layer.in_proj.dtype == torch.bfloat16
    assert p.layer.A_log.dtype == torch.float32
    x = p.x(2, 24, seed=5)
    want, wst = p.ref(x)
    got, st = p.port(x)
    _close(got, want, 5e-2)
    for t in range(4):
        xt = p.x(2, 1, seed=10 + t)
        want, wst = p.ref(xt, wst)
        got, st = p.port(xt, st)
        _close(got, want, 5e-2, str(t))
