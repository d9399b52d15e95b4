"""The chunked RWKV-6 time mix's plain backward against the JAX package.

``ref.rwkv6_chunked_backward_reference`` is the formula the backward
kernel (``csrc/rwkv6_chunked_bwd.cu``) computes and the plain version
the card holds that kernel against.  Here it is held against
``jax.vjp`` of ``repro.models.ssm.rwkv6_chunked_jnp``, the reference's
own chunked function, on the CPU: the same numpy inputs and cotangents
(dy, and the final state's where a case has one), its chunk-start states
from the port's plain forward.  Chunks 8 and 24 pad to the kernel's 16
and 32, 16 and 32 do not; cases carry a non-zero wkv0, a final-state
cotangent, strong decay and w below 1e-30 (once a chunk and channel, so
the reference's masked positive exponents stay finite), where the
gradient of w is 0.  Each of the six gradients within 1e-5 of its
largest entry: both sides are f32 and differ in their log base and
summation orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402

# (B, S, H, chunk, w low, w high, wkv0 scale, with d wkv_final, tiny w)
CASES = {
    "chunk8": (2, 96, 2, 8, 0.7, 0.999, 0.0, False, False),
    "chunk16 wkv0 d_final": (2, 96, 2, 16, 0.7, 0.999, 0.1, True, False),
    "chunk24 d_final": (1, 96, 2, 24, 0.7, 0.999, 0.0, True, False),
    "chunk32 strong decay wkv0": (1, 96, 2, 32, 0.3, 0.6, 0.1, False, False),
    "chunk16 tiny w": (1, 96, 2, 16, 0.7, 0.999, 0.1, True, True),
    "chunk32 tiny w d_final": (1, 64, 1, 32, 0.7, 0.999, 0.0, True, True),
}
NAMES = ("dr", "dk", "dv", "dw", "du", "dwkv0")


def _inputs(B, S, H, C, lo, hi, s0, fin, tiny, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r, k, v = (rng.normal(0, 0.5, (B, S, H, 64)).astype(f32)
               for _ in range(3))
    w = rng.uniform(lo, hi, (B, S, H, 64)).astype(f32)
    if tiny:
        w[:, 3::C, :, ::5] = 1e-35
    u = rng.normal(0, 0.1, (H, 64)).astype(f32)
    wkv0 = rng.normal(0, s0, (B, H, 64, 64)).astype(f32)
    dy = rng.normal(0, 1, (B, S, H, 64)).astype(f32)
    dfin = (rng.normal(0, 1, (B, H, 64, 64)) if fin
            else np.zeros((B, H, 64, 64))).astype(f32)
    return (r, k, v, w, u, wkv0), dy, dfin


def _jax_grads(ins, dy, dfin, C):
    def f(*a):
        return JSSM.rwkv6_chunked_jnp(*a, chunk=C)
    (y, wkv), vjp = jax.vjp(f, *map(jnp.asarray, ins))
    grads = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_rwkv6_backward_reference_matches_jax_vjp(case):
    B, S, H, C, lo, hi, s0, fin, tiny = CASES[case]
    ins, dy, dfin = _inputs(B, S, H, C, lo, hi, s0, fin, tiny,
                            seed=len(case))
    want = _jax_grads(ins, dy, dfin, C)
    t = [torch.from_numpy(a) for a in ins]
    _, _, states = TREF.rwkv6_chunked_reference(*t, chunk=C, states=True)
    got = TREF.rwkv6_chunked_backward_reference(
        *t[:5], states, torch.from_numpy(dy),
        torch.from_numpy(dfin) if fin else None, chunk=C)
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) / scale <= 1e-5, name
    if tiny:
        below = ins[3] < 1e-30
        assert below.any()
        assert (got[3].numpy()[below] == 0).all()
        assert (want[3][below] == 0).all()
