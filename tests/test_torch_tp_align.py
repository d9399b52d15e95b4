"""TP head alignment in the port (``repro_torch.models.tp_align``) against
the reference's ``repro.models.tp_align``, on the CPU.

The plan equals the reference's for its own cases and for every
config's heads at tp 4, 8 and 16; the padded model equals the
reference's padded model (its weights carried by ``convert``) and the
port's exact model drawn from the same seed, in the forward and in
decode through a padded cache (2e-5, f32); dead heads get exactly zero
gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import tp_align as JTA  # noqa: E402
from repro.models.common import ModelCfg as JCfg  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import tp_align as TTA  # noqa: E402
from repro_torch.models.common import ModelCfg as TCfg  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 2e-5


def _cfgs(**kw):
    """The same small dense config on both sides, f32."""
    return (JCfg(name="t", family="dense", dtype=jnp.float32, **kw),
            TCfg(name="t", family="dense", dtype=torch.float32, **kw))


def _lm(cfg, seed=0):
    return TLM.LM(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("heads,kv,tp", [
    (40, 8, 16), (40, 10, 16), (36, 36, 16), (56, 8, 16), (48, 1, 16),
    (12, 12, 16), (32, 8, 4)])
def test_plan_equal(heads, kv, tp):
    pl = TTA.plan(heads, kv, tp)
    assert pl == JTA.plan(heads, kv, tp)
    live = [s for s in pl["q_src"] if s >= 0]
    assert sorted(live) == list(range(heads))


@pytest.mark.parametrize("tp", [4, 8, 16])
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_aligned_config_equal(arch, tp):
    """``aligned`` of every published config gives the reference's head
    counts and ``head_maps``."""
    j, t = JTA.aligned(JC.get_config(arch), tp), \
        TTA.aligned(TC.get_config(arch), tp)
    assert (t.n_heads, t.n_kv, t.head_maps) == \
        (j.n_heads, j.n_kv, j.head_maps)
    assert t.n_heads % tp == 0 and t.n_kv % tp == 0


@pytest.mark.parametrize("bias", [False, True])
def test_expand_attn_params_equal(bias):
    rng = np.random.default_rng(5)
    d, dh, (heads, kv) = 24, 8, (6, 3)
    pl = JTA.plan(heads, kv, 4)
    p = {"wq": rng.normal(size=(d, heads * dh)),
         "wk": rng.normal(size=(d, kv * dh)),
         "wv": rng.normal(size=(d, kv * dh)),
         "wo": rng.normal(size=(heads * dh, d))}
    if bias:
        p.update(bq=rng.normal(size=heads * dh), bk=rng.normal(size=kv * dh),
                 bv=rng.normal(size=kv * dh))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = JTA.expand_attn_params({k: jnp.asarray(v) for k, v in p.items()},
                                  pl["q_src"], pl["kv_src"], dh)
    got = TTA.expand_attn_params({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 pl["q_src"], pl["kv_src"], dh)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("heads,kv", [(40, 8), (40, 10), (36, 36), (56, 8),
                                      (48, 1)])
def test_forward_equivalence(heads, kv):
    jcfg, tcfg = _cfgs(n_layers=2, d_model=64, n_heads=heads, n_kv=kv,
                       d_ff=128, vocab=256, d_head=16)
    jpad, tpad = JTA.aligned(jcfg, tp=16), TTA.aligned(tcfg, tp=16)
    assert (tpad.n_heads, tpad.n_kv) == (jpad.n_heads, jpad.n_kv)
    toks = np.random.default_rng(0).integers(0, 256, (2, 8))
    want, _ = JLM.forward(JLM.init_params(KEY, jpad), jpad,
                          jnp.asarray(toks, jnp.int32), remat=False)
    tree = jax.tree.map(np.asarray, JLM.init_params(KEY, jpad))
    with torch.no_grad():
        got = convert.from_jax_params(tpad, tree, device="cpu")(
            torch.from_numpy(toks))
        exact = _lm(tcfg)(torch.from_numpy(toks))
        padded = _lm(tpad)(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(padded.numpy(), exact.numpy(), rtol=TOL,
                               atol=TOL)


def test_decode_equivalence_with_padded_cache():
    _, tcfg = _cfgs(n_layers=2, d_model=64, n_heads=40, n_kv=8, d_ff=128,
                    vocab=256, d_head=16)
    tpad = TTA.aligned(tcfg, tp=16)
    exact, padded = _lm(tcfg), _lm(tpad)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256,
                                                              (1, 6)))
    cache, cache_p = exact.init_cache(1, 6), padded.init_cache(1, 6)
    assert cache_p["layers"][0]["k"].shape[2] == tpad.n_kv == 16
    for i in range(6):
        lg, cache = exact.decode_step(toks[:, i:i + 1], cache)
        lgp, cache_p = padded.decode_step(toks[:, i:i + 1], cache_p)
        np.testing.assert_allclose(lgp.numpy(), lg.numpy(), rtol=TOL,
                                   atol=TOL)


def test_dead_heads_receive_zero_gradient():
    _, tcfg = _cfgs(n_layers=1, d_model=32, n_heads=5, n_kv=5, d_ff=64,
                    vocab=128, d_head=8)
    tpad = TTA.aligned(tcfg, tp=8)                # pad 5 -> 8 heads
    model = _lm(tpad)
    for p in model.parameters():
        p.requires_grad_(True)
    y = model(torch.tensor([[1, 2, 3, 4]]))
    (y.float() ** 2).sum().backward()
    attn = model.blocks[0].attn
    live = torch.tensor([s >= 0 for s in tpad.head_maps[0]])
    assert int((~live).sum()) == 3
    gq = attn.wq.grad.reshape(32, 8, 8)
    go = attn.wo.grad.reshape(8, 8, 32)
    assert torch.equal(gq[:, ~live], torch.zeros_like(gq[:, ~live]))
    assert torch.equal(go[~live], torch.zeros_like(go[~live]))
    assert gq[:, live].abs().max() > 0 and go[live].abs().max() > 0
    wq = attn.wq.detach().reshape(32, 8, 8)
    assert torch.equal(wq[:, ~live], torch.zeros_like(wq[:, ~live]))


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "qwen2_5_32b"])
def test_padded_reduced_config_builds(arch):
    """A reduced config padded for tp 16 builds with its parameter count
    equal to the reference's padded ``init_params``."""
    jcfg = JTA.aligned(dataclasses.replace(JC.get_reduced(arch),
                                           dtype=jnp.float32), 16)
    tcfg = TTA.aligned(dataclasses.replace(TC.get_reduced(arch),
                                           dtype=torch.float32), 16)
    shapes = jax.eval_shape(lambda: JLM.init_params(KEY, jcfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in _lm(tcfg).parameters()) == want
