"""The port's MoE feed-forward (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU.

Weights come from ``repro.models.moe.init_moe`` and are carried into the
port's ``MoE``; inputs and router probabilities are drawn with numpy
from fixed seeds.  The dispatch's integer outputs (``dst``, ``keep``,
``counts``) and gates must equal the reference's exactly, ties included;
the layer within 1e-4 in f32 and 5e-2 in bf16, its aux loss within 1e-5
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.common import init_rope  # noqa: E402


def _cfgs(arch, *, dtype="f32", **moe):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    j, t = JC.get_reduced(arch), TC.get_reduced(arch)
    return (dataclasses.replace(j, dtype=jdt,
                                moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, dtype=tdt,
                                moe=dataclasses.replace(t.moe, **moe)))


def _pair(arch, *, seed=0, **kw):
    """(reference params, port MoE) with the same weights."""
    jcfg, tcfg = _cfgs(arch, **kw)
    params = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    moe = TMOE.MoE(tcfg, device="cpu")
    flat = dict(convert._flatten(jax.tree.map(np.asarray, params)))
    own = dict(moe.named_parameters())
    assert own.keys() == flat.keys()
    for name, p in own.items():
        t = convert.to_tensor(flat[name], device="cpu")
        assert t.shape == p.shape and t.dtype == p.dtype, name
        p.data.copy_(t)
    assert moe.router.dtype == torch.float32
    return jcfg, params, moe


def _x(cfg, B, S, seed, common=0.0):
    """Token activations; ``common`` scales a direction all tokens share,
    which skews the routing so that experts overflow."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, cfg.d_model)) + \
        common * rng.normal(0, 1, cfg.d_model)
    return x.astype(np.float32)


def _dispatch_both(xt, probs, k, cap, E):
    want = JMOE._local_dispatch(jnp.asarray(xt), jnp.asarray(probs), k, cap,
                                E)
    got = TMOE.local_dispatch(torch.from_numpy(xt), torch.from_numpy(probs),
                              k, cap, E)
    names = ("buf", "dst", "keep", "gate", "counts")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(
        got[5].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1]),
        err_msg="topi")
    return got


def _probs(rng, t, E, kind):
    if kind == "random":
        logits = rng.normal(0, 1, (t, E))
    elif kind == "zero_router":     # softmax of zeros: every prob 1/E
        logits = np.zeros((t, E))
    else:                           # few distinct levels: ties everywhere
        logits = rng.integers(0, 3, (t, E)).astype(np.float64)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "zero_router", "levels"])
@pytest.mark.parametrize("t,E,k", [(16, 8, 1), (16, 8, 2), (24, 64, 6),
                                   (13, 4, 2), (37, 8, 6), (5, 64, 6)])
def test_local_dispatch_equals_reference(kind, t, E, k):
    """Same probabilities in, equal buffers, ``dst``, ``keep``, gates and
    counts out; ``t`` need not be a multiple of ``E``."""
    rng = np.random.default_rng(t * 100 + E + k)
    xt = rng.normal(0, 1, (t, 12)).astype(np.float32)
    probs = _probs(rng, t, E, kind)
    cap = TMOE.capacity(1.25, k, t, E)
    assert cap == int(max(1, 1.25 * k * t / E))
    _, _, keep, _, counts, _ = _dispatch_both(xt, probs, k, cap, E)
    assert int(counts.sum()) == int(keep.sum())
    if kind == "zero_router":       # experts 0..k-1 take cap tokens each
        assert counts[:k].tolist() == [min(cap, t)] * k
        assert int(counts[k:].sum()) == 0


def test_top_k_breaks_ties_lowest_index_first():
    p = np.array([[.1, .5, .5, .2, .5], [.3, .3, .3, .3, .3]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(p), k)
        gv, gi = TMOE.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_capacity_in_decode():
    """Four decode slots: DeepSeek-MoE-16B and Mixtral-8x7B hold one
    token an expert."""
    for arch in ("deepseek_moe_16b", "mixtral_8x7b"):
        me = TC.get_config(arch).moe
        cap = TMOE.capacity(me.capacity_factor, me.top_k, 4, me.n_experts)
        assert cap == 1 == int(max(1, me.capacity_factor * me.top_k * 4
                                   / me.n_experts))


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 5e-2)])
@pytest.mark.parametrize("arch,n_shared", [("deepseek_moe_16b", 1),
                                           ("deepseek_moe_16b", 0),
                                           ("mixtral_8x7b", 0),
                                           ("mixtral_8x7b", 2)])
def test_moe_layer_matches_reference(arch, n_shared, dtype, tol):
    """``MoE.forward`` against ``apply_moe`` (its dense path) at the
    default capacity factor, where tokens are dropped."""
    jcfg, params, moe = _pair(arch, dtype=dtype, n_shared=n_shared)
    x = _x(jcfg, 2, 24, seed=11, common=1.0)
    jx = jnp.asarray(x, jcfg.dtype)
    want, waux = jax.jit(lambda p, v: JMOE.apply_moe(p, v, jcfg))(params, jx)
    tx = torch.from_numpy(x).to(moe.w_gate.dtype)
    got, aux = moe(tx, with_aux=True)
    assert got.dtype == moe.w_gate.dtype and got.shape == x.shape
    alone, none = moe(tx)                    # aux only when asked for
    assert none is None and torch.equal(alone, got)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    # drops happen at this capacity factor
    xt = jnp.asarray(x.reshape(-1, jcfg.d_model), jnp.float32)
    probs = jax.nn.softmax(xt @ params["router"], -1)
    cap = TMOE.capacity(jcfg.moe.capacity_factor, jcfg.moe.top_k, 48,
                        jcfg.moe.n_experts)
    keep = JMOE._local_dispatch(xt, probs, jcfg.moe.top_k, cap,
                                jcfg.moe.n_experts)[2]
    assert not bool(keep.all())


def test_moe_on_zero_router_matches_reference():
    """Every token routes to experts 0..k-1 (ties): most overflow."""
    jcfg, params, moe = _pair("deepseek_moe_16b")
    params = dict(params, router=jnp.zeros_like(params["router"]))
    moe.router.data.zero_()
    x = _x(jcfg, 2, 16, seed=4)
    want, waux = JMOE.apply_moe(params, jnp.asarray(x), jcfg)
    got, aux = moe(torch.from_numpy(x), with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x7b"])
def test_sort_dispatch_equals_einsum_oracle_dropless(arch):
    """Dropless (capacity factor = n_experts): the sort dispatch equals
    the port's one-hot einsum oracle, which equals the reference's."""
    E = TC.get_reduced(arch).moe.n_experts
    jcfg, params, moe = _pair(arch, n_shared=0, capacity_factor=float(E))
    x = _x(jcfg, 2, 12, seed=5)
    got, aux = moe(torch.from_numpy(x), with_aux=True)
    ora, ora_aux = TMOE.apply_moe_dense_einsum(moe, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ora.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the oracle's expert fractions are per token, the sort path's per
    # kept row: dropless they differ by the factor top_k, in both packages
    np.testing.assert_allclose(float(ora_aux), jcfg.moe.top_k * float(aux),
                               rtol=1e-5)
    want, waux = JMOE._apply_moe_dense_einsum(params, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ora.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(ora_aux), float(waux), rtol=1e-5)


def test_einsum_oracle_matches_reference_with_drops():
    jcfg, params, moe = _pair("mixtral_8x7b", n_shared=0)
    x = _x(jcfg, 2, 20, seed=8)
    got, aux = TMOE.apply_moe_dense_einsum(moe, torch.from_numpy(x))
    want, waux = JMOE._apply_moe_dense_einsum(params, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_local_dispatch_returns_each_tokens_top_k():
    """The sixth output, the top-k experts each token asked for, is where
    every kept row went, and the kept rows' per-expert counts."""
    jcfg, _, moe = _pair("mixtral_8x7b")
    me = jcfg.moe
    xt = torch.from_numpy(_x(jcfg, 1, 10, seed=2)[0])
    cap = TMOE.capacity(me.capacity_factor, me.top_k, 10, me.n_experts)
    _, dst, keep, _, counts, topi = TMOE.local_dispatch(
        xt, TMOE.route(xt, moe.router), me.top_k, cap, me.n_experts)
    assert topi.shape == (10, me.top_k)
    kept = keep.reshape(10, me.top_k)
    e = dst.reshape(10, me.top_k) // cap
    assert torch.equal(e[kept], topi[kept])
    assert torch.equal(torch.bincount(e[kept], minlength=me.n_experts)
                       .to(torch.int32), counts)


def test_full_width_deepseek_layer_drops_as_the_reference():
    """DeepSeek-MoE-16B's routing at its published width (d 2,048, 64
    experts, top 6, capacity factor 1.25) on the input a full-width
    first layer hands its MoE: 1 x 1,024 random embedding rows through
    the port's attention and ``ln2``, taken by a forward pre-hook.  The
    reference's dispatch on it (``_apply_moe_dense``'s probabilities,
    ``cap`` and ``_local_dispatch``) drops the same (token, expert)
    assignments as the port's own, and the layer agrees with
    ``apply_moe``.  The expert width is cut to 16: the routing does not
    read it."""
    tcfg = TC.get_config("deepseek_moe_16b")
    tcfg = dataclasses.replace(tcfg, n_layers=1, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe,
                                                       d_ff_expert=16))
    gen = torch.Generator().manual_seed(0)
    blk = TLM.Block(tcfg, "attn_moe", device="cpu", generator=gen)
    seen = []
    blk.moe.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    S, d = 1024, tcfg.d_model
    x = torch.randn((1, S, d), generator=gen) * 0.02   # LM.embed's scale
    rope = init_rope(tcfg.d_head, S, tcfg.rope_theta, device="cpu")
    blk(x, rope, torch.arange(S)[None])
    h = seen[0]
    moe, me = blk.moe, tcfg.moe
    params = {}
    for name, t in moe.named_parameters():
        *path, leaf = name.split(".")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(t.numpy())
    jcfg = JC.get_config("deepseek_moe_16b")
    jcfg = dataclasses.replace(jcfg, n_layers=1, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe,
                                                       d_ff_expert=16))
    hj = jnp.asarray(h.reshape(S, d).numpy())
    jprobs = jax.nn.softmax(hj @ params["router"], axis=-1)
    cap = int(max(1, jcfg.moe.capacity_factor * jcfg.moe.top_k * S
                  / jcfg.moe.n_experts))
    assert cap == TMOE.capacity(me.capacity_factor, me.top_k, S,
                                me.n_experts) == 120
    _, wdst, wkeep, _, wcounts = JMOE._local_dispatch(
        hj, jprobs, me.top_k, cap, me.n_experts)
    ht = h.reshape(S, d)
    _, dst, keep, _, counts, _ = TMOE.local_dispatch(
        ht, TMOE.route(ht, moe.router), me.top_k, cap, me.n_experts)
    for name, g, w in (("dst", dst, wdst), ("keep", keep, wkeep),
                       ("counts", counts, wcounts)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert int((~keep).sum()) > 0         # the capacity does drop here
    want, waux = JMOE.apply_moe(params, jnp.asarray(h.numpy()), jcfg)
    got, aux = moe(h, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
