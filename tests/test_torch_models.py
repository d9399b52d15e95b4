"""The port's model zoo (all six families: dense, MoE, VLM, hybrid,
enc-dec, RWKV) vs the JAX reference.

Reduced configs, weights drawn by ``repro.models.lm.init_params`` and
carried into the port by ``convert.from_jax_params``; tokens (and the
VLM's patch embeddings, the enc-dec family's frame embeddings) from
numpy.
On the CPU attention runs ``ops.flash_attention``'s plain version and
RWKV prefill ``ops.rwkv6_chunked``'s.  Tolerances: 1e-4 in f32 (sums in
another order), 5e-2 in bf16 (the frameworks round bf16 products at other
places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.models import common as JCOM  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import common as TCOM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

ARCHS = ["phi3_medium_14b", "qwen2_5_32b", "granite_34b", "rwkv6_7b",
         "deepseek_moe_16b", "mixtral_8x7b", "llava_next_34b",
         "jamba_1_5_large", "whisper_small"]
MOE_ARCHS = ["deepseek_moe_16b", "mixtral_8x7b", "jamba_1_5_large"]
TOL = 1e-4
TE = 12     # the enc-dec family's frames a sequence


def _np(a):
    return np.asarray(a, np.float32)


def _tok(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _dropless(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


class Pair:
    """One reduced architecture on both sides with the same weights."""

    def __init__(self, arch, bf16=False, dropless=False):
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                    else (jnp.float32, torch.float32))
        self.jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=jdt)
        self.tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=tdt)
        if dropless:
            self.jcfg, self.tcfg = _dropless(self.jcfg), _dropless(self.tcfg)
        self.params = JLM.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.model = convert.from_jax_params(
            self.tcfg, jax.tree.map(np.asarray, self.params), device="cpu")
        self.jfwd = jax.jit(lambda p, t, **kw: JLM.forward(
            p, self.jcfg, t, remat=False, **kw))
        self.jdec = jax.jit(lambda p, t, c, **kw: JLM.decode_step(
            p, self.jcfg, t, c, **kw))

    def prefix(self, B):
        """{} or, for the VLM, numpy patch embeddings [B, Np, d] under
        ``prefix_embed``; for the enc-dec family numpy frame embeddings
        [B, TE, d] under ``enc_frames``."""
        fam, d = self.jcfg.family, self.jcfg.d_model
        if fam == "vlm":
            return {"prefix_embed": np.random.default_rng(17).normal(
                0, 1, (B, self.jcfg.n_patches, d)).astype(np.float32)}
        if fam == "encdec":
            return {"enc_frames": np.random.default_rng(19).normal(
                0, 1, (B, TE, d)).astype(np.float32)}
        return {}

    def frames(self, B):
        """The decode steps' keyword arguments, as numpy: the enc-dec
        family's frames, else none."""
        pe = self.prefix(B)
        return {k: v for k, v in pe.items() if k == "enc_frames"}

    def jdecode(self, toks, jcache):
        """One reference decode step on numpy tokens [B, 1]."""
        kw = {k: jnp.asarray(v, self.jcfg.dtype)
              for k, v in self.frames(toks.shape[0]).items()}
        return self.jdec(self.params, jnp.asarray(toks), jcache, **kw)

    def decode(self, toks, cache):
        """One port decode step on numpy tokens [B, 1]."""
        kw = {k: torch.from_numpy(v)
              for k, v in self.frames(toks.shape[0]).items()}
        return self.model.decode_step(torch.from_numpy(toks), cache, **kw)

    def both(self, toks):
        """Logits and aux of the reference and of the port on ``toks``
        (with the VLM's prefix)."""
        pe = self.prefix(toks.shape[0])
        want, waux = self.jfwd(self.params, jnp.asarray(toks),
                               **{k: jnp.asarray(v, self.jcfg.dtype)
                                  for k, v in pe.items()})
        got, aux = self.model(torch.from_numpy(toks), with_aux=True,
                              **{k: torch.from_numpy(v)
                                 for k, v in pe.items()})
        return want, waux, got, aux


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.mark.parametrize("S", [16, 24])   # rwkv: chunked / per-token path
def test_forward_matches_reference(pair, S):
    toks = _tok(pair.jcfg, 2, S, seed=S)
    want, waux, got, aux = pair.both(toks)
    assert got.shape == (2, pair.tcfg.n_patches + S, pair.tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5, atol=0)
    assert (float(aux) > 0) == (pair.tcfg.moe is not None)


def test_decode_from_carried_cache_matches_reference(pair):
    """5 reference decode steps, then the cache crosses to the port and
    both sides take 8 more steps."""
    toks = _tok(pair.jcfg, 2, 13, seed=3)
    jcache = JLM.init_cache(pair.jcfg, 2, 32)
    for i in range(5):
        _, jcache = pair.jdecode(toks[:, i:i + 1], jcache)
    cache = convert.cache_from_jax(pair.tcfg, jax.tree.map(np.asarray, jcache),
                                   device="cpu")
    assert cache["len"] == 5
    for i in range(5, 13):
        want, jcache = pair.jdecode(toks[:, i:i + 1], jcache)
        got, cache = pair.decode(toks[:, i:i + 1], cache)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert cache["len"] == int(jcache["len"]) == 13
    carried = convert.cache_from_jax(pair.tcfg,
                                     jax.tree.map(np.asarray, jcache),
                                     device="cpu")
    for mine, theirs in zip(cache["layers"], carried["layers"]):
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_prefill_step_matches_reference(pair):
    toks = _tok(pair.jcfg, 2, 32, seed=7)
    pe = pair.prefix(2)
    want = JSTEP.make_prefill_step(pair.jcfg, 64)(
        pair.params, {"tokens": jnp.asarray(toks),
                      **{k: jnp.asarray(v) for k, v in pe.items()}})
    got = TSTEP.make_prefill_step(pair.model, 64)(
        {"tokens": torch.from_numpy(toks),
         **{k: torch.from_numpy(v) for k, v in pe.items()}})
    assert got.shape == (2, 1, pair.tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_serve_step_matches_reference(pair):
    toks = _tok(pair.jcfg, 3, 4, seed=9)
    jstep = jax.jit(JSTEP.make_serve_step(pair.jcfg))
    tstep = TSTEP.make_serve_step(pair.model)
    jcache = JLM.init_cache(pair.jcfg, 3, 8)
    cache = pair.model.init_cache(3, 8)
    fr = pair.frames(3)
    for i in range(4):
        want, jcache = jstep(pair.params, jcache,
                             {"tokens": jnp.asarray(toks[:, i:i + 1]),
                              **{k: jnp.asarray(v) for k, v in fr.items()}})
        got, cache = tstep(cache, {"tokens": torch.from_numpy(toks[:, i:i + 1]),
                                   **{k: torch.from_numpy(v)
                                      for k, v in fr.items()}})
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


NEAR_TIE = 5e-3


def _moe_inputs(model) -> dict:
    """Forward pre-hooks on the model's MoE layers: the returned dict
    holds, by layer, each one's input of its latest call."""
    seen = {}
    for i, blk in enumerate(model.blocks):
        if getattr(blk, "moe", None) is not None:
            blk.moe.register_forward_pre_hook(
                lambda m, args, i=i: seen.__setitem__(i, args[0]))
    return seen


def _before_near_tie(model, seen, T):
    """How many tokens, in the dispatch's token order, precede the first
    one whose k-th and (k+1)-th router probabilities lie within
    ``NEAR_TIE`` in some MoE layer of the model's last call (``seen``
    holds the layers' inputs; ``T`` when none does, or the model has no
    MoE).  In bf16 the two frameworks round the residual stream at other
    places, which may swap such a near tie; that changes the token's
    experts, the capacity left to every later token, and (through
    attention) later positions.  Tokens before it are routed alike on
    both sides."""
    first = T
    for i, x in seen.items():
        moe = model.blocks[i].moe
        k = moe.me.top_k
        probs = TMOE.route(x.reshape(-1, x.shape[-1]), moe.router)
        p = torch.sort(probs, dim=-1, descending=True).values
        near = torch.nonzero(p[:, k - 1] - p[:, k] < NEAR_TIE)
        if len(near):
            first = min(first, int(near[0, 0]))
    return first


# token seeds whose routing keeps clear of near ties for at least half
# the forward's 32 positions and half the decode steps: seed 1, the other
# archs', meets one at DeepSeek-MoE's forward token 6 and Mixtral's 5;
# seeds 7 and 5 first at tokens 26 and 25; Jamba meets one at token 4
# with seed 1 and none with seed 22 (forward or 4 decode steps)
BF16_SEEDS = {"deepseek_moe_16b": 7, "mixtral_8x7b": 5,
              "jamba_1_5_large": 22}


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "rwkv6_7b",
                                  "deepseek_moe_16b", "mixtral_8x7b",
                                  "llava_next_34b", "jamba_1_5_large",
                                  "whisper_small"])
def test_bf16_forward_and_decode(arch):
    """bf16 within 5e-2; for the MoE archs over the tokens before the
    first near tie of the routing (``_before_near_tie``): the forward's
    positions in token order, then each decode step's rows until one
    holds a near tie.  At least half the forward's positions and half
    the decode steps are compared (``BF16_SEEDS``)."""
    p = Pair(arch, bf16=True)
    seen = _moe_inputs(p.model)
    toks = _tok(p.jcfg, 2, 16, seed=BF16_SEEDS.get(arch, 1))
    want, _, got, _ = p.both(toks)
    assert got.dtype == torch.bfloat16
    V = got.shape[-1]
    T = got.shape[0] * got.shape[1]
    n = _before_near_tie(p.model, seen, T)
    assert n >= T // 2, (n, T)
    np.testing.assert_allclose(got.float().numpy().reshape(-1, V)[:n],
                               _np(want).reshape(-1, V)[:n], rtol=5e-2,
                               atol=5e-2)
    jcache = JLM.init_cache(p.jcfg, 2, 8)
    cache = p.model.init_cache(2, 8)
    steps = 4
    for i in range(steps):
        want, jcache = p.jdecode(toks[:, i:i + 1], jcache)
        got, cache = p.decode(toks[:, i:i + 1], cache)
        n = _before_near_tie(p.model, seen, 2)
        np.testing.assert_allclose(got.float().numpy()[:n], _np(want)[:n],
                                   rtol=5e-2, atol=5e-2)
        if n < 2:
            break
    assert i + (n == 2) >= steps // 2, (i, n)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_decode_dropless(arch):
    """With a dropless capacity factor (as ``tests/test_models.py`` sets
    it: capacity drops legitimately differ between T tokens routed
    together and one), the port's forward logits equal its step-by-step
    decode logits at every position, and both equal the reference's."""
    p = Pair(arch, dropless=True)
    toks = _tok(p.jcfg, 2, 12, seed=21)
    want, _, full, _ = p.both(toks)
    np.testing.assert_allclose(full.numpy(), _np(want), rtol=TOL, atol=TOL)
    cache = p.model.init_cache(2, 12)
    for i in range(12):
        lg, cache = p.decode(toks[:, i:i + 1], cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=str(i))


def test_vlm_prefix_through_the_cache_matches_forward():
    """LLaVA: the prefix rows through ``decode_embeds``, then the tokens
    through ``decode_step``, give the forward's logits at every
    position."""
    p = Pair("llava_next_34b")
    toks = _tok(p.jcfg, 2, 6, seed=23)
    pe = p.prefix(2)["prefix_embed"]
    _, _, full, _ = p.both(toks)
    Np = p.tcfg.n_patches
    cache = p.model.init_cache(2, Np + 6)
    steps = [p.model.decode_embeds(torch.from_numpy(pe[:, i:i + 1]), cache)[0]
             for i in range(Np)]
    steps += [p.model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                  cache)[0] for i in range(6)]
    got = torch.cat(steps, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL, atol=TOL)


def test_mixtral_decode_past_its_window_matches_reference():
    """Reduced Mixtral has a 64-token sliding window: 80 decode steps on
    both sides, the last 16 with keys cut by the window."""
    p = Pair("mixtral_8x7b")
    assert p.tcfg.sliding_window == 64
    toks = _tok(p.jcfg, 2, 80, seed=29)
    jcache = JLM.init_cache(p.jcfg, 2, 80)
    cache = p.model.init_cache(2, 80)
    for i in range(80):
        want, jcache = p.jdec(p.params, jnp.asarray(toks[:, i:i + 1]), jcache)
        got, cache = p.model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                         cache)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_every_config_builds(arch):
    """Every config of the registry builds an ``LM`` (reduced, f32) whose
    parameter count is the reference's ``init_params``'s."""
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=torch.float32)
    model = TLM.LM(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_config_registry_matches_reference(arch):
    assert TC.ARCHS == JC.ARCHS and TC.SHAPES == JC.SHAPES
    assert TC.arch_shapes(arch) == JC.arch_shapes(arch)
    for get in ("get_config", "get_reduced"):
        j, t = getattr(JC, get)(arch), getattr(TC, get)(arch)
        fj, ft = dataclasses.asdict(j), dataclasses.asdict(t)
        assert fj.pop("dtype") == jnp.bfloat16
        assert ft.pop("dtype") == torch.bfloat16
        assert fj == ft
        assert (j.param_count(), j.active_param_count(), j.vocab_padded) == \
            (t.param_count(), t.active_param_count(), t.vocab_padded)
        assert JLM.block_kinds(j) == TLM.block_kinds(t)


@pytest.mark.parametrize("d_head,theta", [(32, 1e4), (128, 1e4), (64, 5e5)])
def test_rope_tables_equal(d_head, theta):
    jc, js = JCOM.init_rope(d_head, 4096, theta)
    tc, ts = TCOM.init_rope(d_head, 4096, theta, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rms_norm_and_rope_apply_match():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (2, 7, 4, 32)).astype(np.float32)
    scale = rng.normal(1, 0.1, 32).astype(np.float32)
    np.testing.assert_allclose(
        TCOM.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JCOM.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    pos = np.tile(np.arange(3, 10), (2, 1))
    jc, js = JCOM.init_rope(32, 64)
    tc, ts = TCOM.init_rope(32, 64, device="cpu")
    np.testing.assert_allclose(
        TCOM.apply_rope(torch.from_numpy(x), tc, ts,
                        torch.from_numpy(pos)).numpy(),
        np.asarray(JCOM.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))),
        rtol=1e-6, atol=1e-6)


def test_bf16_arrays_cross_by_their_bits():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3, 65504.0], jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    t = convert.to_tensor(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_lm_defaults_to_the_card():
    cfg = TC.get_reduced("rwkv6_7b")
    if torch.cuda.is_available():
        assert TLM.LM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLM.LM(cfg)


def test_kv_cache_overflow_raises():
    cfg = dataclasses.replace(TC.get_reduced("phi3_medium_14b"),
                              dtype=torch.float32)
    model = TLM.LM(cfg, device="cpu", generator=torch.Generator()
                   .manual_seed(0))
    cache = model.init_cache(1, 2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(2):
        model.decode_step(tok, cache)
    with pytest.raises(ValueError, match="KV cache full"):
        model.decode_step(tok, cache)
