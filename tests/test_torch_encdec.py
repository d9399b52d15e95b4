"""The port's enc-dec family (reduced Whisper-small) vs the JAX reference.

Weights from ``repro.models.lm.init_params`` carried into the port by
``convert.from_jax_params``; frame embeddings [2, 12, d] and [2, 64, d]
and tokens from numpy.  The encoder's output, its non-causal attention,
the decoder's cross-attention (keys from the encoder, Sk != Sq), and the
forward and decode with the frames, in f32 at 1e-4; the port's prefill
against its own step-by-step decode.
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
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

ARCH = "whisper_small"
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype=torch.float32)
    params = JLM.init_params(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _frames(d, Te, seed=11):
    return np.random.default_rng(seed).normal(0, 1, (2, Te, d)) \
        .astype(np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def test_model_holds_the_encoder(pair):
    jcfg, _, params, model = pair
    assert len(model.enc_blocks) == jcfg.n_enc_layers == 2
    assert all(b.kind == "enc" for b in model.enc_blocks)
    assert all(b.kind == "dec" for b in model.blocks)
    assert not hasattr(model.enc_blocks[0], "xattn")
    assert model.blocks[0].xattn.wq.shape == params["blocks"][0]["xattn"][
        "wq"].shape[1:]


@pytest.mark.parametrize("Te", [12, 64])
def test_encoder_output_matches_reference(pair, Te):
    jcfg, _, params, model = pair
    fr = _frames(jcfg.d_model, Te)
    want = JLM._encode(params, jcfg, jnp.asarray(fr))
    got = model._encode(torch.from_numpy(fr))
    assert got.shape == (2, Te, jcfg.d_model)
    _close(got, want)


def _attn_params(params, name, layer):
    tree = params["enc_blocks" if name == "enc" else "blocks"]
    if name != "enc":
        tree = tree[0]
    key = "xattn" if name == "xattn" else "attn"
    return {k: v[layer] for k, v in tree[key].items()}


@pytest.mark.parametrize("Te", [12, 64])
def test_non_causal_attention_matches_reference(pair, Te):
    """An encoder layer's self-attention: every frame sees every frame,
    later ones too (a causal mask would change the first rows)."""
    jcfg, _, params, model = pair
    x = _frames(jcfg.d_model, Te, seed=Te)
    pos = np.tile(np.arange(Te), (2, 1))
    rope = JCOM.init_rope(jcfg.d_head, Te, jcfg.rope_theta)
    want, _ = JCOM.apply_attn(_attn_params(params, "enc", 1), jnp.asarray(x),
                              jcfg, rope, jnp.asarray(pos), causal=False)
    attn = model.enc_blocks[1].attn
    got = attn(torch.from_numpy(x), model.rope, torch.from_numpy(pos),
               causal=False)
    _close(got, want)
    causal = attn(torch.from_numpy(x), model.rope, torch.from_numpy(pos))
    assert float((causal - got).abs()[:, 0].max()) > 1e-2


@pytest.mark.parametrize("Te,Sq", [(12, 5), (64, 24), (64, 1)])
def test_cross_attention_matches_reference(pair, Te, Sq):
    """A decoder layer's cross-attention: q from the block's input, k and
    v from the encoder's output, no RoPE, Sk = Te != Sq."""
    jcfg, _, params, model = pair
    x = _frames(jcfg.d_model, Sq, seed=Sq)[:, :Sq]
    enc = _frames(jcfg.d_model, Te, seed=Te + 1)
    want, _ = JCOM.apply_attn(_attn_params(params, "xattn", 0),
                              jnp.asarray(x), jcfg, None, None, causal=False,
                              xattn_kv=jnp.asarray(enc))
    got = model.blocks[0].xattn(torch.from_numpy(x), None, None,
                                causal=False, xattn_kv=torch.from_numpy(enc))
    assert got.shape == (2, Sq, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("Te", [12, 64])
def test_forward_and_decode_with_frames_match_reference(pair, Te):
    """Forward over 10 tokens, then 6 decode steps (each re-encoding the
    frames, as the reference does) on both sides; the port's decode
    logits also equal its forward's at every position."""
    jcfg, tcfg, params, model = pair
    fr = _frames(jcfg.d_model, Te)
    toks = np.random.default_rng(Te).integers(0, jcfg.vocab, (2, 10)) \
        .astype(np.int32)
    want, _ = JLM.forward(params, jcfg, jnp.asarray(toks), remat=False,
                          enc_frames=jnp.asarray(fr))
    full = model(torch.from_numpy(toks), enc_frames=torch.from_numpy(fr))
    _close(full, want)
    jstep = jax.jit(lambda p, t, c, f: JLM.decode_step(p, jcfg, t, c,
                                                       enc_frames=f))
    jcache = JLM.init_cache(jcfg, 2, 16)
    cache = model.init_cache(2, 16)
    for i in range(6):
        w, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.asarray(fr))
        g, cache = model.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                     cache, enc_frames=torch.from_numpy(fr))
        _close(g, w, msg=str(i))
        _close(g[:, 0], full[:, i], msg=str(i))


def test_steps_carry_the_frames(pair):
    jcfg, _, params, model = pair
    fr = _frames(jcfg.d_model, 64)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 8)) \
        .astype(np.int32)
    want = JSTEP.make_prefill_step(jcfg, 16)(
        params, {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(fr)})
    got = TSTEP.make_prefill_step(model, 16)(
        {"tokens": torch.from_numpy(toks), "enc_frames": torch.from_numpy(fr)})
    assert got.shape == (2, 1, jcfg.vocab_padded)
    _close(got, want)
    jserve = JSTEP.make_serve_step(jcfg)
    tserve = TSTEP.make_serve_step(model)
    jcache, cache = JLM.init_cache(jcfg, 2, 8), model.init_cache(2, 8)
    for i in range(3):
        w, jcache = jserve(params, jcache,
                           {"tokens": jnp.asarray(toks[:, i:i + 1]),
                            "enc_frames": jnp.asarray(fr)})
        g, cache = tserve(cache, {"tokens": torch.from_numpy(toks[:, i:i + 1]),
                                  "enc_frames": torch.from_numpy(fr)})
        _close(g, w, msg=str(i))


def test_encdec_without_frames_raises(pair):
    model = pair[3]
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="needs enc_frames"):
        model(toks)
    with pytest.raises(ValueError, match="needs enc_frames"):
        model.decode_step(toks[:, :1], model.init_cache(1, 4))
