"""Training of the enc-dec (Whisper-small), MoE (DeepSeek-MoE-16B) and
RWKV (RWKV-6-7B) families in the port against the JAX reference, on the
CPU, at the reduced configs in f32.

Weights come from ``repro.models.lm.init_params`` and cross into the
port through ``convert.from_jax_params``; tokens, labels and frame
embeddings from numpy.  Attention and the chunked RWKV-6 time mix run
their kernels' plain versions, differentiated by autograd (the analogue
of interpret mode).  Tolerances and the near-zero-gradient rule of a
train step are ``tests/test_torch_train.py``'s (1e-4 of each tensor's
largest entry; f32 throughout, only summation orders differ).

The RWKV-6 backward's plain version
(``ref.rwkv6_chunked_backward_reference``, the formula of the backward
kernel) is held against autograd of the plain forward within 1e-5 of
each gradient's largest entry: the two sum the same f32 terms in other
orders.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.train import optim as TOPT  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402
from test_torch_train import (LR, TOL, _jb, _near_zero, _rel,  # noqa: E402
                              _tb, _tree_close)

ARCHS = ["deepseek_moe_16b", "whisper_small", "rwkv6_7b"]
KW = dict(schedule="cosine", warmup=2, total=20)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The f32 reduced configs and the reference's parameters (numpy)."""
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=torch.float32)
    params = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def _pair(arch):
    jcfg, tcfg, host = _reference(arch)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            convert.from_jax_params(tcfg, host, device="cpu"))


def _batch(cfg, B=4, S=16, seed=1):
    """Tokens, labels (one masked) and, for the enc-dec family, frame
    embeddings [B, 12, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, 3] = -1
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.normal(
            0, 1, (B, 12, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference_grads(arch, B=4, S=16, seed=1):
    """The reference's loss, aux and gradient tree on ``_batch``'s batch,
    its blocks under ``jax.checkpoint`` as its train step runs them
    (remat recomputes the same f32 ops, so the values are those without
    it; the port's remat on and off and the train step's test are held
    against this one compile)."""
    jcfg, _, host = _reference(arch)
    jl = JSTEP.make_loss_fn(jcfg, remat=True)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jax.tree.map(jnp.asarray, host), _jb(_batch(jcfg, B, S, seed)))
    return float(jloss), float(jm["aux"]), jax.tree.map(np.asarray, jg)


def _loss_and_grads(arch, remat, B=4, S=16, seed=1):
    """The port's loss, aux and every gradient against the reference's;
    returns the reference's aux."""
    _, tcfg, _, model = _pair(arch)
    jloss, jaux, jg = _reference_grads(arch, B, S, seed)
    model.requires_grad_(True)
    loss, m = TSTEP.make_loss_fn(tcfg, remat=remat)(
        model, _tb(_batch(tcfg, B, S, seed)))
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _rel(float(loss.detach()), jloss) <= TOL
    assert _rel(float(m["aux"].detach()), jaux) <= TOL
    _tree_close(convert.to_numpy_tree(model, dict(zip(named, grads))), jg)
    return jaux


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """The loss (with the MoE's aux at weight 0.01) and the gradient of
    every parameter: the router in f32 through the kept gates and the
    aux loss, the experts' w_gate / w_up / w_down, the encoder's blocks
    and final norm, RWKV's time mix (decay LoRA, bonus, the row sums of
    wo) and channel mix."""
    aux = _loss_and_grads(arch, remat)
    assert (aux > 0) == (_reference(arch)[0].family == "moe")


def test_moe_dispatch_drops_rows_in_the_gradient_test():
    """The batch of the MoE gradient test overflows some expert, so rows
    routed to the drop row take part in that test; the integers the
    dispatch gives under autograd equal those without it."""
    jcfg, tcfg, _, model = _pair("deepseek_moe_16b")
    seen = {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda mod, args, i=i: seen.__setitem__(i, args[0]))
        for i, blk in enumerate(model.blocks)]
    model.requires_grad_(True)
    TSTEP.make_loss_fn(tcfg)(model, _tb(_batch(jcfg)))
    for h in hooks:
        h.remove()
    dropped = 0
    for i, x in seen.items():
        m = model.blocks[i].moe
        me = m.me
        xt = x.reshape(-1, x.shape[-1])
        cap = TMOE.capacity(me.capacity_factor, me.top_k, xt.shape[0],
                            me.n_experts)
        probs = TMOE.route(xt, m.router)
        assert probs.requires_grad
        grad_ints = TMOE.local_dispatch(xt, probs, me.top_k, cap,
                                        me.n_experts)
        with torch.no_grad():
            plain = TMOE.local_dispatch(xt, probs, me.top_k, cap,
                                        me.n_experts)
        for a, b in zip(grad_ints[1:], plain[1:]):
            assert torch.equal(a.detach(), b)
        dropped += int((~grad_ints[2]).sum())
    assert dropped > 0


def moved_apart(mine, want, skip):
    """A near-zero gradient's sign may differ between the frameworks,
    and Adam then moves its element by ~lr the other way: such elements
    (``skip``) are exempt from the 1e-4 comparison.  Here the few of them
    whose parameters did move apart (by more than 1e-4 of lr) are counted,
    at most 1 in 1,000 of all, and bounded by 2 lr.  The count of
    exempt elements itself is no bound here: the RWKV family's reduced
    gradients hold about one near-zero element in 1,000."""
    moved = [np.abs(a - np.asarray(b))[s] for a, b, s in zip(
        jax.tree.leaves(mine), jax.tree.leaves(want),
        jax.tree.leaves(skip))]
    total = sum(s.size for s in jax.tree.leaves(skip))
    assert sum(int((m > TOL * LR).sum()) for m in moved) <= total / 1000
    assert max(float(m.max(initial=0)) for m in moved) <= 2 * LR + TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One train step from the same weights and batch: loss, gnorm, lr,
    the parameters, ``m`` and ``v``."""
    jcfg, tcfg, params, model = _pair(arch)
    batch = _batch(jcfg)
    jg = _reference_grads(arch)[2]
    params, jo, jm = jax.jit(JSTEP.make_train_step(jcfg, **KW))(
        params, JOPT.adamw_init(params), _jb(batch))
    model, to, tm = TSTEP.make_train_step(tcfg, **KW)(
        model, TOPT.adamw_init(dict(model.named_parameters())), _tb(batch))
    for k in ("loss", "gnorm", "lr"):
        assert _rel(float(tm[k]), float(jm[k])) <= TOL, k
    skip = _near_zero(jg)
    mine = convert.to_numpy_tree(model)
    moved_apart(mine, params, skip)
    _tree_close(mine, params, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.m), jo.m, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.v), jo.v, skip=skip)


def test_rwkv_ragged_branch_is_differentiable():
    """S = 37 is no multiple of the chunk: the time mix runs the
    per-token recurrence (``ref.rwkv6_reference``), on both sides; its
    loss and gradients match the reference's."""
    _loss_and_grads("rwkv6_7b", True, B=2, S=37, seed=5)


# ------------------------------------------------ the RWKV-6 backward --
def _rwkv_case(B, S, H, lo, hi, s0, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32)
    r, k, v = (t(rng.normal(0, 0.5, (B, S, H, 64))) for _ in range(3))
    w = t(rng.uniform(lo, hi, (B, S, H, 64)))
    u = t(rng.normal(0, 0.1, (H, 64)))
    wkv0 = t(rng.normal(0, s0, (B, H, 64, 64)))
    dy = t(rng.normal(0, 1, (B, S, H, 64)))
    dfin = t(rng.normal(0, 1, (B, H, 64, 64)))
    return (r, k, v, w, u, wkv0), dy, dfin


# (B, S, H, chunk, w low, w high, wkv0 scale, with d wkv_final)
RWKV_BWD_CASES = {
    "S64 chunk16": (2, 64, 2, 16, 0.7, 0.999, 0.0, False),
    "S128 chunk32": (1, 128, 2, 32, 0.7, 0.999, 0.0, False),
    "S128 chunk16": (2, 128, 1, 16, 0.7, 0.999, 0.0, False),
    "strong decay chunk32": (1, 128, 1, 32, 0.3, 0.6, 0.0, False),
    "strong decay chunk16": (1, 64, 1, 16, 0.3, 0.6, 0.0, True),
    "wkv0 and d wkv_final": (2, 64, 2, 16, 0.7, 0.999, 0.1, True),
}


@pytest.mark.parametrize("case", list(RWKV_BWD_CASES))
def test_rwkv6_backward_reference_matches_autograd(case):
    B, S, H, C, lo, hi, s0, fin = RWKV_BWD_CASES[case]
    ins, dy, dfin = _rwkv_case(B, S, H, lo, hi, s0, seed=len(case))
    leaves = [a.clone().requires_grad_(True) for a in ins]
    y, sf, starts = TREF.rwkv6_chunked_reference(*leaves, chunk=C,
                                                 states=True)
    assert torch.equal(starts[:, :, 0], ins[5])
    loss = (y * dy).sum() + ((sf * dfin).sum() if fin else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ops.rwkv6_chunked_bwd(*ins[:5], starts.detach(), dy,
                                dfin if fin else None, chunk=C)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dwkv0"), got,
                          want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, name


def test_rwkv6_chunked_reference_states_leave_y_unchanged():
    """The chunk-start states come from the same walk: y and the final
    state equal the call without them, and each start state is the
    final state of the walk over the chunks before it."""
    ins, _, _ = _rwkv_case(2, 64, 2, 0.7, 0.999, 0.1, seed=3)
    y, sf, starts = TREF.rwkv6_chunked_reference(*ins, chunk=16, states=True)
    y0, sf0 = TREF.rwkv6_chunked_reference(*ins, chunk=16)
    assert torch.equal(y, y0) and torch.equal(sf, sf0)
    assert starts.shape == (2, 2, 4, 64, 64)
    r, k, v, w, u, wkv0 = ins
    _, s2 = TREF.rwkv6_chunked_reference(r[:, :32], k[:, :32], v[:, :32],
                                         w[:, :32], u, wkv0, chunk=16)
    assert torch.equal(starts[:, :, 2], s2)


def test_rwkv6_backward_zeroes_clamped_decays():
    """w below 1e-30 is clamped in the forward, so it has no gradient."""
    ins, dy, _ = _rwkv_case(1, 32, 1, 0.7, 0.999, 0.0, seed=9)
    w = ins[3].clone()
    w[0, 5, 0, :8] = 1e-35
    ins = ins[:3] + (w,) + ins[4:]
    leaves = [a.clone().requires_grad_(True) for a in ins]
    y, _, starts = TREF.rwkv6_chunked_reference(*leaves, chunk=16,
                                                states=True)
    (dw_auto,) = torch.autograd.grad((y * dy).sum(), [leaves[3]])
    dw = ops.rwkv6_chunked_bwd(*ins[:5], starts.detach(), dy, chunk=16)[3]
    assert float(dw[0, 5, 0, :8].abs().max()) == 0.0
    assert float(dw_auto[0, 5, 0, :8].abs().max()) == 0.0
    assert bool(torch.isfinite(dw).all())


def test_rwkv6_bwd_wrapper_rejects_bad_inputs():
    ins, dy, _ = _rwkv_case(1, 32, 1, 0.7, 0.999, 0.0, seed=4)
    _, _, starts = TREF.rwkv6_chunked_reference(*ins, chunk=16, states=True)
    with pytest.raises(ValueError, match="5-D"):
        ops.rwkv6_chunked_bwd(*ins[:5], starts[:, :, 0], dy)
    with pytest.raises(ValueError, match="states"):
        ops.rwkv6_chunked_bwd(*ins[:5], starts, dy, chunk=8)
    with pytest.raises(ValueError, match="dwkv"):
        ops.rwkv6_chunked_bwd(*ins[:5], starts, dy, torch.zeros(1, 1, 64),
                              chunk=16)


# ------------------------------------------------------------ launcher --
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_reduced(arch):
    """``launch.train.train`` on the reduced config (the enc-dec family
    over the data pipeline's 64 stub frames): finite losses that fall."""
    _, _, losses = TTRAIN.train(arch, steps=6, global_batch=2, seq_len=32,
                                log_every=0, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
