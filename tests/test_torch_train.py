"""The port's training path (``repro_torch.train``) against the JAX
reference's (``repro.train``) on the CPU.

Weights come from ``repro.models.lm.init_params`` and cross into the port
through ``convert.from_jax_params``; tokens, labels and patch embeddings
from numpy.  Attention runs ``ops.flash_attention``'s plain version,
differentiated by autograd (the analogue of interpret mode).

Tolerances, each with its reason:

* loss and gradients 1e-4 relative to each tensor's largest entry (they
  agree to ~2e-6: the sums run in another order; f32 throughout);
* the optimizer on identical inputs 1e-6 (XLA may fuse a multiply and an
  add into one fma where torch rounds twice);
* after a train step, parameters, moments and metrics 1e-4, relative to
  each tensor's largest entry, except that
  Adam's first step moves an element by about ``lr * sign(g)``: where the
  gradient the step takes (with microbatches the mean of its shards')
  is within 1e-5 of zero but not 0 (relative to its tensor's largest;
  the two frameworks' gradients differ by ~1e-6 of it, so near
  zero their signs may differ) or, with int8 compression, the two
  gradients straddle a rounding boundary, the element may move by up to
  2 x lr.  Such elements are found (:func:`_near_zero`, :func:`_flips`),
  counted (at most 1 in 1,000) and bounded apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.data.pipeline import DataCfg, TokenStream  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import optim as TOPT  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

TOL = 1e-4
LR = 3e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1e-30, np.abs(b).max()))


def _cfgs(arch):
    return (dataclasses.replace(JC.get_reduced(arch), dtype=jnp.float32),
            dataclasses.replace(TC.get_reduced(arch), dtype=torch.float32))


def _pair(arch):
    jcfg, tcfg = _cfgs(arch)
    params = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, tcfg, params, model


def _batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, 3] = -1                   # a masked position
    if cfg.family == "vlm":
        batch["prefix_embed"] = rng.normal(
            0, 0.02, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _tree_close(got, want, tol=TOL, skip=None):
    """Every leaf of the reference tree ``want`` against ``got`` (the
    port's, in the reference layout), relative to the leaf's largest
    entry; ``skip`` masks (same layout) exempt elements."""
    errs = jax.tree.map(
        lambda a, b, *m: float(
            np.abs(np.where(m[0], 0, a - b) if m else a - b).max()
            / max(1e-30, np.abs(b).max())),
        got, jax.tree.map(np.asarray, want), *([skip] if skip else []))
    worst = max(jax.tree.leaves(errs))
    assert worst <= tol, errs


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("kind", ["wsd", "cosine"])
def test_schedules_equal_reference(kind):
    steps = np.arange(0, 1001, dtype=np.int32)
    if kind == "wsd":
        kw = dict(peak_lr=3e-4, warmup=50, stable=800, decay=150)
        jf, tf = JOPT.wsd_schedule, TOPT.wsd_schedule
    else:
        kw = dict(peak_lr=3e-4, warmup=50, total=1000)
        jf, tf = JOPT.cosine_schedule, TOPT.cosine_schedule
    want = np.asarray(jax.jit(jax.vmap(lambda s: jf(s, **kw)))(steps))
    got = tf(torch.from_numpy(steps), **kw).numpy()
    # the division by a constant is the jitted reference's multiply by
    # its reciprocal (optim.recip); cos may differ by an ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] > 0 and got.dtype == np.float32


def test_adamw_converges_quadratic():
    params = {"x": torch.tensor([4.0, -3.0])}
    opt = TOPT.adamw_init(params)
    for _ in range(300):
        grads = {"x": 2 * params["x"]}
        params, opt, _ = TOPT.adamw_update(params, grads, opt, lr=0.05,
                                           weight_decay=0.0)
    assert float(params["x"].abs().max()) < 0.05
    assert int(opt.step) == 300


def test_int8_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=256)
                         .astype(np.float32))
    err = {"w": torch.zeros(256)}
    total = torch.zeros(256)
    for _ in range(4):
        deq, err = TOPT.compress_int8({"w": g.clone()}, err)
        total += deq["w"]
    # accumulated dequantized grads + final error == accumulated true grads
    np.testing.assert_allclose((4 * g - total).numpy(), err["w"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("compression", [False, True])
def test_adamw_update_matches_reference(compression):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (33,), "c": (4, 4, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = JOPT.adamw_init(jp, compression=compression)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = TOPT.adamw_init(tp, compression=compression)
    upd = jax.jit(JOPT.adamw_update)
    for i in range(3):
        grads = {k: rng.normal(0, 0.5, s).astype(np.float32)
                 for k, s in shapes.items()}
        lr = np.float32(1e-2 * (i + 1))
        jp, jo, jn = upd(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                         jo, lr)
        # copies: the update scales its gradients in place, and JAX may
        # still be reading the numpy buffers it was handed
        tp, to, tn = TOPT.adamw_update(
            tp, {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
            to, torch.tensor(lr))
        assert int(to.step) == int(jo.step) == i + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for name, (mine, theirs) in {"p": (tp, jp), "m": (to.m, jo.m),
                                     "v": (to.v, jo.v),
                                     "err": (to.err, jo.err)}.items():
            if theirs is None:
                assert mine is None
                continue
            for k in shapes:
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{name} {k}")


# ----------------------------------------------------------------- loss
def test_xent_loss_masks_labels_and_padded_vocab():
    rng = np.random.default_rng(3)
    V, real = 24, 19
    logits = rng.normal(0, 2, (2, 5, V)).astype(np.float32)
    labels = rng.integers(0, real, (2, 5)).astype(np.int32)
    labels[1, 2] = -1
    labels[0, 0] = -7
    f = lambda x: JSTEP.xent_loss(x, jnp.asarray(labels), real)  # noqa: E731
    want, jgrad = jax.value_and_grad(f)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = TSTEP.xent_loss(t, torch.from_numpy(labels), real)
    (grad,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    assert float(grad[..., real:].abs().max()) == 0.0    # padded vocab
    assert float(grad[1, 2].abs().max()) == 0.0          # masked labels
    # every label masked: the count floors at 1 and the loss is 0
    none = TSTEP.xent_loss(torch.from_numpy(logits),
                           torch.full((2, 5), -1), real)
    assert float(none) == 0.0


LOSS_ARCHS = ["minicpm_2b", "phi3_medium_14b", "qwen2_5_32b",
              "llava_next_34b"]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """MiniCPM (MHA), Phi-3 (GQA), Qwen (qkv bias), LLaVA (prefix)."""
    jcfg, tcfg, params, model = _pair(arch)
    batch = _batch(jcfg)
    jl = JSTEP.make_loss_fn(jcfg, remat=remat)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        params, _jb(batch))
    model.requires_grad_(True)
    loss, m = TSTEP.make_loss_fn(tcfg, remat=remat)(model, _tb(batch))
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _rel(float(loss.detach()), float(jloss)) <= TOL
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    _tree_close(convert.to_numpy_tree(model, dict(zip(named, grads))), jg)


def test_unported_families_raise():
    """Every family of the reference trains (the hybrid since
    ``tests/test_torch_train_hybrid.py``), so none is left to raise but a
    family the reference does not have."""
    assert TSTEP.UNTRAINABLE == {}
    for arch in ("jamba_1_5_large", "minicpm_2b"):
        TSTEP.make_loss_fn(TC.get_reduced(arch))
        TSTEP.make_train_step(TC.get_reduced(arch))
    cfg = dataclasses.replace(TC.get_reduced("minicpm_2b"), family="other")
    with pytest.raises(NotImplementedError, match="unknown family"):
        TSTEP.make_loss_fn(cfg)
    with pytest.raises(NotImplementedError, match="unknown family"):
        TSTEP.make_train_step(cfg)


# ----------------------------------------------------------- train step
def _flips(err, err_ref):
    """Masks (reference layout) of the elements whose int8-compressed
    gradient differs between the port and the reference: their error
    buffers differ by a whole quantum ``q`` (estimated per tensor as
    twice the reference's largest error).  Each must sit on a rounding
    boundary, its error within 1e-3 of half a quantum."""
    def one(a, b):
        q = 2 * float(np.abs(b).max())
        if q == 0.0:
            return np.zeros(b.shape, bool)
        flip = np.abs(a - b) > 0.5 * q
        assert np.all(np.abs(np.abs(b[flip]) / q - 0.5) < 1e-3)
        return flip
    return jax.tree.map(one, err, jax.tree.map(np.asarray, err_ref))


def _step_grads(jcfg, params, batch, microbatch):
    """The gradient the reference's train step takes: the batch's, or
    with microbatches the mean of its row shards' (its scan sums them).
    A shard's loss is normalized by its own token count, so the two can
    differ by far more than the frameworks do."""
    f = jax.jit(jax.grad(lambda p, b: JSTEP.make_loss_fn(jcfg)(p, b)[0]))
    n = max(microbatch, 1)
    rows = len(batch["tokens"]) // n
    gs = [f(params, _jb({k: v[i * rows:(i + 1) * rows]
                         for k, v in batch.items()})) for i in range(n)]
    return jax.tree.map(lambda *g: sum(np.asarray(x, np.float64)
                                       for x in g) / n, *gs)


def _near_zero(grads):
    """Masks (reference layout) of the gradient elements within 1e-5 of
    zero, relative to their tensor's largest, but not 0 (an embedding
    row no token reads has no gradient on either side)."""
    def one(g):
        a = np.abs(np.asarray(g))
        return (a <= 1e-5 * a.max()) & (a > 0)
    return jax.tree.map(one, grads)


STEP_CASES = [("cosine", 0, False), ("wsd", 0, False), ("cosine", 2, False),
              ("wsd", 2, True), ("cosine", 0, True)]


@pytest.mark.parametrize("schedule,microbatch,compression", STEP_CASES)
def test_train_step_matches_reference(schedule, microbatch, compression):
    """One step from the same weights and batch: loss, gnorm, lr, the
    parameters, ``m`` and ``v``."""
    jcfg, tcfg, params, model = _pair("minicpm_2b")
    batch = _batch(jcfg, B=4, S=16, seed=2)
    jg = _step_grads(jcfg, params, batch, microbatch)
    kw = dict(schedule=schedule, warmup=2, total=20, microbatch=microbatch)
    params, jo, jm = jax.jit(JSTEP.make_train_step(jcfg, **kw))(
        params, JOPT.adamw_init(params, compression=compression), _jb(batch))
    model, to, tm = TSTEP.make_train_step(tcfg, **kw)(
        model, TOPT.adamw_init(dict(model.named_parameters()),
                               compression=compression), _tb(batch))
    for k in ("loss", "gnorm", "lr"):
        assert _rel(float(tm[k]), float(jm[k])) <= TOL, k
    assert int(to.step) == int(jo.step) == 1
    skip = _near_zero(jg)
    if compression:
        skip = jax.tree.map(np.logical_or, skip, _flips(
            convert.to_numpy_tree(model, to.err), jo.err))
    n = sum(int(s.sum()) for s in jax.tree.leaves(skip))
    total = sum(s.size for s in jax.tree.leaves(skip))
    assert n <= total / 1000, (n, total)
    mine = convert.to_numpy_tree(model)
    _tree_close(mine, params, skip=skip)
    if n:                         # a flipped element moves <= 2 lr
        gaps = jax.tree.leaves(jax.tree.map(
            lambda a, b: np.abs(a - np.asarray(b)), mine, params))
        assert max(float(g[s].max(initial=0))
                   for g, s in zip(gaps, jax.tree.leaves(skip))) <= \
            2 * LR + TOL
    _tree_close(convert.to_numpy_tree(model, to.m), jo.m, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.v), jo.v, skip=skip)


def test_train_step_from_a_carried_state_matches_reference():
    """A reference step's parameters and AdamW state (moments, step count,
    int8 error buffers) carried into the port (``from_jax_params``,
    ``opt_from_jax``), then one more step on both sides."""
    jcfg, tcfg, params, _ = _pair("minicpm_2b")
    kw = dict(schedule="cosine", warmup=2, total=20)
    jstep = jax.jit(JSTEP.make_train_step(jcfg, **kw))
    params, jo, _ = jstep(params, JOPT.adamw_init(params, compression=True),
                          _jb(_batch(jcfg, B=4, S=16, seed=3)))
    host = jax.tree.map(np.asarray, (params, jo))
    model = convert.from_jax_params(tcfg, host[0], device="cpu")
    to = convert.opt_from_jax(tcfg, host[1], model)
    assert int(to.step) == 1 and to.err is not None
    _tree_close(convert.to_numpy_tree(model, to.err), jo.err, tol=0)
    batch = _batch(jcfg, B=4, S=16, seed=4)
    jg = _step_grads(jcfg, params, batch, 0)
    params, jo, jm = jstep(params, jo, _jb(batch))
    model, to, tm = TSTEP.make_train_step(tcfg, **kw)(model, to, _tb(batch))
    for k in ("loss", "gnorm", "lr"):
        assert _rel(float(tm[k]), float(jm[k])) <= TOL, k
    skip = jax.tree.map(np.logical_or, _near_zero(jg), _flips(
        convert.to_numpy_tree(model, to.err), jo.err))
    assert sum(int(s.sum()) for s in jax.tree.leaves(skip)) <= \
        sum(s.size for s in jax.tree.leaves(skip)) / 1000
    _tree_close(convert.to_numpy_tree(model), params, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.m), jo.m, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.v), jo.v, skip=skip)


def test_loss_curve_on_token_stream_matches_reference():
    """Five WSD steps on the data pipeline's batches from the same
    weights: the losses agree within 2e-4 (tests/test_train.py's bound
    for a resumed run)."""
    jcfg, tcfg, params, model = _pair("minicpm_2b")
    data = TokenStream(DataCfg(vocab=jcfg.vocab, seq_len=16, global_batch=4,
                               seed=7))
    kw = dict(schedule="wsd", warmup=1, total=5)
    jstep = jax.jit(JSTEP.make_train_step(jcfg, **kw))
    tstep = TSTEP.make_train_step(tcfg, **kw)
    jo = JOPT.adamw_init(params)
    to = TOPT.adamw_init(dict(model.named_parameters()))
    want, got = [], []
    for s in range(5):
        b = data.batch(s)
        params, jo, jm = jstep(params, jo, _jb(b))
        model, to, tm = tstep(model, to, _tb(b))
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got[-1] < got[0]
