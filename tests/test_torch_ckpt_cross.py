"""Training checkpoints across the packages, on the CPU: the reference's
``CheckpointManager.save`` read by the port's ``restore``, and the
port's ``save`` read by the reference's ``restore``.

The state is a reduced MiniCPM-2B after one train step with int8
compression: bf16 weights, f32 norms, f32 AdamW moments, error buffers
and the int32 step count.  Every leaf must come back bit for bit.  Both
checkpoints hold the reference's stacked layout (49 leaves here: 12
parameters, their ``m``, ``v`` and ``err``, the step), which the port
unstacks into its 85 named leaves (21 parameters a tree).  Then each
side takes one more train step, the one from the restored state; in the
f32 config (all parameters f32) the two steps agree within
``tests/test_torch_train.py``'s limits.  In the bf16 config only the bits
are compared: those limits are stated for f32.

The same both ways for a reduced DeepSeek-MoE-16B (its experts stacked
[E, d, f] in each layer's leaves) and a reduced Whisper-small (its
encoder's blocks stacked as one tree, ``enc_blocks``) and a reduced
RWKV-6-7B (its ``tmix`` / ``cmix`` subtrees), in f32, each followed by
one more step on each side.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.ckpt import manager as M  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import optim as TOPT  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402
from test_torch_train import (TOL, _batch, _flips, _jb, _near_zero,  # noqa: E402
                              _rel, _step_grads, _tb, _tree_close)
import test_torch_train_families as TF  # noqa: E402

REF_LEAVES, PORT_LEAVES = 49, 85
KW = dict(schedule="cosine", warmup=2, total=20)


def _cfgs(dtype):
    jcfg, tcfg = JC.get_reduced("minicpm_2b"), TC.get_reduced("minicpm_2b")
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _reference_state(jcfg):
    """The reference's parameters and AdamW state after one compressed
    step, and its jitted step."""
    jstep = jax.jit(JSTEP.make_train_step(jcfg, **KW))
    params = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    params, jo, _ = jstep(params, JOPT.adamw_init(params, compression=True),
                          _jb(_batch(jcfg, B=4, S=16, seed=3)))
    return params, jo, jstep


def _fresh(tcfg, seed):
    """A port model and AdamW state that hold none of the state."""
    model = LM(tcfg, device="cpu",
               generator=torch.Generator().manual_seed(seed))
    return model, TOPT.adamw_init(dict(model.named_parameters()),
                                  compression=True)


def _same_bits(model, opt, params, jo, tcfg):
    """The port's state equals the reference's (numpy trees), leaf for
    leaf, bit for bit."""
    host = jax.tree.map(np.asarray, (params, jo))
    own = dict(model.named_parameters())
    trees = [(own, host[0])] + [(getattr(opt, f), getattr(host[1], f))
                                for f in ("m", "v", "err")]
    for mine, theirs in trees:
        want = convert._port_names(tcfg, theirs)
        assert want.keys() == mine.keys()
        for n, t in mine.items():
            w = convert.to_tensor(want[n], device="cpu")
            assert t.dtype == w.dtype and torch.equal(t.detach(), w), n
    assert opt.step.dtype == torch.int32
    assert int(opt.step) == int(host[1].step)


def _steps_agree(jcfg, tcfg, params, jo, jstep, model, opt, batch=None):
    """One more train step on each side from the same state (on
    ``batch``, by default a MiniCPM batch): loss, gnorm
    and lr within 1e-4, parameters and moments within 1e-4 of each
    tensor's largest entry but for near-zero gradients and int8 boundary
    flips (``tests/test_torch_train.py``: at most 1 in 1,000 such
    elements; with ``batch`` given, a family's, the 1 in 1,000 bounds
    those that moved apart and 2 lr their gap,
    ``test_torch_train_families.moved_apart``)."""
    family = batch is not None
    if not family:
        batch = _batch(jcfg, B=4, S=16, seed=4)
    before = int(opt.step)
    jg = _step_grads(jcfg, params, batch, 0)
    params, jo, jm = jstep(params, jo, _jb(batch))
    model, opt, tm = TSTEP.make_train_step(tcfg, **KW)(model, opt, _tb(batch))
    for k in ("loss", "gnorm", "lr"):
        assert _rel(float(tm[k]), float(jm[k])) <= TOL, k
    assert int(opt.step) == int(jo.step) == before + 1
    skip = jax.tree.map(np.logical_or, _near_zero(jg), _flips(
        convert.to_numpy_tree(model, opt.err), jo.err))
    if family:
        TF.moved_apart(convert.to_numpy_tree(model), params, skip)
    else:
        assert sum(int(s.sum()) for s in jax.tree.leaves(skip)) <= \
            sum(s.size for s in jax.tree.leaves(skip)) / 1000
    _tree_close(convert.to_numpy_tree(model), params, skip=skip)
    _tree_close(convert.to_numpy_tree(model, opt.m), jo.m, skip=skip)
    _tree_close(convert.to_numpy_tree(model, opt.v), jo.v, skip=skip)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    jcfg, tcfg = _cfgs(dtype)
    params, jo, jstep = _reference_state(jcfg)
    JCheckpointManager(str(tmp_path), async_write=False).save(1, (params, jo))
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    assert meta["n_leaves"] == REF_LEAVES and "paths" not in meta
    model, opt = _fresh(tcfg, seed=5)
    assert len(list(M._items((model, opt)))) == PORT_LEAVES
    # the port's plan of the tree is the reference's flatten, printed alike
    treedef, leaves = M._ref_plan((model, opt), tcfg)
    assert f"PyTreeDef({treedef})" == meta["treedef"]
    assert len(leaves) == REF_LEAVES
    model2, opt2 = M.CheckpointManager(tmp_path).restore(1, (model, opt))
    assert model2 is model
    _same_bits(model, opt2, params, jo, tcfg)
    if dtype == "float32":
        _steps_agree(jcfg, tcfg, params, jo, jstep, model, opt2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    jcfg, tcfg = _cfgs(dtype)
    params, jo, jstep = _reference_state(jcfg)
    # the port's own state: the reference's carried over, then one port
    # step, so that what is saved was computed by the port
    host = jax.tree.map(np.asarray, (params, jo))
    model = convert.from_jax_params(tcfg, host[0], device="cpu")
    opt = convert.opt_from_jax(tcfg, host[1], model)
    model, opt, _ = TSTEP.make_train_step(tcfg, **KW)(
        model, opt, _tb(_batch(jcfg, B=4, S=16, seed=6)))
    M.CheckpointManager(tmp_path, async_write=False).save(2, (model, opt))
    meta = json.loads((tmp_path / "step_00000002" / "meta.json").read_text())
    assert meta["n_leaves"] == REF_LEAVES
    assert len(list(M._items((model, opt)))) == PORT_LEAVES
    like = (JLM.init_params(jax.random.PRNGKey(1), jcfg),
            JOPT.adamw_init(params, compression=True))
    assert meta["treedef"] == str(jax.tree.flatten(like)[1])
    rparams, rjo = JCheckpointManager(str(tmp_path)).restore(2, like)
    assert rjo.step.dtype == np.int32
    _same_bits(model, opt, rparams, rjo, tcfg)
    if dtype == "float32":
        # the reference steps from what it restored, the port from its own
        _steps_agree(jcfg, tcfg, jax.tree.map(jnp.asarray, rparams),
                     jax.tree.map(jnp.asarray, rjo), jstep, model, opt)


def test_reference_layout_refuses_another_tree(tmp_path):
    """A reference checkpoint does not restore into a model of another
    shape, nor into one of another dtype."""
    jcfg, tcfg = _cfgs("bfloat16")
    params = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    JCheckpointManager(str(tmp_path), async_write=False).save(
        1, (params, JOPT.adamw_init(params, compression=True)))
    mgr = M.CheckpointManager(tmp_path)
    wide = dataclasses.replace(tcfg, d_ff=2 * tcfg.d_ff)
    with pytest.raises(ValueError, match="leaf"):
        mgr.restore(1, _fresh(wide, seed=1))
    with pytest.raises(ValueError, match="float32"):
        mgr.restore(1, _fresh(_cfgs("float32")[1], seed=1))
    with pytest.raises(ValueError, match="leaves"):   # no err buffers
        model = _fresh(tcfg, seed=1)[0]
        mgr.restore(1, (model, TOPT.adamw_init(
            dict(model.named_parameters()))))


@pytest.mark.parametrize("direction", ["reference to port",
                                       "port to reference"])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "whisper_small",
                                  "rwkv6_7b"])
def test_family_checkpoint_crosses_the_packages(tmp_path, arch, direction):
    """A reduced DeepSeek-MoE's, Whisper's and RWKV-6's training state
    (f32, after one compressed step) through each package's checkpoint into the
    other, bit for bit; then one more step on each side."""
    jcfg, tcfg, host = TF._reference(arch)
    jstep = jax.jit(JSTEP.make_train_step(jcfg, **KW))
    params = jax.tree.map(jnp.asarray, host)
    params, jo, _ = jstep(params, JOPT.adamw_init(params, compression=True),
                          _jb(TF._batch(jcfg, seed=3)))
    if direction == "reference to port":
        JCheckpointManager(str(tmp_path), async_write=False).save(
            1, (params, jo))
        model, opt = M.CheckpointManager(tmp_path).restore(
            1, _fresh(tcfg, seed=5))
    else:
        # the port's own state: the reference's carried over, then a step
        h = jax.tree.map(np.asarray, (params, jo))
        model = convert.from_jax_params(tcfg, h[0], device="cpu")
        opt = convert.opt_from_jax(tcfg, h[1], model)
        model, opt, _ = TSTEP.make_train_step(tcfg, **KW)(
            model, opt, _tb(TF._batch(jcfg, seed=6)))
        M.CheckpointManager(tmp_path, async_write=False).save(2, (model, opt))
        like = (JLM.init_params(jax.random.PRNGKey(1), jcfg),
                JOPT.adamw_init(params, compression=True))
        params, jo = jax.tree.map(
            jnp.asarray, JCheckpointManager(str(tmp_path)).restore(2, like))
    _same_bits(model, opt, params, jo, tcfg)
    _steps_agree(jcfg, tcfg, params, jo, jstep, model, opt,
                 batch=TF._batch(jcfg, seed=4))
