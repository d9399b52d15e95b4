"""Training of the hybrid family (Jamba-1.5-Large) in the port against the
JAX reference, on the CPU, at the reduced config in f32 (8 layers:
attention, Mamba + MoE, Mamba, Mamba + MoE, twice; d 128, 4 experts).

Weights come from ``repro.models.lm.init_params`` and cross into the
port through ``convert.from_jax_params``; tokens and labels from numpy,
2 x 64.  The Mamba scan runs ``ops.mamba_scan``'s plain version
(``ref.mamba_scan_reference``), attention its plain version, both
differentiated by autograd.  Tolerances and the near-zero-gradient rule
of a train step are ``tests/test_torch_train.py``'s (1e-4 of each
tensor's largest entry; f32 throughout: the reference's associative scan
multiplies the decays in another order, the sums run in another).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.train import optim as JOPT  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.lm import block_kinds  # noqa: E402
from repro_torch.train import optim as TOPT  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402
from test_torch_train import (TOL, _flips, _jb, _near_zero, _rel,  # noqa
                              _tb, _tree_close)
from test_torch_train_families import (KW, _batch, _loss_and_grads,  # noqa
                                       _pair, _reference_grads,
                                       moved_apart)

ARCH = "jamba_1_5_large"
B, S = 2, 64


def test_every_family_trains():
    """No family is left out of training (``UNTRAINABLE`` is empty); the
    reduced Jamba holds every block kind of its scan unit."""
    assert TSTEP.UNTRAINABLE == {}
    assert "hybrid" in TSTEP.TRAINABLE
    _, tcfg, _, _ = _pair(ARCH)
    assert block_kinds(tcfg) == ["attn", "mamba_moe", "mamba", "mamba_moe"]


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(remat):
    """The loss (the MoE's aux at weight 0.01, non-zero) and the gradient
    of every parameter: attention, the Mamba layers' in / out
    projections, conv, ``x_proj``, ``dt_bias``, ``A_log`` and ``D``, the
    routers and experts, the MLPs, the norms, embedding and head."""
    aux = _loss_and_grads(ARCH, remat, B=B, S=S)
    assert aux > 0


def test_every_mamba_parameter_has_a_gradient():
    """``A_log`` trains, as every leaf of the reference's tree does: its
    gradient, like every other Mamba parameter's, is not zero."""
    jg = _reference_grads(ARCH, B, S, 1)[2]
    _, _, _, model = _pair(ARCH)
    for i, blk in enumerate(model.blocks):
        if blk.kind.startswith("mamba"):
            for name, _ in blk.mamba.named_parameters():
                leaf = jg["blocks"][i % 4]["mamba"][name][i // 4]
                assert float(np.abs(leaf).max()) > 0, (i, name)


@pytest.mark.parametrize("compression", [False, True])
def test_train_step_matches_reference(compression):
    """One train step from the same weights and batch: loss, gnorm, lr,
    the parameters, ``m`` and ``v`` (with int8 compression also the
    error buffers, but for elements on a rounding boundary)."""
    jcfg, tcfg, params, model = _pair(ARCH)
    batch = _batch(jcfg, B, S, 1)
    jg = _reference_grads(ARCH, B, S, 1)[2]
    params, jo, jm = jax.jit(JSTEP.make_train_step(jcfg, **KW))(
        params, JOPT.adamw_init(params, compression=compression),
        _jb(batch))
    model, to, tm = TSTEP.make_train_step(tcfg, **KW)(
        model, TOPT.adamw_init(dict(model.named_parameters()),
                               compression=compression), _tb(batch))
    for k in ("loss", "gnorm", "lr"):
        assert _rel(float(tm[k]), float(jm[k])) <= TOL, k
    skip = _near_zero(jg)
    if compression:
        skip = jax.tree.map(np.logical_or, skip, _flips(
            convert.to_numpy_tree(model, to.err), jo.err))
    mine = convert.to_numpy_tree(model)
    moved_apart(mine, params, skip)
    _tree_close(mine, params, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.m), jo.m, skip=skip)
    _tree_close(convert.to_numpy_tree(model, to.v), jo.v, skip=skip)


def test_launch_train_reduced():
    """``launch.train.train`` on the reduced Jamba on the CPU (the token
    stream, cosine, remat): finite losses that fall."""
    _, _, losses = TTRAIN.train(ARCH, steps=6, global_batch=2, seq_len=32,
                                log_every=0, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_launch_train_cli(capsys):
    """``python -m repro_torch.launch.train --arch jamba_1_5_large
    --device cpu`` trains the reduced config."""
    TTRAIN.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                 "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "final loss" in out
