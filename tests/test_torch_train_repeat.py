"""A train step's gradients repeat bit for bit, and phase 6b's ``dt_bias``
rule, on the CPU at the reduced Jamba-1.5-Large in f32.

The token embedding's backward once summed each row's tokens with
atomics on the CPU (indexing's backward), so the same step gave other
bits run to run; ``chip_smoke.py`` phase 6b's ``dt_bias`` rule compared
two such draws.  The embedding is now ``F.embedding``, whose backward
sums in a fixed order on the CPU and on the card, and the rule holds the
card's kernel path against the port's own step in f64
(``repro_torch.train.yardstick.in_f64``): within 1e-4, or twice the
plain versions' gap to the same f64 step (``yardstick.dt_bias_tol``).
On the card ``tests/test_torch_cuda.py`` holds both card paths to the
same bits twice.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import optim as TOPT  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402
from repro_torch.train import yardstick as Y  # noqa: E402

ARCH = "jamba_1_5_large"


@pytest.fixture(scope="module")
def jamba():
    """The reduced Jamba in f32 (phase 6b's weights and batch shapes) and
    two seeded batches of 4 x 64 tokens."""
    cfg = dataclasses.replace(C.get_reduced(ARCH), dtype=torch.float32)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 65)))
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return cfg, model, batches


@pytest.fixture
def threads():
    """Several CPU threads (the tests' files run on one): a sum by atomics
    then lands in another order run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mb", [0, 2])
def test_step_gradients_repeat_bit_for_bit(jamba, threads, mb):
    cfg, model, batches = jamba
    loss_fn = TSTEP.make_loss_fn(cfg)
    a, b = (TSTEP.step_grads(loss_fn, model, batches[0], mb)
            for _ in range(2))
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    assert not differ, differ


def test_train_step_repeats_bit_for_bit(jamba, threads):
    """Two train steps from one state on one batch leave the same
    parameters and moments."""
    cfg, model, batches = jamba
    fn = TSTEP.make_train_step(cfg, warmup=1, total=3, microbatch=2)
    out = []
    for _ in range(2):
        m = copy.deepcopy(model)
        st = TOPT.adamw_init(dict(m.named_parameters()))
        m, st, _ = fn(m, st, batches[1])
        out.append((dict(m.named_parameters()), st))
    (p1, s1), (p2, s2) = out
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n
        assert torch.equal(s1.m[n], s2.m[n]) and \
            torch.equal(s1.v[n], s2.v[n]), n


def test_update_is_the_train_steps_update(jamba):
    """``train_step.update`` from the step's own gradients leaves the
    parameters and moments the step does."""
    cfg, model, batches = jamba
    fn = TSTEP.make_train_step(cfg, warmup=1, total=3)
    m1, m2 = copy.deepcopy(model), copy.deepcopy(model)
    s1 = TOPT.adamw_init(dict(m1.named_parameters()))
    s2 = TOPT.adamw_init(dict(m2.named_parameters()))
    m1, s1, _ = fn(m1, s1, batches[0])
    g = TSTEP.step_grads(TSTEP.make_loss_fn(cfg), m2, batches[0], 0)
    s2 = fn.update(m2, s2, g)[0]
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    for n in p1:
        assert torch.equal(p1[n], p2[n]) and torch.equal(s1.m[n], s2.m[n]), n
    assert int(s1.step) == int(s2.step) == 1


def test_f64_step_runs_in_f64(jamba):
    """Under ``in_f64`` the port's loss, gradients and AdamW state are f64
    and the f32 step is within 1e-4 of it on every tensor; outside it the
    casts are back."""
    cfg, model, batches = jamba
    loss_fn = TSTEP.make_loss_fn(cfg)
    fn = TSTEP.make_train_step(cfg, warmup=1, total=3)
    st = TOPT.adamw_init(dict(model.named_parameters()))
    m64, s64, b64 = Y.f64_copy(model, st, batches[0])
    with Y.in_f64():
        loss, _ = loss_fn(m64, b64)
        g64 = TSTEP.step_grads(loss_fn, m64, b64, 0)
        s64 = fn.update(m64, s64, {n: g.clone() for n, g in g64.items()})[0]
    assert loss.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in g64.values())
    assert all(t.dtype == torch.float64 for t in s64.m.values())
    assert torch.ones(1).float().dtype == torch.float32
    assert torch.get_default_dtype() == torch.float32
    g32 = TSTEP.step_grads(loss_fn, model, batches[0], 0)
    assert max(Y.rel_gap(g32[n], g64[n]) for n in g32) <= 1e-4


def test_dt_bias_rule(jamba):
    """The rule passes when the kernel path's gradient is the plain
    versions' and fails when an error past twice their gap (and past
    1e-4) is added to one ``dt_bias`` element."""
    cfg, model, batches = jamba
    loss_fn = TSTEP.make_loss_fn(cfg)
    m64, _, b64 = Y.f64_copy(model, TOPT.adamw_init(
        dict(model.named_parameters())), batches[0])
    with Y.in_f64():
        g64 = TSTEP.step_grads(loss_fn, m64, b64, 0)
    plain = TSTEP.step_grads(loss_fn, model, batches[0], 0)
    p_gap = Y.dt_bias_gap(plain, g64)
    assert 0 < p_gap < 1e-4
    tol = Y.dt_bias_tol(p_gap)
    assert tol == 1e-4 and Y.dt_bias_tol(1e-3) == 2e-3
    assert Y.dt_bias_gap(plain, g64) <= tol
    name = next(n for n in plain if n.endswith(".dt_bias"))
    bad = dict(plain)
    bad[name] = plain[name].clone()
    bad[name][3] += 3 * tol * float(g64[name].abs().max())
    assert Y.dt_bias_gap(bad, g64) > tol
    # other tensors are not the rule's
    other = dict(plain, embed=plain["embed"] * 2)
    assert Y.dt_bias_gap(other, g64) == p_gap


def test_plain_versions_swap_the_wrappers_back(jamba):
    """Within ``plain_versions`` attention and the Mamba scan are their
    plain versions (on the CPU the wrappers run those too, so the step's
    gradients are the same bits); after it the wrappers are back."""
    from repro_torch.kernels import ops, ref
    cfg, model, batches = jamba
    loss_fn = TSTEP.make_loss_fn(cfg)
    wrappers = ops.flash_attention, ops.mamba_scan
    want = TSTEP.step_grads(loss_fn, model, batches[0], 0)
    with Y.plain_versions():
        assert ops.mamba_scan is ref.mamba_scan_reference
        assert ops.flash_attention is not wrappers[0]
        got = TSTEP.step_grads(loss_fn, model, batches[0], 0)
    assert (ops.flash_attention, ops.mamba_scan) == wrappers
    assert [n for n in want if not torch.equal(want[n], got[n])] == []
