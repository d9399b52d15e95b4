"""Yardsticks for a train step taken elsewhere: the kernels' plain
versions on any device, and the port's own step in f64.

A card's f32 step differs from the CPU's only in its summation orders,
but some gradients are sums whose terms cancel (the hybrid's ``dt_bias``
gradient, one sum over every token of ``dt_bias.mean()``, cancels to
~1e-6 of its terms), so two f32 orders can lie far apart relative to the
result.  Such a gradient is held against the same step in f64 instead:
the card's kernel path within :func:`dt_bias_tol` of the card's plain
path's gap to it (``chip_smoke.py`` phase 6b; PORT.md, "Hybrid
training").
"""
from __future__ import annotations

import contextlib
import copy

import torch

from repro_torch.kernels import ops, ref


@contextlib.contextmanager
def plain_versions():
    """Within the block the model kernels' wrappers that the hybrid's
    train step calls (attention, the Mamba scan) are their plain
    versions, torch ops on whatever device the tensors lie on, so that
    the card runs the CPU's arithmetic in its own order."""
    saved = ops.flash_attention, ops.mamba_scan

    def attention(q, k, v, *, causal=True, sliding_window=0, q_offset=0):
        return ref.mha_reference(q, k, v, causal=causal,
                                 sliding_window=sliding_window,
                                 q_offset=q_offset)
    ops.flash_attention, ops.mamba_scan = attention, ref.mamba_scan_reference
    try:
        yield
    finally:
        ops.flash_attention, ops.mamba_scan = saved


@contextlib.contextmanager
def in_f64():
    """Within the block the port computes in f64: ``Tensor.float()`` is
    ``.double()``, ``.to(torch.float32)`` is ``.to(torch.float64)`` and the
    default dtype is f64, so the models' f32 casts (the router, the loss,
    the scan's and attention's plain versions, AdamW) keep f64 on f64
    weights (:func:`f64_copy` casts the model, its state and the batch).
    Methods of ``torch.Tensor`` are patched for the whole process, not a
    torch function mode: a mode is off inside the ``autograd.grad`` it
    handles, where remat recomputes the forward.  Use it on the CPU, in
    one thread of the process at a time."""
    T, f32, f64 = torch.Tensor, torch.float32, torch.float64
    saved = T.float, T.to

    def to(self, *a, **kw):
        a = tuple(f64 if x is f32 else x for x in a)
        kw = {k: f64 if v is f32 else v for k, v in kw.items()}
        return saved[1](self, *a, **kw)
    old = torch.get_default_dtype()
    T.float, T.to = T.double, to
    torch.set_default_dtype(f64)
    try:
        yield
    finally:
        T.float, T.to = saved
        torch.set_default_dtype(old)


def f64_copy(model, opt_state, batch):
    """``model`` (on the CPU), its AdamW state and ``batch`` cast to f64
    for :func:`in_f64`."""
    return (copy.deepcopy(model).double(),
            opt_state._replace(m={k: t.double() for k, t in opt_state.m.items()},
                               v={k: t.double() for k, t in opt_state.v.items()},
                               step=opt_state.step.clone()),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()})


def rel_gap(got, want, skip=None) -> float:
    """Largest |got - want| (``skip``'s elements left out) over want's
    largest entry; ``want`` on the CPU."""
    gap = (got.detach().cpu() - want.detach()).abs()
    if skip is not None:
        gap = gap.masked_fill(skip, 0)
    return float(gap.max()) / max(float(want.detach().abs().max()), 1e-30)


def dt_bias_gap(got: dict, exact: dict, skip: dict | None = None) -> float:
    """The largest :func:`rel_gap` of ``got``'s ``dt_bias`` leaves to
    ``exact``'s (by name; ``skip`` by name too)."""
    return max((rel_gap(g, exact[n], None if skip is None else skip[n])
                for n, g in got.items() if n.endswith(".dt_bias")),
               default=0.0)


def dt_bias_tol(plain_gap: float) -> float:
    """The allowance for the kernel path's ``dt_bias`` gap to the f64
    step: 1e-4, or twice the plain versions' gap on the card to the same
    f64 step, whichever is larger (the kernels may add no error of their
    own)."""
    return max(1e-4, 2 * plain_gap)
