"""Optimizer substrate: AdamW, LR schedules (cosine + MiniCPM's WSD),
gradient clipping and int8 error-feedback gradient compression: the port
of ``repro.train.optim``.

Plain functions on dicts of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``), in the reference's order of
operations: f32 moments, ``b1 ** step`` in f32, ``mh / (sqrt(vh) + eps)
+ wd * p``, the result cast back to the parameter's dtype (not
``torch.optim.AdamW``, which decays the weights apart and rounds
elsewhere).  The parameters, moments and error buffers are updated in
place (the reference donates them); the step count is a 0-d int32 tensor
on the parameters' device, so nothing here reads the device back.  Where
the reference divides by a constant, XLA multiplies by the constant's
f32 reciprocal, and so does the port (:func:`recip`).

On a mesh a rank holds its block of each tensor split over 'model' (the
MoE expert rows, ``LM.sharded_params``) and the moments of that block
only; the functions that reduce over a whole tensor (the global norm,
the int8 scale) take those names (``sharded``) and the group they are
split over, and reduce them over it, every replicated tensor counted
once, so every rank computes the same norm and scales.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor
    err: Optional[dict] = None   # error-feedback buffers (compression)


CHUNK = 1 << 26   # elements an AdamW pass updates at once


def recip(x) -> float:
    """The f32 reciprocal of the constant ``x``, which the jitted
    reference multiplies by where it divides by ``x``."""
    return float(np.float32(1) / np.float32(x))


def adamw_init(params: dict, compression: bool = False) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(m=zeros(), v=zeros(),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      err=zeros() if compression else None)


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, floor_frac: float = 0.1):
    """MiniCPM Warmup-Stable-Decay [arXiv:2404.06395]; ``step`` a 0-d
    integer tensor, the learning rate a 0-d f32 tensor on its device.
    Warmup uses (step + 1) so the very first optimizer step has a nonzero
    learning rate (step counter is 0-based)."""
    step = step.float()
    warm = peak_lr * (step + 1.0) * recip(max(warmup, 1))
    dec_t = ((step - warmup - stable) * recip(max(decay, 1))).clamp(0.0, 1.0)
    dec = peak_lr * (1.0 - (1.0 - floor_frac) * dec_t)
    return torch.where(step < warmup, warm,
                       torch.where(step < warmup + stable,
                                   torch.full_like(step, peak_lr), dec))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    step = step.float()
    warm = peak_lr * (step + 1.0) * recip(max(warmup, 1))
    t = ((step - warmup) * recip(max(total - warmup, 1))).clamp(0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(np.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)


def global_norm(tree: dict, sharded=(), group=None):
    """The root of the sum of squares of every tensor of ``tree``; the
    squares of the ``sharded`` tensors (a rank's blocks of tensors split
    over ``group``) summed over the group."""
    total, part = 0, None
    for name, x in tree.items():
        # a chunk at a time past CHUNK elements (an expert block, an
        # embedding), so no f32 copy of the whole tensor is made
        flat = x.reshape(-1)
        sq = flat[:CHUNK].float().square().sum()
        for lo in range(CHUNK, flat.numel(), CHUNK):
            sq = sq + flat[lo:lo + CHUNK].float().square().sum()
        if name in sharded:
            part = sq if part is None else part + sq
        else:
            total = total + sq
    if part is not None:
        dist.all_reduce(part, group=group)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, sharded=(),
                        group=None):
    """Scales ``grads`` in place by ``min(1, max_norm / norm)``, the
    factor cast to each gradient's dtype; returns ``(grads, norm)``."""
    g = global_norm(grads, sharded, group)
    scale = torch.minimum(torch.ones_like(g),
                          torch.full_like(g, max_norm) / g.clamp_min(1e-9))
    for x in grads.values():
        x.mul_(scale.to(x.dtype))
    return grads, g


@torch.no_grad()
def compress_int8(grads: dict, err: dict, groups=None, sharded=(),
                  group=None):
    """Symmetric int8 quantization with error feedback, in place: each
    gradient becomes its dequantized value (in its dtype) and each error
    buffer the f32 remainder.  The scale is ``max |g + err| / 127`` over
    a group of tensors: ``groups`` lists the names that share one (the
    reference quantizes each leaf of its tree, and a leaf of its
    ``blocks`` stacks a parameter over every layer:
    ``LM.stacked_groups``); by default each tensor alone.  A group of
    ``sharded`` tensors takes its max over ``group`` too, as the
    reference's one leaf has one scale.  Returns ``(grads, err)``."""
    for names in groups if groups is not None else [[n] for n in grads]:
        gfs = [grads[n].float() + err[n] for n in names]
        amax = torch.stack([gf.abs().max() for gf in gfs]).max()
        if names[0] in sharded:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax.clamp_min(1e-12) * recip(127.0)
        for n, gf in zip(names, gfs):
            deq = torch.round(gf / scale).clamp(-127, 127) * scale
            grads[n].copy_(deq)
            err[n].copy_(gf - deq)
    return grads, err


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, lr, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 max_grad_norm=1.0, groups=None, sharded=(), group=None):
    """One AdamW step: clip, compress (when ``state.err`` holds buffers;
    ``groups`` as :func:`compress_int8` takes them), then the moments and
    the parameters, all in place; ``grads`` is overwritten.  On a mesh
    ``sharded`` names the rank's blocks of tensors split over ``group``.
    Returns ``(params, state, gnorm)`` with the new step count in
    ``state``."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, sharded, group)
    if state.err is not None:
        compress_int8(grads, state.err, groups, sharded, group)
    step = state.step + 1
    b1c = 1 - torch.pow(b1, step.float())
    b2c = 1 - torch.pow(b2, step.float())
    for name, p in params.items():
        flat = [p.view(-1), grads[name].reshape(-1),
                state.m[name].view(-1), state.v[name].view(-1)]
        # elementwise, so a chunk at a time gives the same bits and keeps
        # the f32 temporaries of a large tensor (an expert block) small
        for lo in range(0, p.numel(), CHUNK):
            pc, gc, m, v = (t[lo:lo + CHUNK] for t in flat)
            gf = gc.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf.square())
            delta = (m / b1c) / ((v / b2c).sqrt() + eps) + \
                weight_decay * pc.float()
            pc.copy_(pc.float() - lr * delta)
    return params, AdamWState(state.m, state.v, step, state.err), gnorm
