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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor
    err: Optional[dict] = None   # error-feedback buffers (compression)


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


def global_norm(tree: dict):
    total = 0
    for x in tree.values():
        total = total + x.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales ``grads`` in place by ``min(1, max_norm / norm)``, the
    factor cast to each gradient's dtype; returns ``(grads, norm)``."""
    g = global_norm(grads)
    scale = torch.minimum(torch.ones_like(g),
                          torch.full_like(g, max_norm) / g.clamp_min(1e-9))
    for x in grads.values():
        x.mul_(scale.to(x.dtype))
    return grads, g


@torch.no_grad()
def compress_int8(grads: dict, err: dict, groups=None):
    """Symmetric int8 quantization with error feedback, in place: each
    gradient becomes its dequantized value (in its dtype) and each error
    buffer the f32 remainder.  The scale is ``max |g + err| / 127`` over
    a group of tensors: ``groups`` lists the names that share one (the
    reference quantizes each leaf of its tree, and a leaf of its
    ``blocks`` stacks a parameter over every layer:
    ``LM.stacked_groups``); by default each tensor alone.  Returns
    ``(grads, err)``."""
    for names in groups if groups is not None else [[n] for n in grads]:
        gfs = [grads[n].float() + err[n] for n in names]
        amax = torch.stack([gf.abs().max() for gf in gfs]).max()
        scale = amax.clamp_min(1e-12) * recip(127.0)
        for n, gf in zip(names, gfs):
            deq = torch.round(gf / scale).clamp(-127, 127) * scale
            grads[n].copy_(deq)
            err[n].copy_(gf - deq)
    return grads, err


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, lr, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 max_grad_norm=1.0, groups=None):
    """One AdamW step: clip, compress (when ``state.err`` holds buffers;
    ``groups`` as :func:`compress_int8` takes them), then the moments and
    the parameters, all in place; ``grads`` is overwritten.  Returns
    ``(params, state, gnorm)`` with the new step count in ``state``."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    if state.err is not None:
        compress_int8(grads, state.err, groups)
    step = state.step + 1
    b1c = 1 - torch.pow(b1, step.float())
    b2c = 1 - torch.pow(b2, step.float())
    for name, p in params.items():
        gf = grads[name].float()
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square())
        delta = (m / b1c) / ((v / b2c).sqrt() + eps) + \
            weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(state.m, state.v, step, state.err), gnorm
