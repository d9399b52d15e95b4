"""State-space / linear-recurrence blocks: the port of the reference's
``repro.models.ssm``.

Mamba (Jamba's hybrid stack): its parallel form (prefill and training,
S > 1) is ``ops.mamba_scan``, the scan kernel (``csrc/mamba_scan.cu``)
with its backward kernel under grad, which holds no [S, d_in, d_state]
tensor; one decode token is the recurrence in torch ops.  The reference
has no Pallas kernel for it (XLA scans 256-token chunks); its in and out
projections, conv, ``D`` and gate stay torch ops here.

RWKV-6 "Finch" (data-dependent decay): prefill and training (S > 1, S
divisible by the chunk) run the chunked recurrence through
``ops.rwkv6_chunked`` (under grad on the card its forward keeps each
chunk's start state and its backward is the ``rwkv6_chunked_bwd``
kernel); decode (or a ragged S) runs the exact per-token recurrence,
whose torch ops autograd differentiates.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models.common import ModelCfg, param

HD = 64     # RWKV-6 head size, fixed as in the reference
CHUNK = 16  # the reference model's chunk (its Pallas wrapper defaults to 64)


class Mamba(nn.Module):
    """Reference ``init_mamba`` / ``apply_mamba``: d_in = 2 d, a causal
    depthwise conv of width 4, a selective scan over ``d_state``."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, ds = cfg.d_model, cfg.d_state
        d_in = 2 * d
        s = float(1.0 / np.sqrt(d))
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        f32 = dict(kw, dtype=torch.float32)
        self.in_proj = param((d, 2 * d_in), scale=s, **kw)
        self.conv_w = param((4, d_in), scale=0.2, **kw)
        self.x_proj = param((d_in, 2 * ds + 1), scale=s, **kw)
        self.dt_bias = param((d_in,), fill=0.0, **f32)
        a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.log(a).repeat(d_in, 1),
                                  requires_grad=False)
        self.D = param((d_in,), fill=1.0, **f32)
        self.out_proj = param((d_in, d), scale=s, **kw)

    def forward(self, x, state=None):
        """x: [B, S, d]; state: None (parallel form) or dict(conv [B, 3,
        d_in] in ``cfg.dtype``, ssm [B, d_in, d_state] f32) for one decode
        token.  Returns (out [B, S, d], new state dict)."""
        B, S, _ = x.shape
        ds = self.cfg.d_state
        if state is not None and S != 1:
            raise ValueError(f"Mamba's recurrent form takes one token, got "
                             f"S = {S}")
        xs, z = (x @ self.in_proj).chunk(2, dim=-1)
        d_in = xs.shape[-1]
        head = (torch.zeros((B, 3, d_in), dtype=xs.dtype, device=x.device)
                if state is None else state["conv"].to(xs.dtype))
        xpad = torch.cat([head, xs], dim=1)
        # the causal depthwise conv, summed in the reference's order, in
        # cfg.dtype
        xc = xpad[:, 0:S] * self.conv_w[0]
        for i in range(1, 4):
            xc = xc + xpad[:, i:i + S] * self.conv_w[i]
        xc = torch.nn.functional.silu(xc)
        proj = (xc @ self.x_proj).float()
        Bm, Cm, dt = proj[..., :ds], proj[..., ds:2 * ds], proj[..., -1:]
        # the mean of the whole dt_bias, as the reference takes it
        dt = torch.nn.functional.softplus(dt + self.dt_bias.mean())
        A = -torch.exp(self.A_log)                           # [d_in, ds]
        xcf = xc.float()
        h = (torch.zeros((B, d_in, ds), dtype=torch.float32, device=x.device)
             if state is None else state["ssm"])
        if S > 1:
            # the parallel form: the scan kernel (its plain token loop on
            # the CPU), differentiable
            y, h = ops.mamba_scan(xcf.contiguous(), dt.reshape(B, S),
                                  A.contiguous(), Bm.contiguous(),
                                  Cm.contiguous(), h)
        else:
            # one token: the recurrent form, as the reference's decode
            # branch
            dtc = dt[:, 0, :, None]                          # [B, 1, 1]
            h = torch.exp(dtc * A) * h + \
                (dtc * Bm[:, 0, None, :]) * xcf[:, 0, :, None]
            y = torch.einsum("ben,bn->be", h, Cm[:, 0])[:, None]
        y = y + xcf * self.D
        y = y.to(x.dtype) * torch.nn.functional.silu(z)
        return y @ self.out_proj, {"conv": xpad[:, -3:], "ssm": h}


def _shifted(x, last):
    """x_prev: x shifted right by one token, ``last`` [B, d] (or zeros)
    in front."""
    B, _, d = x.shape
    first = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
             if last is None else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], 1)


class RWKV6TimeMix(nn.Module):
    """Reference ``init_rwkv6`` / ``apply_rwkv6``."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None):
        super().__init__()
        d = cfg.d_model
        s = float(1.0 / np.sqrt(d))
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        f32 = dict(kw, dtype=torch.float32)
        self.t_mix = param((5, d), uniform=True, **kw)   # r, k, v, w, g
        self.wr = param((d, d), scale=s, **kw)
        self.wk = param((d, d), scale=s, **kw)
        self.wv = param((d, d), scale=s, **kw)
        self.wg = param((d, d), scale=s, **kw)
        self.ww = param((d, 64), scale=s, **kw)           # decay lora
        self.ww2 = param((64, d), scale=0.1, **kw)
        self.w_bias = param((d,), fill=-6.0, **f32)
        self.u = param((d,), fill=0.0, **f32)            # bonus
        self.wo = param((d, d), scale=s, **kw)

    def forward(self, x, state=None):
        """x: [B, S, d]; state: None or dict(shift [B, d], wkv [B, H, 64,
        64] f32).  Returns (out, new_shift, new_wkv)."""
        B, S, d = x.shape
        H = d // HD
        x_prev = _shifted(x, None if state is None else state["shift"])
        wkv0 = (torch.zeros((B, H, HD, HD), dtype=torch.float32,
                            device=x.device)
                if state is None else state["wkv"])
        mix = torch.sigmoid(self.t_mix)

        def mx(i):
            return x * mix[i] + x_prev * (1 - mix[i])
        r = mx(0) @ self.wr
        k = mx(1) @ self.wk
        v = mx(2) @ self.wv
        g = torch.nn.functional.silu(mx(4) @ self.wg)
        # data-dependent decay (Finch): w_t = exp(-exp(lora(x_t)))
        wlog = torch.tanh(mx(3) @ self.ww) @ self.ww2
        w = torch.exp(-torch.exp(wlog.float() + self.w_bias))

        def heads(a):
            return a.reshape(B, S, H, HD).float().contiguous()
        rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
        u = self.u.reshape(H, HD)
        if S > 1 and S % min(CHUNK, S) == 0:
            y4, wkv = ops.rwkv6_chunked(rh, kh, vh, wh, u, wkv0.contiguous(),
                                        chunk=CHUNK)
        else:
            y4, wkv = R.rwkv6_reference(rh, kh, vh, wh, u, wkv0)
        y = y4.reshape(B, S, d).to(x.dtype) * g
        # the reference's output "projection" is einsum("bsd,de->bsd", y,
        # wo): a scale of each channel d by the row sum of wo, not a
        # matmul (ROADMAP.md queue 3); the port follows it
        return y * self.wo.sum(-1), x[:, -1], wkv


class RWKVChannelMix(nn.Module):
    """Reference ``init_rwkv_cmix`` / ``apply_rwkv_cmix``."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        self.t_mix = param((2, d), uniform=True, **kw)
        self.wk = param((d, dff), scale=float(1.0 / np.sqrt(d)), **kw)
        self.wv = param((dff, d), scale=float(1.0 / np.sqrt(dff)), **kw)

    def forward(self, x, shift=None):
        """Returns (out, new_shift)."""
        x_prev = _shifted(x, shift)
        mix = torch.sigmoid(self.t_mix)
        xk = x * mix[0] + x_prev * (1 - mix[0])
        h = torch.relu(xk @ self.wk).square()
        return h @ self.wv, x[:, -1]
