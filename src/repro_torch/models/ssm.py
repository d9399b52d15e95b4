"""RWKV-6 "Finch" blocks (data-dependent decay): the RWKV half of the
reference's ``repro.models.ssm``.

Prefill (S > 1, S divisible by the chunk) runs the chunked recurrence
through ``ops.rwkv6_chunked``; decode (or a ragged S) runs the exact
per-token recurrence.  Mamba waits for the hybrid family (ROADMAP.md
queue 1, "The rest of the model zoo").
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
