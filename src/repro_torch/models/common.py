"""Shared model substrate: configs, norms, RoPE, GQA attention, MLPs.

The port of ``repro.models.common``.  Parameters live in ``nn.Module``s
with the reference's names and layouts (``x @ w``, ``w`` stored
[in, out]), so a reference parameter tree maps onto them one to one
(``repro_torch.models.convert``).  Layers are modules, not a stacked
scan.  The reference's sharding hints (``shard_hint``) are left out: the
port splits only the MoE experts over a mesh (``models/moe.py``), and
every other layer runs whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import tp_align


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    every: int = 1          # MoE layer every `every` layers (jamba: 2)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str             # dense | moe | vlm | hybrid | encdec | rwkv
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 1e4
    moe: Optional[MoECfg] = None
    # hybrid (jamba): 1 attention layer per `attn_every` layers, rest Mamba
    attn_every: int = 0
    d_state: int = 16                 # mamba state
    # encdec (whisper)
    n_enc_layers: int = 0
    # vlm (llava)
    n_patches: int = 0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # TP head alignment (models/tp_align.py): when set, n_heads / n_kv are
    # the PADDED counts and head_maps = (q_src, kv_src, orig_heads,
    # orig_kv) records how padded weights derive from the exact config's
    # init
    head_maps: Any = None

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.d_head

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 (Megatron-style); padded ids are never
        sampled (the server takes the argmax over ``[:vocab]``)."""
        return (self.vocab + 255) // 256 * 256

    def param_count(self) -> float:
        """Approximate parameter count (for 6ND model-FLOPs)."""
        d, L = self.d_model, self.n_layers
        attn = d * self.d_qkv + 2 * d * self.n_kv * self.d_head + self.d_qkv * d
        if self.family == "rwkv":
            attn = 4 * d * d  # r,k,v,o (+ small lora/decay params)
        if self.moe is not None:
            me = self.moe
            ff_moe = 3 * d * me.d_ff_expert * me.n_experts + 3 * d * me.d_ff_expert * me.n_shared
            ff_dense = 3 * d * self.d_ff
            n_moe = L // max(me.every, 1)
            ff = n_moe * ff_moe + (L - n_moe) * ff_dense
        else:
            ff = L * 3 * d * self.d_ff
        n_attn_layers = L if self.attn_every == 0 else L // self.attn_every
        mamba = 0
        if self.attn_every:
            d_in = 2 * d
            mamba = (L - n_attn_layers) * (2 * d * d_in + d_in * d + d_in * (2 * self.d_state + 1))
        emb = self.vocab * d * 2  # in + out
        enc = self.n_enc_layers * (4 * d * d + 3 * d * self.d_ff)
        return float(n_attn_layers * attn + ff + mamba + emb + enc)

    def active_param_count(self) -> float:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        me = self.moe
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        n_moe = L // max(me.every, 1)
        all_routed = n_moe * 3 * d * me.d_ff_expert * me.n_experts
        active_routed = n_moe * 3 * d * me.d_ff_expert * me.top_k
        return float(full - all_routed + active_routed)


# ---------------------------------------------------------------- init ----
def param(shape, dtype, device, generator, *, scale=None, fill=None,
          uniform=False) -> nn.Parameter:
    """A frozen parameter: ``randn * scale``, ``rand`` (``uniform``) or a
    constant ``fill``, drawn from ``generator`` on ``device``."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif uniform:
        t = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    else:
        t = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device).mul_(scale)
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------- layers ---
def rms_norm(x, scale, eps=1e-5):
    """Variance in f32; the reciprocal root is cast to ``x.dtype`` before
    the products, as in the reference."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale.to(x.dtype)


def init_rope(d_head: int, max_seq: int, theta: float = 1e4, *, device):
    """cos/sin tables [max_seq, d_head/2], computed in numpy float64 and
    cast to f32 exactly as the reference does."""
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))
    freqs = np.outer(np.arange(max_seq), inv)
    return (torch.as_tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rope(x, cos, sin, positions):
    # x: [B, S, H, Dh]; cos/sin: [maxS, Dh/2]; positions: [B, S]
    c = cos[positions][:, :, None, :].to(x.dtype)
    s = sin[positions][:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Attention(nn.Module):
    """GQA attention with RoPE (reference ``init_attn`` / ``apply_attn``):
    self-attention, causal or not, or cross-attention to an encoder's
    output; the core is ``ops.flash_attention`` in every case."""

    def __init__(self, cfg: ModelCfg, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        if cfg.head_maps is None:
            p = self._draw(cfg, device, generator)
        else:
            # padded heads (models/tp_align.py): the exact config's weights
            # from the same stream, expanded (dead slots zero), as the
            # reference's init_attn does
            q_src, kv_src, oh, okv = cfg.head_maps
            base = dataclasses.replace(cfg, n_heads=oh, n_kv=okv,
                                       head_maps=None)
            p = tp_align.expand_attn_params(
                {k: v.data for k, v in
                 self._draw(base, device, generator).items()},
                q_src, kv_src, cfg.d_head)
            p = {k: nn.Parameter(v, requires_grad=False)
                 for k, v in p.items()}
        for k, v in p.items():
            setattr(self, k, v)

    @staticmethod
    def _draw(cfg: ModelCfg, device, generator) -> dict:
        """``cfg``'s weights in the reference's order: wq, wk, wv, wo,
        then the zero biases."""
        d, dq, dkv = cfg.d_model, cfg.d_qkv, cfg.n_kv * cfg.d_head
        s = float(1.0 / np.sqrt(d))
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        p = {"wq": param((d, dq), scale=s, **kw),
             "wk": param((d, dkv), scale=s, **kw),
             "wv": param((d, dkv), scale=s, **kw),
             "wo": param((dq, d), scale=s, **kw)}
        if cfg.qkv_bias:
            for k, n in (("bq", dq), ("bk", dkv), ("bv", dkv)):
                p[k] = param((n,), fill=0.0, **kw)
        return p

    def forward(self, x, rope, positions, kv_cache=None, cache_len: int = 0,
                causal: bool = True, xattn_kv=None):
        """x: [B, S, d].  ``kv_cache`` (decode): dict(k, v) of
        [B, max_len, n_kv, d_head], written in place at ``cache_len``
        (the reference donates its cache); attention then runs over the
        whole cache with ``q_offset = cache_len``.  ``xattn_kv`` [B, Se,
        d] (cross-attention): k and v come from it, with no RoPE and no
        cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        src = x if xattn_kv is None else xattn_kv
        Se = src.shape[1]
        q, k, v = x @ self.wq, src @ self.wk, src @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
        k = k.reshape(B, Se, cfg.n_kv, cfg.d_head)
        v = v.reshape(B, Se, cfg.n_kv, cfg.d_head)
        if xattn_kv is None:
            cos, sin = rope
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        q_offset = 0
        if kv_cache is not None:
            max_len = kv_cache["k"].shape[1]
            if cache_len + S > max_len:
                raise ValueError(f"KV cache full: length {cache_len} + {S} "
                                 f"> {max_len}")
            kv_cache["k"][:, cache_len:cache_len + S] = k
            kv_cache["v"][:, cache_len:cache_len + S] = v
            k, v, q_offset = kv_cache["k"], kv_cache["v"], cache_len
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  sliding_window=cfg.sliding_window,
                                  q_offset=q_offset)
        return out.reshape(B, S, cfg.d_qkv) @ self.wo


class MLP(nn.Module):
    """SwiGLU feed-forward (reference ``init_mlp`` / ``apply_mlp``)."""

    def __init__(self, d: int, d_ff: int, dtype, *, device, generator=None):
        super().__init__()
        s, s2 = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(d_ff))
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_gate = param((d, d_ff), scale=s, **kw)
        self.w_up = param((d, d_ff), scale=s, **kw)
        self.w_down = param((d_ff, d), scale=s2, **kw)

    def forward(self, x):
        g, u = x @ self.w_gate, x @ self.w_up
        return (torch.nn.functional.silu(g) * u) @ self.w_down
