"""Language model for every family (dense, MoE, VLM, hybrid, enc-dec,
RWKV): the port of ``repro.models.lm``'s ``init_params`` / ``forward`` /
``init_cache`` / ``decode_step``.

Layers are a ``ModuleList`` (no stacked scan), layer ``i`` of kind
``block_kinds(cfg)[i % unit]``, so a depth that is not a whole number of
the reference's scan units still builds (Jamba cut to 4 of its 8-layer
unit).

On a ``mesh`` (``repro_torch.launch.mesh``) every layer but the MoE's
experts runs whole on every rank; the experts are split over 'model' and
an MoE layer's output is gathered back whole (``models/moe.py``), so
every rank carries the same activations and logits.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.common import (MLP, Attention, ModelCfg, init_rope,
                                       param, rms_norm)
from repro_torch.models.moe import EXPERT_ROWS, MoE

MAX_ROPE = 1 << 16
FAMILIES = ("dense", "moe", "vlm", "hybrid", "encdec", "rwkv")
ATTN_KINDS = ("attn", "attn_moe", "enc", "dec")


def block_kinds(cfg: ModelCfg) -> list[str]:
    """Block kind for each layer position within one scan unit."""
    if cfg.family == "rwkv":
        return ["rwkv"]
    if cfg.family == "encdec":
        return ["dec"]
    if cfg.family == "hybrid":
        kinds = []
        for i in range(cfg.attn_every):
            base = "attn" if i == 0 else "mamba"
            moe = cfg.moe is not None and i % cfg.moe.every == 1
            kinds.append(base + ("_moe" if moe else ""))
        return kinds
    if cfg.moe is not None:
        return ["attn_moe"]
    return ["attn"]


def scan_unit(cfg: ModelCfg) -> tuple[int, int]:
    """(number of units, layers per unit) of the reference's stacked
    parameter layout."""
    kinds = block_kinds(cfg)
    u = len(kinds)
    if cfg.n_layers % u:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"the unit {u}")
    return cfg.n_layers // u, u


class Block(nn.Module):
    """Pre-norm residual block (reference ``_init_block`` /
    ``_apply_block``): attention (``attn``, ``enc`` non-causal, ``dec``
    then cross-attention to the encoder's output) or Mamba (``mamba``),
    then an MLP or, with ``_moe``, an MoE; or RWKV time mix + channel mix
    (``rwkv``)."""

    def __init__(self, cfg: ModelCfg, kind: str, *, device, generator=None,
                 mesh=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        kw = dict(device=device, generator=generator)
        self.ln1 = param((cfg.d_model,), torch.float32, device, None, fill=1.0)
        self.ln2 = param((cfg.d_model,), torch.float32, device, None, fill=1.0)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, **kw)
        elif kind in ("mamba", "mamba_moe"):
            self.mamba = ssm.Mamba(cfg, **kw)
        elif kind == "rwkv":
            self.tmix = ssm.RWKV6TimeMix(cfg, **kw)
            self.cmix = ssm.RWKVChannelMix(cfg, **kw)
            return
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        if kind == "dec":
            self.xattn = Attention(cfg, **kw)
            self.ln3 = param((cfg.d_model,), torch.float32, device, None,
                             fill=1.0)
        if kind.endswith("_moe"):
            self.moe = MoE(cfg, mesh=mesh, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, **kw)

    def forward(self, x, rope=None, positions=None, cache=None,
                cache_len: int = 0, with_aux: bool = False, enc_out=None):
        """Returns ``(x, aux)``: ``aux`` is the MoE load-balance loss when
        ``with_aux`` and the kind ends in ``_moe``, else None.  ``cache``
        (decode) is this layer's dict, updated in place; ``enc_out`` is
        the encoder's output that a ``dec`` block attends to."""
        eps = self.cfg.norm_eps
        if self.kind == "rwkv":
            h, shift, wkv = self.tmix(rms_norm(x, self.ln1, eps), cache)
            x = x + h
            h, cshift = self.cmix(rms_norm(x, self.ln2, eps),
                                  None if cache is None else cache["cshift"])
            if cache is not None:
                cache["shift"].copy_(shift)
                cache["wkv"].copy_(wkv)
                cache["cshift"].copy_(cshift)
            return x + h, None
        if self.kind in ATTN_KINDS:
            x = x + self.attn(rms_norm(x, self.ln1, eps), rope, positions,
                              kv_cache=cache, cache_len=cache_len,
                              causal=self.kind != "enc")
            if self.kind == "dec":
                x = x + self.xattn(rms_norm(x, self.ln3, eps), None, None,
                                   causal=False, xattn_kv=enc_out)
        else:
            h, st = self.mamba(rms_norm(x, self.ln1, eps), cache)
            x = x + h
            if cache is not None:
                cache["conv"].copy_(st["conv"])
                cache["ssm"].copy_(st["ssm"])
        if self.kind.endswith("_moe"):
            h, aux = self.moe(rms_norm(x, self.ln2, eps), with_aux)
            return x + h, aux
        return x + self.mlp(rms_norm(x, self.ln2, eps)), None


def _run(blk: Block, remat: bool, *args, **kw):
    """``blk(*args, **kw)``, under ``remat`` recomputed in the backward
    instead of keeping its activations (the reference's
    ``jax.checkpoint``)."""
    if remat:
        return checkpoint(blk, *args, **kw, use_reentrant=False,
                          preserve_rng_state=False)
    return blk(*args, **kw)


class LM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and output head (and for
    the enc-dec family ``n_enc_layers`` encoder blocks and their norm),
    with the reference's parameter names and layouts.  Parameters are
    drawn from ``generator`` on ``device`` (the mesh's device, else the
    card, unless named), in the same order with or without a ``mesh``: on
    one, each MoE layer keeps only this rank's expert rows, so a seed
    gives the same model on one card or on several."""

    def __init__(self, cfg: ModelCfg, *, device=None, generator=None,
                 mesh=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        if device is None and mesh is not None:
            device = mesh.device
        dev = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(device=dev, generator=generator)
        self.embed = param((cfg.vocab_padded, d), cfg.dtype, scale=0.02, **kw)
        self.out = param((d, cfg.vocab_padded), cfg.dtype, scale=0.02, **kw)
        self.ln_f = param((d,), torch.float32, dev, None, fill=1.0)
        kinds = block_kinds(cfg)
        self.blocks = nn.ModuleList(
            Block(cfg, kinds[i % len(kinds)], mesh=mesh, **kw)
            for i in range(cfg.n_layers))
        self.enc_blocks = None
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                Block(cfg, "enc", **kw) for _ in range(cfg.n_enc_layers))
            self.enc_ln_f = param((d,), torch.float32, dev, None, fill=1.0)
        cos = sin = None
        if any(k in ATTN_KINDS for k in kinds):   # once per model
            cos, sin = init_rope(cfg.d_head, MAX_ROPE, cfg.rope_theta,
                                 device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def rope(self):
        return (self.rope_cos, self.rope_sin)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self, x):
        return rms_norm(x, self.ln_f, self.cfg.norm_eps) @ self.out

    def _encode(self, enc_frames, remat: bool = False):
        """The enc-dec family's encoder over frame embeddings [B, Te, d]
        (reference ``_encode``): RoPE over the frame positions, whose
        table rows equal the model's own; None for other families.
        ``remat`` recomputes each encoder block in the backward, as
        :meth:`forward` does the decoder's."""
        if self.enc_blocks is None:
            return None
        if enc_frames is None:
            raise ValueError(f"{self.cfg.name}: the encdec family needs "
                             f"enc_frames")
        e = enc_frames.to(self.cfg.dtype)
        B, Te, _ = e.shape
        epos = torch.arange(Te, device=e.device).expand(B, Te)
        for blk in self.enc_blocks:
            e, _ = _run(blk, remat, e, self.rope, epos)
        return rms_norm(e, self.enc_ln_f, self.cfg.norm_eps)

    def forward(self, tokens, *, prefix_embed=None, enc_frames=None,
                with_aux: bool = False, remat: bool = False):
        """Training / prefill forward.  tokens: [B, S] int; prefix_embed:
        [B, Np, d] VLM patch embeddings put before the tokens' (positions
        run over all ``Np + S``); enc_frames: [B, Te, d] the enc-dec
        family's frame embeddings.  Returns logits [B, Np + S,
        vocab_padded], and with ``with_aux`` also the summed MoE aux loss
        (a 0-d f32 tensor), as the reference returns ``(logits, aux)``.

        Differentiable; the serving callers run it under
        ``torch.no_grad()``.  ``remat`` recomputes each block in the
        backward instead of keeping its activations (the reference's
        ``jax.checkpoint`` of its scan unit)."""
        # F.embedding, not indexing: its backward sums each row's tokens in
        # a fixed order on the CPU and on the card (indexing's backward on
        # the CPU adds with atomics, so the same step gave other bits run
        # to run; PORT.md, "Hybrid training")
        x = torch.nn.functional.embedding(tokens.long(), self.embed)
        if prefix_embed is not None:
            x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        enc_out = self._encode(enc_frames, remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device) \
            if with_aux else None
        for blk in self.blocks:
            x, a = _run(blk, remat, x, self.rope, positions,
                        with_aux=with_aux, enc_out=enc_out)
            if a is not None:
                aux = aux + a
        logits = self._head(x)
        return (logits, aux) if with_aux else logits

    def stacked_groups(self) -> list[list[str]]:
        """Parameter names grouped as the reference stacks them into one
        leaf of its tree: a block parameter over the layers that share
        its position in the scan unit, an encoder block parameter over
        the encoder layers, every other parameter alone."""
        u = len(block_kinds(self.cfg))
        groups: dict[tuple, list[str]] = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            key = (("blocks", int(parts[1]) % u, *parts[2:])
                   if parts[0] == "blocks" else
                   ("enc_blocks", *parts[2:]) if parts[0] == "enc_blocks"
                   else (name,))
            groups.setdefault(key, []).append(name)
        return list(groups.values())

    def sharded_params(self) -> set:
        """Names of the parameters this rank holds a block of, split over
        the mesh's 'model' axis (the MoE layers' expert rows); empty
        without a split."""
        return {name for name, _ in self.named_parameters()
                if ".moe." in name and name.rsplit(".", 1)[-1] in
                EXPERT_ROWS and self.blocks[int(name.split(".")[1])]
                .moe.split is not None}

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Decode cache: ``{"layers": [one dict per layer], "len": int}``;
        an attention layer (``attn``, ``attn_moe``, ``dec``) holds
        ``k``/``v`` [batch, max_len, n_kv, d_head], a Mamba layer ``conv``
        [batch, 3, 2 d] and ``ssm`` [batch, 2 d, d_state] f32, an RWKV
        layer ``shift``/``cshift`` [batch, d] and ``wkv`` [batch, H, 64,
        64] f32."""
        cfg, dev = self.cfg, self.device
        d = cfg.d_model

        def zeros(*shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        layers = []
        for blk in self.blocks:
            if blk.kind in ATTN_KINDS:
                shape = (batch, max_len, cfg.n_kv, cfg.d_head)
                layers.append({n: zeros(*shape) for n in "kv"})
            elif blk.kind == "rwkv":
                H = d // ssm.HD
                layers.append({
                    "shift": zeros(batch, d),
                    "wkv": zeros(batch, H, ssm.HD, ssm.HD,
                                 dtype=torch.float32),
                    "cshift": zeros(batch, d)})
            else:
                layers.append({
                    "conv": zeros(batch, 3, 2 * d),
                    "ssm": zeros(batch, 2 * d, cfg.d_state,
                                 dtype=torch.float32)})
        return {"layers": layers, "len": 0}

    @torch.no_grad()
    def decode_step(self, tokens, cache, *, enc_frames=None):
        """One decode step.  tokens: [B, 1]; enc_frames as in ``forward``
        (the enc-dec family encodes them in every step, as the reference
        does).  Updates ``cache`` in place (the reference donates it) and
        returns (logits [B, 1, V], cache)."""
        return self.decode_embeds(self.embed[tokens.long()], cache,
                                  enc_frames=enc_frames)

    @torch.no_grad()
    def decode_embeds(self, x, cache, *, enc_frames=None):
        """``decode_step`` from embeddings x: [B, 1, d] (a VLM prefix row
        goes through the cache this way)."""
        n = cache["len"]
        x = x.to(self.cfg.dtype)
        B = x.shape[0]
        pos = torch.full((B, 1), n, dtype=torch.long, device=x.device)
        enc_out = self._encode(enc_frames)
        for blk, lc in zip(self.blocks, cache["layers"]):
            x, _ = blk(x, self.rope, pos, cache=lc, cache_len=n,
                       enc_out=enc_out)
        cache["len"] = n + 1
        return self._head(x), cache
