"""Serve-step factories: the port of ``repro.train.step``'s
``make_prefill_step`` and ``make_serve_step``.  The loss and the train
step wait for the training slice (ROADMAP.md queue 1, "The rest of the
model zoo")."""
from __future__ import annotations

from repro_torch.models.lm import LM


def make_prefill_step(model: LM, max_len: int):
    """Serve prefill: ``batch["tokens"]`` [B, S] (and, for the VLM family,
    ``batch["prefix_embed"]`` [B, Np, d]; for the enc-dec family,
    ``batch["enc_frames"]`` [B, Te, d]) -> logits of the last position
    [B, 1, V].  As in the reference, it is the full forward and populates
    no cache; ``max_len`` is kept for the reference's signature."""
    family = model.cfg.family

    def prefill(batch):
        kw = {}
        if family == "vlm":
            kw["prefix_embed"] = batch["prefix_embed"]
        if family == "encdec":
            kw["enc_frames"] = batch["enc_frames"]
        return model(batch["tokens"], **kw)[:, -1:]

    return prefill


def make_serve_step(model: LM):
    """One-token decode step: ``serve_step(cache, batch) -> (logits
    [B, 1, V], cache)``, with ``batch["enc_frames"]`` for the enc-dec
    family; the cache is updated in place (the reference donates it)."""
    encdec = model.cfg.family == "encdec"

    def serve_step(cache, batch):
        kw = {"enc_frames": batch["enc_frames"]} if encdec else {}
        return model.decode_step(batch["tokens"], cache, **kw)

    return serve_step
