"""Serve-step factories: the port of ``repro.train.step``'s
``make_prefill_step`` and ``make_serve_step``.  The loss and the train
step wait for the training slice (ROADMAP.md queue 1, "The rest of the
model zoo")."""
from __future__ import annotations

from repro_torch.models.lm import LM


def make_prefill_step(model: LM, max_len: int):
    """Serve prefill: ``batch["tokens"]`` [B, S] (and, for the VLM family,
    ``batch["prefix_embed"]`` [B, Np, d]) -> logits of the last position
    [B, 1, V].  As in the reference, it is the full forward and populates
    no cache; ``max_len`` is kept for the reference's signature."""
    vlm = model.cfg.family == "vlm"

    def prefill(batch):
        kw = {"prefix_embed": batch["prefix_embed"]} if vlm else {}
        return model(batch["tokens"], **kw)[:, -1:]

    return prefill


def make_serve_step(model: LM):
    """One-token decode step: ``serve_step(cache, batch) -> (logits
    [B, 1, V], cache)``; the cache is updated in place (the reference
    donates it)."""
    def serve_step(cache, batch):
        return model.decode_step(batch["tokens"], cache)

    return serve_step
