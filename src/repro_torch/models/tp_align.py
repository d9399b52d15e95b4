"""GQA head alignment for tensor parallelism: the port of
``repro.models.tp_align``.

Head-sharded TP needs ``n_heads % tp == 0`` and ``n_kv % tp == 0``.
Where a config breaks that (Phi-3's 40 / 10 heads at tp 16), the aligned
config pads the heads so that both divide, function-exactly:

1. *kv replication*: when ``tp % n_kv == 0``, each kv head is repeated
   ``r = tp / n_kv`` times (wk / wv columns duplicated), and query group
   ``g`` of kv head ``i`` attends to copy ``i * r + g // G'``, which holds
   the same k / v.
2. *dead-head padding*: otherwise ``n_kv`` is padded up to a multiple of
   tp with zero kv heads, and each group's query count ``G`` up to
   ``G' = ceil(G / r)``.  A dead query head has zero wq columns and zero
   wo rows: it adds exactly 0 to the output and gets exactly 0 gradient.

:func:`aligned` returns the padded config with ``head_maps``;
``common.Attention`` then draws the exact config's weights and expands
them with :func:`expand_attn_params`.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def plan(n_heads: int, n_kv: int, tp: int) -> dict:
    """The aligned head layout for a tp-way model axis: padded counts, the
    replication ``r``, the padded group ``G`` and each padded head's
    source head (-1: dead)."""
    G = n_heads // n_kv
    if n_kv % tp == 0 and n_heads % tp == 0:
        return {"n_heads": n_heads, "n_kv": n_kv, "r": 1, "G": G,
                "q_src": list(range(n_heads)), "kv_src": list(range(n_kv)),
                "noop": True}
    if tp % n_kv == 0:
        r = tp // n_kv
        kv_pad = n_kv * r                  # pure replication
    else:
        r = 1
        kv_pad = math.ceil(n_kv / tp) * tp  # dead-kv padding
    Gp = math.ceil(G / r)
    kv_src = [j // r if j // r < n_kv else -1 for j in range(kv_pad)]
    q_src = []
    for j in range(kv_pad):
        for s in range(Gp):
            if kv_src[j] < 0:
                q_src.append(-1)
                continue
            # slot within the original group of G query heads
            slot = (j % r) * Gp + s if r > 1 else s
            q_src.append(kv_src[j] * G + slot if slot < G else -1)
    return {"n_heads": kv_pad * Gp, "n_kv": kv_pad, "r": r, "G": Gp,
            "q_src": q_src, "kv_src": kv_src, "noop": False}


def aligned(cfg, tp: int):
    """``cfg`` with TP-aligned head counts and ``head_maps = (q_src,
    kv_src, exact n_heads, exact n_kv)``; ``cfg`` itself when it is
    aligned already."""
    pl = plan(cfg.n_heads, cfg.n_kv, tp)
    if pl["noop"]:
        return cfg
    return dataclasses.replace(cfg, n_heads=pl["n_heads"], n_kv=pl["n_kv"],
                               head_maps=(tuple(pl["q_src"]),
                                          tuple(pl["kv_src"]),
                                          cfg.n_heads, cfg.n_kv))


def expand_attn_params(p_exact: dict, q_src, kv_src, d_head: int) -> dict:
    """The exact config's attention weights (``wq``, ``wk``, ``wv`` [d,
    heads * d_head], ``wo`` [heads * d_head, d], biases optional) in the
    padded layout; a dead slot (source -1) is exact zeros."""
    def take(w, srcs, dim: int):
        """The d_head-wide segments of ``w`` along ``dim``, by source."""
        shape = list(w.shape)
        segs = w.reshape(*shape[:dim], -1, d_head, *shape[dim + 1:])
        idx = torch.tensor([max(s, 0) for s in srcs], device=w.device)
        live = torch.tensor([s >= 0 for s in srcs], device=w.device)
        live = live.reshape([-1 if i == dim else 1
                             for i in range(segs.dim())])
        out = torch.where(live, segs.index_select(dim, idx),
                          torch.zeros((), dtype=w.dtype, device=w.device))
        shape[dim] = len(srcs) * d_head
        return out.reshape(shape)

    out = {"wq": take(p_exact["wq"], q_src, 1),
           "wk": take(p_exact["wk"], kv_src, 1),
           "wv": take(p_exact["wv"], kv_src, 1),
           "wo": take(p_exact["wo"], q_src, 0)}
    if "bq" in p_exact:
        out["bq"] = take(p_exact["bq"], q_src, 0)
        out["bk"] = take(p_exact["bk"], kv_src, 0)
        out["bv"] = take(p_exact["bv"], kv_src, 0)
    return out
