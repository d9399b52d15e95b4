"""Carry weights and decode state from the JAX reference into the port.

The reference's trees hold numpy arrays (``jax.tree.map(np.asarray,
tree)``); nothing here imports jax.  ``params["blocks"]`` is a list, one
entry per position in the scan unit, whose leaves are stacked over units:
layer ``unit * u + pos`` of the port is ``blocks[pos]`` at index
``unit``.  The enc-dec family's ``enc_blocks`` is one tree stacked over
encoder layers: encoder layer ``e`` is index ``e``.  Layouts match, so
nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelCfg
from repro_torch.models.lm import LM, scan_unit


def to_tensor(arr, *, device) -> torch.Tensor:
    """numpy -> torch.  A JAX bf16 array comes out of ``np.asarray`` with
    the ml_dtypes ``bfloat16`` dtype, which ``torch.from_numpy`` refuses:
    its bits go across as int16 and are viewed as ``torch.bfloat16``."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _index(t, i: int):
    """Index ``i`` of every leaf of the stacked tree ``t``."""
    if isinstance(t, dict):
        return {k: _index(v, i) for k, v in t.items()}
    return t[i]


def _layer(stacked, l: int, u: int):
    """Layer ``l``'s slice of the reference's per-position stacked trees."""
    return _index(stacked[l % u], l // u)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def from_jax_params(cfg: ModelCfg, tree, *, device) -> LM:
    """An ``LM`` holding the reference parameter tree ``tree``."""
    model = LM(cfg, device=device)
    _, u = scan_unit(cfg)
    flat = {k: tree[k] for k in ("embed", "out", "ln_f", "enc_ln_f")
            if k in tree}
    for l in range(cfg.n_layers):
        for k, v in _flatten(_layer(tree["blocks"], l, u)):
            flat[f"blocks.{l}.{k}"] = v
    for e in range(cfg.n_enc_layers if "enc_blocks" in tree else 0):
        for k, v in _flatten(_index(tree["enc_blocks"], e)):
            flat[f"enc_blocks.{e}.{k}"] = v
    own = dict(model.named_parameters())
    if own.keys() != flat.keys():
        raise ValueError(f"parameter names differ: only in the port "
                         f"{sorted(own.keys() - flat.keys())}, only in the "
                         f"tree {sorted(flat.keys() - own.keys())}")
    for name, p in own.items():
        t = to_tensor(flat[name], device=p.device)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(t.shape)} {t.dtype}, "
                             f"the port {tuple(p.shape)} {p.dtype}")
        p.data.copy_(t)
    return model


def cache_from_jax(cfg: ModelCfg, tree, *, device) -> dict:
    """The port's decode cache (``LM.init_cache`` layout) holding the
    reference decode cache ``tree``."""
    _, u = scan_unit(cfg)
    layers = []
    for l in range(cfg.n_layers):
        c = _layer(tree["layers"], l, u)
        if "kv" in c:
            d = {"k": c["kv"]["k"], "v": c["kv"]["v"]}
        elif "rwkv" in c:
            d = {"shift": c["rwkv"]["shift"], "wkv": c["rwkv"]["wkv"],
                 "cshift": c["cshift"]}
        elif "mamba" in c:
            d = {"conv": c["mamba"]["conv"], "ssm": c["mamba"]["ssm"]}
        else:
            raise ValueError(f"cache entries {sorted(c)} of family "
                             f"{cfg.family!r}")
        layers.append({k: to_tensor(v, device=device) for k, v in d.items()})
    return {"layers": layers, "len": int(tree["len"])}
