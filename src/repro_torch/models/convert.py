"""Carry weights, AdamW state and decode state from the JAX reference
into the port, and the port's parameters (or gradients, or moments) back
to the reference's tree layout.

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
from repro_torch.models.moe import EXPERT_ROWS, MoE, local_rows
from repro_torch.train.optim import AdamWState


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


def _port_names(cfg: ModelCfg, tree) -> dict:
    """The reference tree ``tree`` (parameters, or any tree of their
    layout: AdamW moments, gradients) flattened to the port's parameter
    names."""
    _, u = scan_unit(cfg)
    flat = {k: tree[k] for k in ("embed", "out", "ln_f", "enc_ln_f")
            if k in tree}
    for l in range(cfg.n_layers):
        for k, v in _flatten(_layer(tree["blocks"], l, u)):
            flat[f"blocks.{l}.{k}"] = v
    for e in range(cfg.n_enc_layers if "enc_blocks" in tree else 0):
        for k, v in _flatten(_index(tree["enc_blocks"], e)):
            flat[f"enc_blocks.{e}.{k}"] = v
    return flat


def from_jax_params(cfg: ModelCfg, tree, *, device=None, mesh=None) -> LM:
    """An ``LM`` holding the reference parameter tree ``tree`` (a padded
    config's tree, ``tp_align``, onto the padded model alike); on a
    ``mesh``, each MoE expert weight's rank block only."""
    model = LM(cfg, device=device, mesh=mesh)
    flat = _port_names(cfg, tree)
    own = dict(model.named_parameters())
    if own.keys() != flat.keys():
        raise ValueError(f"parameter names differ: only in the port "
                         f"{sorted(own.keys() - flat.keys())}, only in the "
                         f"tree {sorted(flat.keys() - own.keys())}")
    for name, p in own.items():
        t = to_tensor(flat[name], device=p.device)
        parent, _, leaf = name.rpartition(".")
        if isinstance(model.get_submodule(parent), MoE) and \
                leaf in EXPERT_ROWS and mesh is not None:
            t = local_rows(cfg, leaf, t, mesh)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(t.shape)} {t.dtype}, "
                             f"the port {tuple(p.shape)} {p.dtype}")
        p.data.copy_(t)
    return model


def opt_from_jax(cfg: ModelCfg, state, model: LM):
    """The port's ``AdamWState`` (``repro_torch.train.optim``) holding the
    reference's ``AdamWState`` ``state`` (numpy leaves), on the model's
    device and keyed by its parameter names."""
    own = dict(model.named_parameters())

    def tensors(tree):
        flat = _port_names(cfg, tree)
        if flat.keys() != own.keys():
            raise ValueError("the state's tree does not match the model")
        return {n: to_tensor(flat[n], device=own[n].device) for n in own}
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=model.device)
    return AdamWState(m=tensors(state.m), v=tensors(state.v), step=step,
                      err=None if state.err is None else tensors(state.err))


def ref_layout(cfg: ModelCfg, names) -> dict:
    """The reference's tree layout of the port's parameter ``names`` (or
    any names of their layout: gradients, AdamW moments): ``blocks`` a
    list over the scan unit's positions, ``enc_blocks`` one tree.  A leaf
    stacked over units (encoder layers) holds the tuple of the port names
    stacked into it, in order; any other leaf holds its name."""
    _, u = scan_unit(cfg)

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value
    out, blocks, enc = {}, [{} for _ in range(u)], {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks":
            l = int(parts[1])
            put(blocks[l % u], parts[2:] + [l // u], name)
        elif parts[0] == "enc_blocks":
            put(enc, parts[2:] + [int(parts[1])], name)
        else:
            out[name] = name

    def stack(tree):
        if all(isinstance(k, int) for k in tree):
            return tuple(tree[i] for i in range(len(tree)))
        return {k: stack(v) for k, v in tree.items()}
    out["blocks"] = [stack(b) for b in blocks]
    if enc:
        out["enc_blocks"] = stack(enc)
    return out


def to_numpy_tree(model: LM, named: dict | None = None) -> dict:
    """The model's parameters, or ``named`` (tensors keyed by its
    parameter names: gradients, AdamW moments), as the reference's tree
    (:func:`ref_layout`).  Leaves are numpy, bf16 ones widened to f32
    (exactly)."""
    if named is None:
        named = dict(model.named_parameters())

    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, tuple):
            return np.stack([arr(named[n]) for n in node])
        return arr(named[node])
    return build(ref_layout(model.cfg, named))


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
