"""Sharding rules: parameter specs, batch specs, cache specs (the port of
``repro.launch.shardings``, without ``jax``).

TP over 'model' (heads / ffn / vocab), DP over ('pod', 'data'); MoE
experts go over 'model' when the expert count divides it (expert
parallelism), else TP-within-expert over the f dimension.  Long-context
decode shards the KV sequence axis over ('data', 'model').

A spec is a tuple with one entry a dimension: an axis name, ``None``
(replicated) or a tuple of names (the dimension split over their
product, row-major), as ``tuple(PartitionSpec(...))`` gives them.  The
mesh is anything with ``.shape`` (name -> size) and ``.axis_names``.

At run time the port splits only the expert rows, by the rule written
here for ``moe/w_(gate|up|down)``; ``models.moe.expert_dim`` applies it
without reading this table, and the tests hold the two equal.  The rest
of the rules serve the dry run.
"""
from __future__ import annotations

import math
import re


def _param_rules(cfg, n_model: int):
    """(regex on the '/'-joined path, spec); the first match wins."""
    moe_ep = cfg.moe is not None and cfg.moe.n_experts % max(n_model, 1) == 0
    e_axis = "model" if moe_ep else None
    f_axis = None if moe_ep else "model"
    return [
        (r"embed$", ("model", None)),
        (r"out$", (None, "model")),
        (r"attn/w[qkv]$", (None, "model")),
        (r"attn/wo$", ("model", None)),
        (r"attn/b[qkv]$", ("model",)),
        (r"xattn/w[qkv]$", (None, "model")),
        (r"xattn/wo$", ("model", None)),
        (r"mlp/w_(gate|up)$", (None, "model")),
        (r"mlp/w_down$", ("model", None)),
        (r"moe/router$", (None, None)),
        (r"moe/w_(gate|up)$", (e_axis, None, f_axis)),
        (r"moe/w_down$", (e_axis, f_axis, None)),
        (r"moe/shared/w_(gate|up)$", (None, "model")),
        (r"moe/shared/w_down$", ("model", None)),
        (r"mamba/in_proj$", (None, "model")),
        (r"mamba/conv_w$", (None, "model")),
        (r"mamba/x_proj$", ("model", None)),
        (r"mamba/(dt_bias|D)$", ("model",)),
        (r"mamba/A_log$", ("model", None)),
        (r"mamba/out_proj$", ("model", None)),
        (r"tmix/t_mix$", (None, "model")),
        (r"tmix/w[rkvg]$", (None, "model")),
        (r"tmix/ww$", (None, None)),
        (r"tmix/ww2$", (None, "model")),
        (r"tmix/(w_bias|u)$", ("model",)),
        (r"tmix/wo$", ("model", None)),
        (r"cmix/t_mix$", (None, "model")),
        (r"cmix/wk$", (None, "model")),
        (r"cmix/wv$", ("model", None)),
        (r"ln", (None,)),
        (r".*", (None,)),
    ]


def _extent(mesh, ax) -> int:
    if isinstance(ax, str):
        return mesh.shape.get(ax, 1)
    return math.prod(mesh.shape[a] for a in ax)


def _dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _entry(axes: tuple):
    """A spec entry for ``axes``: one name alone, as ``PartitionSpec``
    writes ``("data",)``."""
    return axes[0] if len(axes) == 1 else axes


def leaf_spec(cfg, path: str, shape, mesh, *, stacked: bool = False,
              fsdp: bool = False, fsdp_min_elems: int = 1 << 22) -> tuple:
    """The spec of the parameter at ``path`` ('/'-joined, the reference's
    tree path) of ``shape``.  A ``stacked`` leaf (a block parameter
    stacked over scan units) gains a leading None.  A named dimension
    that the axis does not divide is replicated; ``fsdp`` (ZeRO-3 style)
    also splits a leaf of ``fsdp_min_elems`` or more over the data axes,
    along its largest still-replicated dimension that they divide."""
    base = next(spec for pat, spec in _param_rules(
        cfg, mesh.shape.get("model", 1)) if re.search(pat, path))
    ndim, off = len(shape), 1 if stacked else 0
    dims = list(base) + [None] * 8
    out = [None] * ndim
    for i in range(ndim - off):
        out[i + off] = dims[i]
    for i, ax in enumerate(out):       # divisibility guard
        if ax is not None and shape[i] % _extent(mesh, ax) != 0:
            out[i] = None
    dp = _dp(mesh)
    if fsdp and dp and math.prod(shape) >= fsdp_min_elems:
        dp_size = _extent(mesh, dp)
        cands = [(shape[i], i) for i in range(ndim)
                 if out[i] is None and shape[i] % dp_size == 0]
        if cands:
            _, i = max(cands)
            out[i] = _entry(dp)
    return tuple(out)


def param_specs(cfg, shapes: dict, mesh, *, fsdp: bool = False,
                fsdp_min_elems: int = 1 << 22):
    """Spec tree for the port's parameters ``shapes`` (name -> shape, as
    ``{n: p.shape for n, p in model.named_parameters()}``; a model built
    on the ``meta`` device costs nothing), in the reference's tree layout
    (``convert.ref_layout``): a block leaf is stacked over the scan units
    and its spec gains a leading None."""
    from repro_torch.models.convert import ref_layout

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + [str(i)]) for i, v in enumerate(node)]
        stacked = isinstance(node, tuple)
        shape = ((len(node), *shapes[node[0]]) if stacked
                 else tuple(shapes[node]))
        return leaf_spec(cfg, "/".join(path), shape, mesh, stacked=stacked,
                         fsdp=fsdp, fsdp_min_elems=fsdp_min_elems)
    return walk(ref_layout(cfg, shapes), [])


def batch_specs(cfg, mesh, *, batch: int, kind: str) -> dict:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    b_ax = _entry(dp) if batch % _extent(mesh, dp) == 0 else None
    spec = {"tokens": (b_ax, None)}
    if kind == "train":
        spec["labels"] = (b_ax, None)
    if cfg.family == "vlm":
        spec["prefix_embed"] = (b_ax, None, None)
    if cfg.family == "encdec":
        spec["enc_frames"] = (b_ax, None, None)
    return spec


def cache_specs(cfg, mesh, *, batch: int, max_len: int):
    """KV cache: batch over data when divisible, sequence over 'model'
    (and over 'data' too for batch=1 long-context).  Returns
    ``spec_for(path, shape)`` over the reference cache tree's paths."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    dp_size = _extent(mesh, dp)
    n_model = mesh.shape.get("model", 1)
    if batch % dp_size == 0:
        b_ax, s_ax = _entry(dp), "model"
    else:
        b_ax, s_ax = None, ((*dp, "model")
                            if max_len % (dp_size * n_model) == 0
                            else "model")

    def spec_for(path: str, shape) -> tuple:
        nd = len(shape)
        if path.endswith("/k") or path.endswith("/v"):
            return (None, b_ax, s_ax, None, None)
        if "mamba" in path or "shift" in path or "wkv" in path:
            # [units, B, ...feature dims]: shard feature dim over model
            out = [None, b_ax] + [None] * (nd - 2)
            if nd >= 3:
                out[2] = "model" if shape[2] % n_model == 0 else None
            return tuple(out)
        return (None,) * nd

    return spec_for

