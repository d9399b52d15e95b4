"""Checkpoint manager: atomic, keep-N, async: the port of
``repro.ckpt.manager``, in its layout, so that either package restores
the other's checkpoints.

Layout:  <dir>/step_<N>.tmp/ -> (atomic rename) -> <dir>/step_<N>/
  leaves.npz            leaf_0 .. leaf_N, one array per leaf
  meta.json             step, leaf count, true dtypes, treedef, time;
                        here also each leaf's path

A tree is a tuple, list or dict of trees, an ``nn.Module`` (its
parameters by name), an ``AdamWState`` (its ``m``, ``v``, ``step`` and
``err``), a tensor, a numpy array or None.  Its leaves are stored in
the order ``jax.tree.flatten`` gives the reference's tree of the same
state: dict keys sorted; tuples, lists and ``AdamWState``'s fields in
order; None no leaf; an ``LM``'s parameters, and the AdamW dicts keyed
by their names, in ``models.convert.ref_layout``'s tree (``blocks`` a
list over the scan unit's positions, each leaf stacked over units).
``treedef`` is the reference's tree printed as jax prints it; ``paths``
name the leaves (``0/blocks/0/attn/wq``, ``1/m/embed``).  numpy has no
bfloat16: such a leaf is stored as its ``uint16`` bits with
``"bfloat16"`` in ``dtypes``, as the reference stores it, and read back
without ``ml_dtypes``.  ``save`` copies every leaf to the host before
its writer thread starts, so training may go on and overwrite the
tensors.

Fault-tolerance pieces: atomic rename (no torn checkpoints), keep_n
pruning, an async background writer, and a watchdog helper for
straggler/hang detection.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import ref_layout
from repro_torch.models.lm import LM
from repro_torch.train.optim import AdamWState


_LEAF = (torch.Tensor, np.ndarray)


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _children(tree) -> list:
    """(key, subtree) of a tree that is not a leaf, in a fixed order."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, AdamWState):
        return list(tree._asdict().items())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    raise TypeError(f"checkpoint leaf of type {type(tree).__name__}")


def _items(tree, path: str = ""):
    """(name, leaf) of every leaf of ``tree``, in a fixed order."""
    if isinstance(tree, _LEAF):
        yield path or "leaf", tree
    elif tree is not None:
        for k, sub in _children(tree):
            yield from _items(sub, _join(path, k))


def _model_cfg(tree):
    """The config of the ``LM`` the tree holds, or None."""
    if isinstance(tree, LM):
        return tree.cfg
    if tree is None or isinstance(tree, _LEAF):
        return None
    for _, sub in _children(tree):
        cfg = _model_cfg(sub)
        if cfg is not None:
            return cfg
    return None


class _Stacked:
    """A leaf of the reference's tree that holds port leaves: their
    :func:`_items` names, stacked on a new first axis or (``stacked``
    False) the one leaf as it is."""

    def __init__(self, names: list, stacked: bool):
        self.names, self.stacked = names, stacked


def _named(layout, prefix: str):
    """``models.convert.ref_layout``'s tree with each leaf a
    :class:`_Stacked` of the names under ``prefix``."""
    if isinstance(layout, dict):
        return {k: _named(v, prefix) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_named(v, prefix) for v in layout]
    if isinstance(layout, tuple):
        return _Stacked([_join(prefix, n) for n in layout], True)
    return _Stacked([_join(prefix, layout)], False)


def _ref_plan(tree, cfg, path: str = ""):
    """``(treedef, leaves)`` of ``tree`` in the reference's layout:
    ``treedef`` as ``jax.tree.flatten`` prints the reference's tree, and
    per leaf, in its flatten order, ``(path, names, stacked)`` (see
    :class:`_Stacked`).  ``cfg`` is the tree's ``LM``'s config."""
    if tree is None:
        return "None", []
    if isinstance(tree, _Stacked):
        return "*", [(path, tree.names, tree.stacked)]
    if isinstance(tree, _LEAF):
        return "*", [(path, [path or "leaf"], False)]
    if cfg is None and isinstance(tree, (nn.Module, AdamWState)):
        raise ValueError("the reference's layout of a model or its AdamW "
                         "state needs the LM in the tree")
    if isinstance(tree, nn.Module):
        return _ref_plan(_named(ref_layout(
            cfg, dict(tree.named_parameters())), path), cfg, path)
    kids = _children(tree)
    if isinstance(tree, AdamWState):
        kids = [(k, _named(ref_layout(cfg, sub), _join(path, k))
                 if isinstance(sub, dict) else sub) for k, sub in kids]
    elif isinstance(tree, dict):
        kids = sorted(kids, key=lambda kv: kv[0])
    parts = [_ref_plan(sub, cfg, _join(path, k)) for k, sub in kids]
    leaves = [x for _, xs in parts for x in xs]
    if isinstance(tree, AdamWState):
        return ("CustomNode(namedtuple[AdamWState], ["
                + ", ".join(t for t, _ in parts) + "])", leaves)
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {t}" for (k, _), (t, _) in
                               zip(kids, parts)) + "}", leaves
    body = ", ".join(t for t, _ in parts)
    if isinstance(tree, list):
        return f"[{body}]", leaves
    return f"({body}{',' if len(parts) == 1 else ''})", leaves


def _to_host(x) -> tuple[np.ndarray, str]:
    """(stored array, true dtype name) of one leaf."""
    if isinstance(x, np.ndarray):
        return np.array(x), x.dtype.name
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.contiguous().view(torch.int16).numpy().view(
            np.uint16).copy(), "bfloat16"
    return x.numpy().copy(), x.numpy().dtype.name


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _unstack(step: int, data, meta: dict, leaves: list, like: dict):
    """The checkpoint's arrays and true dtypes keyed by the
    :func:`_items` names of the tree whose plan is ``leaves`` (each
    stacked leaf cut along its first axis); ``like`` holds the tree's
    leaves by name."""
    arrays, dtypes = {}, {}
    for i, (where, names, stacked) in enumerate(leaves):
        arr, dtype = data[f"leaf_{i}"], meta["dtypes"][i]
        first = like[names[0]]
        want = tuple(first.shape)
        if stacked:
            want = (len(names),) + want
        have = (first.dtype.name if isinstance(first, np.ndarray)
                else str(first.dtype).removeprefix("torch."))
        if arr.shape != want or dtype != have:
            raise ValueError(
                f"checkpoint step {step}: leaf {i} ({where}) is {dtype} "
                f"{arr.shape}, the tree's {have} {want}")
        for j, n in enumerate(names):
            arrays[n] = arr[j] if stacked else arr
            dtypes[n] = dtype
    return arrays, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False) -> None:
        host = {n: _to_host(x) for n, x in _items(tree)}
        plan = _ref_plan(tree, _model_cfg(tree))
        if self.async_write and not blocking:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, plan), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, plan)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, plan) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        treedef, leaves = plan
        arrays = [np.stack([host[n][0] for n in names]) if stacked
                  else host[names[0]][0] for _, names, stacked in leaves]
        np.savez(tmp / "leaves.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        (tmp / "meta.json").write_text(json.dumps({
            "step": step, "n_leaves": len(leaves),
            "dtypes": [host[names[0]][1] for _, names, _ in leaves],
            "treedef": f"PyTreeDef({treedef})",
            "paths": [w for w, _, _ in leaves], "time": time.time()}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree):
        """Restore into the structure of ``like_tree``: each leaf on its
        like-leaf's device (numpy leaves stay numpy); an ``nn.Module``'s
        parameters are written in place and the module returned.  Reads
        the reference's checkpoints too.  A checkpoint whose leaf count,
        shapes, dtypes or (where it records them) paths differ from the
        tree's raises ``ValueError``."""
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        _, leaves = _ref_plan(like_tree, _model_cfg(like_tree))
        want = [w for w, _, _ in leaves]
        if meta["n_leaves"] != len(leaves) or \
                meta.get("paths", want) != want:
            raise ValueError(f"checkpoint step {step} holds other leaves: "
                             f"{meta.get('paths', meta['n_leaves'])}, the "
                             f"tree {want}")
        data, dtypes = _unstack(step, np.load(path / "leaves.npz"), meta,
                                leaves, dict(_items(like_tree)))

        def leaf(name, like):
            arr = data[name]
            if isinstance(like, np.ndarray):
                return arr.view(like.dtype) if dtypes[name] == "bfloat16" \
                    else arr
            return _from_host(arr, dtypes[name]).to(like.device)

        def build(tree, path=""):
            if tree is None:
                return None
            if isinstance(tree, _LEAF):
                return leaf(path or "leaf", tree)
            kids = [(k, build(sub, _join(path, k)))
                    for k, sub in _children(tree)]
            if isinstance(tree, nn.Module):
                with torch.no_grad():
                    for (_, p), (_, new) in zip(_children(tree), kids):
                        p.copy_(new)
                return tree
            if isinstance(tree, AdamWState):
                return AdamWState(**dict(kids))
            if isinstance(tree, dict):
                return dict(kids)
            return type(tree)(v for _, v in kids)
        return build(like_tree)


class Watchdog:
    """Step-liveness watchdog (straggler/hang mitigation hook).

    At cluster scale, the per-host agent kills + restarts from the last
    checkpoint when a step exceeds `timeout_s`; here the callback fires for
    the test harness."""

    def __init__(self, timeout_s: float, on_stall=None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (lambda: None)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    @property
    def stalls(self) -> int:
        return self._fired

    def _loop(self):
        while not self._stop.wait(self.timeout_s / 4):
            if time.monotonic() - self._last > self.timeout_s:
                self._fired += 1
                self._last = time.monotonic()
                self.on_stall()
