"""Checkpoint manager: atomic, keep-N, async: the port of
``repro.ckpt.manager``.

Layout:  <dir>/step_<N>.tmp/ -> (atomic rename) -> <dir>/step_<N>/
  leaves.npz            one array per leaf, named by its path in the tree
  meta.json             step, leaf names, true dtypes, time

A tree is a tuple, list or dict of trees, an ``nn.Module`` (its
parameters by name), an ``AdamWState`` (its ``m``, ``v``, ``step`` and
``err``), a tensor, a numpy array or None.  A leaf's name joins its path
with ``/``: ``0/blocks.3.attn.wq`` is the model's parameter, ``1/m/...``
its first AdamW moment.  numpy has no bfloat16: such a leaf is stored as
its ``uint16`` bits with its true dtype in the meta, and read back
without ``ml_dtypes``.  ``save`` copies every leaf to the host before its
writer thread starts, so training may go on and overwrite the tensors.

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
        if self.async_write and not blocking:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **{n: a for n, (a, _) in host.items()})
        (tmp / "meta.json").write_text(json.dumps({
            "step": step, "n_leaves": len(host), "names": list(host),
            "dtypes": [d for _, d in host.values()], "time": time.time()}))
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
        parameters are written in place and the module returned."""
        path = self.dir / f"step_{step:08d}"
        data = np.load(path / "leaves.npz")
        meta = json.loads((path / "meta.json").read_text())
        dtypes = dict(zip(meta["names"], meta["dtypes"]))
        names = [n for n, _ in _items(like_tree)]
        saved = set(meta["names"])
        if set(names) != saved:
            raise ValueError(f"checkpoint step {step} holds other leaves: "
                             f"only saved {sorted(saved - set(names))}, "
                             f"only asked {sorted(set(names) - saved)}")

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
