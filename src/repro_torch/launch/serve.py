"""Batched serving driver: the port of ``repro.launch.serve``, with the
reference's semantics (continuous batching over a fixed decode batch,
per-request generation lengths, a cache length shared by every slot).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b \\
      --requests 12 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.train.step import make_serve_step


class Server:
    """Slot-based continuous batching over a fixed decode batch.  Runs on
    the card unless ``device`` names another (on a ``mesh``, the mesh's
    device); weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` on that device, and on a ``mesh`` each rank keeps only its
    MoE expert rows (``models.lm.LM``): every rank runs the same requests
    and gives the same tokens.  ``n_layers``
    cuts the config's depth (its widths stay), for a model whose every
    layer does not fit the card.  The enc-dec family is refused: the
    reference's ``Server`` passes no frames, so its encoder has no
    input; it is served through ``train.step``'s steps instead."""

    def __init__(self, arch: str, *, device=None, slots: int = 4,
                 max_len: int = 96, reduced: bool = True, seed: int = 0,
                 n_layers: int | None = None, mesh=None):
        dev = resolve_device(device if device is not None or mesh is None
                             else mesh.device)
        self.device = dev
        self.cfg = C.get_reduced(arch) if reduced else C.get_config(arch)
        if self.cfg.family == "encdec":
            raise ValueError(
                f"{arch}: the Server passes no enc_frames, so the encdec "
                f"family's encoder has no input; serve it through "
                f"make_prefill_step / make_serve_step with "
                f"batch['enc_frames']")
        if n_layers is not None:
            self.cfg = dataclasses.replace(self.cfg, n_layers=n_layers)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.model = LM(self.cfg, device=dev, generator=gen, mesh=mesh)
        self.slots = slots
        self.max_len = max_len
        self.cache = self.model.init_cache(slots, max_len)
        self.step = make_serve_step(self.model)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long, device=dev)
        self.active = np.zeros(slots, bool)
        self.remaining = np.zeros(slots, np.int64)
        self.req_of_slot = np.full(slots, -1)
        self.queue: list[tuple[int, np.ndarray, int]] = []
        self.done: dict[int, list[int]] = {}
        self._n_steps = 0

    def submit(self, req_id: int, prompt: np.ndarray, gen: int):
        self.queue.append((req_id, prompt, gen))

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] or not self.queue:
                continue
            req_id, prompt, gen = self.queue.pop(0)
            # the slot starts from the prompt's first token (shared cache
            # len across slots => admission is batched-synchronous per wave)
            self.active[s] = True
            self.remaining[s] = gen + len(prompt)
            self.req_of_slot[s] = req_id
            self.done[req_id] = []
            self.tokens[s, 0] = int(prompt[0])

    def run(self):
        """Drive until all submitted requests complete.  Returns stats."""
        t0 = time.time()
        self._admit()
        while self.active.any() or self.queue:
            logits, self.cache = self.step(self.cache,
                                           {"tokens": self.tokens})
            self._n_steps += 1
            nxt = logits[:, -1, :self.cfg.vocab].argmax(-1).cpu().numpy()
            newly_free = False
            for s in range(self.slots):
                if not self.active[s]:
                    continue
                rid = self.req_of_slot[s]
                self.done[rid].append(int(nxt[s]))
                self.remaining[s] -= 1
                if self.remaining[s] <= 0 or \
                        self.cache["len"] >= self.max_len - 1:
                    self.active[s] = False
                    newly_free = True
            self.tokens = torch.as_tensor(nxt[:, None], dtype=torch.long,
                                          device=self.device)
            if newly_free and self.queue:
                # cache len is shared: recycle only when the wave drains
                if not self.active.any():
                    self.cache = self.model.init_cache(self.slots,
                                                       self.max_len)
                    self._admit()
        wall = time.time() - t0
        return {"steps": self._n_steps, "wall_s": wall,
                "ms_per_step": 1000 * wall / max(self._n_steps, 1),
                "requests": len(self.done)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = Server(args.arch, device=args.device, slots=args.slots)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, srv.cfg.vocab, size=rng.integers(4, 12))
        srv.submit(rid, prompt, args.gen)
    stats = srv.run()
    print(f"[serve] {stats['requests']} requests in {stats['steps']} steps "
          f"({stats['ms_per_step']:.1f} ms/step, wall {stats['wall_s']:.1f}s)")
    tokens = sum(len(v) for v in srv.done.values())
    print(f"[serve] {tokens} tokens generated, "
          f"{tokens / max(stats['wall_s'], 1e-9):.1f} tokens/s on "
          f"{srv.device}")


if __name__ == "__main__":
    main()
