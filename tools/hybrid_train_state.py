#!/usr/bin/env python3
"""Jamba-1.5-Large's training state a rank, by depth, from the dry run.

    PYTHONPATH=src python3 tools/hybrid_train_state.py

For the first 1 to 8 layers of its 8-layer unit (attention + MLP, then
Mamba layers, every second one with 16 experts), the model is built on
the ``meta`` device on a ``{data: 1, model: 4}`` mesh as the port places
it (``launch/dryrun.py``: only the expert rows split over 'model') and
its training state a rank is summed: the weights (bf16, the norms'
scales, router and Mamba's f32 vectors in f32), gradients of the same
dtypes, AdamW's f32 ``m`` and ``v`` and its step.  Prints one Markdown
row a depth: layers, the kinds added, parameters a rank, state GB, and
what an 80 GB card has left for activations.  Nothing is allocated and
no step runs (``launch/dryrun.py``'s train records add the step's temp).
"""
from __future__ import annotations

import dataclasses

from repro_torch import configs as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import block_kinds


def main() -> None:
    base = C.get_config("jamba_1_5_large")
    kinds = block_kinds(base)
    mesh = Mesh({"data": 1, "model": 4})
    print(f"| layers | adds | parameters a rank | state GB a rank | left of "
          f"{DR.CARD_BYTES / 1e9:.0f} GB |")
    print("|---|---|---|---|---|")
    for n in range(1, len(kinds) + 1):
        cfg = dataclasses.replace(base, n_layers=n)
        model, opt, _ = DR.build(cfg, "train", 1, 1, mesh)
        placed = DR.placed_bytes(model, opt)
        # weights, their gradients (same dtypes), m, v and the step
        state = 2 * placed["param_bytes"] + placed["opt_bytes"]
        print(f"| {n} | {kinds[n - 1]} | {placed['params']:,} | "
              f"{state / 1e9:.2f} | {(DR.CARD_BYTES - state) / 1e9:.2f} |")


if __name__ == "__main__":
    main()
