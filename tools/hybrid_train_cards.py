#!/usr/bin/env python3
"""Phase 10c of ``chip_smoke.py`` alone, and its phase-11 line: Jamba-1.5-
Large at 3 of its 72 layers trained 8 steps of 2 x 2,048 tokens over NCCL
on a ``{data: 1, model: 4}`` mesh, one spawned rank a card, then the dry
run's estimate of that step on ``meta`` against each rank's live tensors
and peak.

    python3 tools/hybrid_train_cards.py [--profile]

Needs four cards (with fewer it prints that phase 10c did not run).
``--profile`` adds the NCCL kernels' device time and the top kernels of
one step on rank 0.  It builds the kernels first, so the ranks reuse the
build.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    import torch

    import chip_smoke as CS
    from repro_torch import configs as C
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this script needs "
                "cards")
    card = CS.card_line()
    print(card, flush=True)
    _build.build()
    hybrid = CS.hybrid_path("--profile" in sys.argv[1:], card, torch)
    if hybrid is not None:
        CS.dryrun_hybrid(C, DR, hybrid, card)


if __name__ == "__main__":
    main()
