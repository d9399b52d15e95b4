#!/usr/bin/env python3
"""Phase 5b (the Mamba scan's kernels) and phase 6b (training, card
against CPU) of ``chip_smoke.py`` alone, from the checkout this file is
in, on one card:

    python3 tools/smoke_phases.py [5b] [6b] [--arch NAME ...]

``--arch`` narrows 6b to the named reduced configs (default: all of
``chip_smoke.TRAIN_CARD_VS_CPU``).  A failed check exits non-zero with
``chip_smoke``'s message, as the whole script does.  6b's ``dt_bias``
rule depends on run-to-run gaps, so a loop over this command on one host
counts how often it holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=("5b", "6b"))
    ap.add_argument("--arch", action="append", default=[])
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch import configs as C
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as KREF
    from repro_torch.models.lm import LM
    from repro_torch.train import optim as OPT
    from repro_torch.train import step as STEP
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(CS.card_line(), flush=True)
    print(CS.host_line(), flush=True)
    libs = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "5b" in args.phases:
        lib = ctypes.CDLL(str(libs["mamba_scan"]))
        out = CS.check_mamba_scan(ops, KREF, torch, np,
                                  _build.BUILD_INFO.get("ptxas", {}),
                                  lib.mamba_scan_bwd_blocks_per_sm,
                                  lib.mamba_scan_fwd_blocks_per_sm,
                                  lib.mamba_scan_fwd_channels)
        print("5b " + json.dumps(out, default=str), flush=True)
    if "6b" in args.phases:
        if args.arch:
            CS.TRAIN_CARD_VS_CPU = tuple(args.arch)
        t1 = time.perf_counter()
        counts = CS.train_card_vs_cpu(C, LM, STEP, OPT, ops, torch, np)
        print(f"6b {', '.join(CS.TRAIN_CARD_VS_CPU)} passed in "
              f"{time.perf_counter() - t1:.1f} s; launches {counts}",
              flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
