#!/usr/bin/env python3
"""Where a ``weighted_sample`` launch's time goes, on the card.

    PYTHONPATH=src python3 tools/weighted_sample_bench.py [--reps 3]
        [--stamped-src F]

1. Builds ``tools/weighted_sample_floor.cu`` into ``build/ws_bench/``:
   two floor kernels on the sampler's grid, one empty and one that reads
   ``rng`` and ``t`` and writes F ints.
2. With ``--stamped-src F``, a revision of ``csrc/weighted_sample.cu``
   that has the ``WS_STAMPS`` build (commit 1c1de75's: ``git show
   1c1de75:src/repro_torch/kernels/csrc/weighted_sample.cu > F``), builds
   it with ``-DWS_STAMPS``: the kernel then writes, per row, clock64
   stamps after the key, ``u``, the row's loads landing, the prefix, the
   count and the store's issue, and its span on the global timer.  Stamps
   the in-launch prefix at DF-1056's F 1,056 and P 64: the median cycles
   of each stage over the rows, and the SM clock nvidia-smi reads.
3. Runs ugal_l on DF-1056 (``chip_smoke.py`` phase 4's spec) through the
   engine's graph loop with the sampler's place taken in turn by the
   shipped kernel and by each floor kernel, ``--reps`` times in turns,
   and gives the launch's device time a call (torch.profiler) and its
   exposed time (its end less the end of the device event before it:
   what the step's device timeline pays for it, the gap before it
   included), medians over the calls.  The floors change the run's
   paths, and so its steps; the times a call stand.

One JSON line a section, the card's name and power limit in each.  It
needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tools")]

STAGES = ("key", "u", "loads", "prefix", "count", "store")
SAMPLER = re.compile(r"(?:void )?(?:weighted_sample|ws_floor_\w+)_kernel")
OUT = ROOT / "build" / "ws_bench"


def build(src: Path, lib: str, *defines: str) -> ctypes.CDLL:
    """``src`` built as the port builds its tick kernels (``csrc`` on the
    include path), into ``build/ws_bench/lib<lib>.so``."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"lib{lib}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *_build.EXACT, *defines,
           "-I", str(_build.CSRC), "-o", str(out), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        sys.exit(f"nvcc failed on {src}:\n{log.stdout}{log.stderr}")
    return ctypes.CDLL(str(out))


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


def stamps(src: Path, card: str, torch, np, ops) -> None:
    """Section 2: the stamped build's stages at DF-1056's F and P."""
    L = build(src, "weighted_sample_stamped", "-DWS_STAMPS")
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    # that revision's entry: (w, rng, t, F, P, prefix, ev, stamps, stream)
    L.weighted_sample_stamped_launch.argtypes = [P_, P_, P_, I_, I_, I_, P_,
                                                 P_, P_]
    F, P = 1056, 64
    gen = np.random.default_rng(34)
    w = torch.as_tensor(gen.random((F, P)) * 8, dtype=torch.float32,
                        device="cuda")
    rng = torch.tensor([0, 11], dtype=torch.int64, device="cuda")
    t = torch.tensor(70000, dtype=torch.int32, device="cuda")
    want = ops.weighted_sample(w, rng, t)
    ev = torch.empty(F, dtype=torch.int32, device="cuda")
    st = torch.empty((F, 8), dtype=torch.int64, device="cuda")
    x = torch.zeros(1 << 20, device="cuda")
    rows = []
    for _ in range(20):
        x.add_(1.0)                          # the launch before it
        err = L.weighted_sample_stamped_launch(
            w.data_ptr(), rng.data_ptr(), t.data_ptr(), F, P, 0,
            ev.data_ptr(), st.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"stamped launch: CUDA error {err}")
        torch.cuda.synchronize()
        if not torch.equal(ev, want):
            sys.exit("stamped build: samples differ from the shipped kernel")
        rows.append(st.cpu().numpy())
    s = np.concatenate(rows[5:])                 # warm launches only
    d = np.diff(s[:, :7], axis=1)                # cycles between stamps
    print(json.dumps({
        "section": "stamps", "source": str(src), "F": F, "P": P,
        "median_cycles": dict(zip(STAGES, np.median(d, 0).tolist())),
        "median_cycles_start_to_store": float(np.median(s[:, 6])),
        "median_warp_ns_on_global_timer": float(np.median(s[:, 7])),
        "sm_clock_mhz": sm_clock_mhz(), "card": card}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stamped-src", type=Path, default=None,
                    help="a revision of csrc/weighted_sample.cu with the "
                         "WS_STAMPS build (commit 1c1de75's)")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import engine_rates as ER
    from repro_torch import data as GOLD
    from repro_torch.kernels import ops
    from repro_torch.net.policies import base as PB
    from repro_torch.net.sim import engine as E
    if not torch.cuda.is_available():
        sys.exit("weighted_sample_bench: needs a card")
    card = ER.card()
    L = build(ROOT / "tools" / "weighted_sample_floor.cu",
              "weighted_sample_floor")
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    L.weighted_sample_floor_launch.argtypes = [P_, P_, I_, I_, P_, P_]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if args.stamped_src is not None:
        stamps(args.stamped_src, card, torch, np, ops)

    # 3: the sampler's place in ugal_l's captured step
    ((_, _, spec),) = ER.specs(["permutation:ugal_l"])
    real = PB.sample_path

    def floor_of(io):
        zeros = {}

        def sample(ctx, w):
            # the empty kernel writes nothing: path 0 from a buffer made
            # once (in the warm-up, before the capture)
            if io:
                out = torch.empty(w.shape[0], dtype=torch.int32,
                                  device=w.device)
            else:
                if "ev" not in zeros:
                    zeros["ev"] = torch.zeros(w.shape[0], dtype=torch.int32,
                                              device=w.device)
                out = zeros["ev"]
            err = L.weighted_sample_floor_launch(
                ctx.rng.data_ptr(), ctx.t.data_ptr(), w.shape[0], io,
                out.data_ptr(), stream())
            if err:
                raise RuntimeError(f"floor launch: CUDA error {err}")
            return out
        return sample
    places = {"weighted_sample": real, "floor: empty": floor_of(0),
              "floor: reads rng and t, writes F ints": floor_of(1)}
    got: dict = {}
    try:
        for _ in range(args.reps):
            for place, fn in places.items():
                PB.sample_path = fn
                E._LOOPS.clear()               # capture this place anew
                E.run(spec, seed=GOLD.CONFIG["seed"], device="cuda")
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res = E.run(spec, seed=GOLD.CONFIG["seed"],
                                device="cuda")
                    torch.cuda.synchronize()
                evs = ER.device_events(prof)
                dur = [e.time_range.end - e.time_range.start
                       for e in evs if SAMPLER.match(e.name)]
                exp = ER.exposed_us(evs, SAMPLER)
                g = got.setdefault(place, {"us_a_call": [], "exposed_us": [],
                                           "steps": res.steps_executed})
                g["us_a_call"].append(statistics.median(dur) if dur
                                      else None)
                g["exposed_us"].append(next(iter(exp.values()), None))
    finally:
        PB.sample_path = real
        E._LOOPS.clear()
    for place, g in got.items():
        print(json.dumps({"section": "ugal_l loop", "place": place, **g,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
