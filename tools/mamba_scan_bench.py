"""The Mamba scan's kernels on the card: this tree's against other builds.

Builds ``csrc/mamba_scan.cu`` with the port's nvcc flags and, beside it,
each ``--parent-src F`` (another revision's file with the same C
interface, e.g. ``git show REV:src/repro_torch/kernels/csrc/mamba_scan.cu``),
all in parallel.  At Jamba-1.5-Large's width (d_in 16,384, d_state 16)
over 1 and 2 x 2,048 tokens and 4 x 1,024 (phase 8's prefill), on phase
5b's inputs (``chip_smoke.mamba_inputs``, numpy seed 11), it times each
build's forward (no states, with states) and backward by CUDA events
over back-to-back launches (``chip_smoke.time_ms``), the builds in turns
(a, b, ..., ..., b, a), takes each kernel's device time a call by
torch.profiler, and puts every build's outputs against the first's (the
largest error relative to each tensor's largest entry; past 1e-4 it says
so on stderr).  For each build it prints the ptxas registers, stack and
spills, the blocks an SM, and the SASS instructions a state element in
each kernel's token loops: ``cuobjdump -sass`` of the library, each
innermost loop that raises a decay, its instructions over its
``MUFU.EX2`` (one a state element).  One JSON line a build and case.
Needs a card:

    PYTHONPATH=src python tools/mamba_scan_bench.py [--parent-src F]
        [--reps N] [--sass-only]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
from chip_smoke import (card_line, mamba_inputs, ptxas_entries,  # noqa: E402
                        time_ms)
from repro_torch.kernels import _build  # noqa: E402

# Jamba's training shapes, and its 4 x 1,024-token prefill (phase 8)
CASES = (("B1", 1, 2048, 16384), ("B2", 2, 2048, 16384),
         ("prefill", 4, 1024, 16384))
OUT = _build.BUILD_ROOT.parent / "mamba_bench"


def build_all(builds: dict) -> dict:
    """name -> source built side by side; name -> (library, ptxas
    report)."""
    procs = {}
    for name, src in builds.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libmamba_scan.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    done = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        done[name] = (lib, log)
    return done


def sass_loops(lib: Path, listing: int = 0) -> dict:
    """For each kernel in ``lib``: every innermost loop (a backward
    branch's span holding no smaller such span) that raises a decay
    (``MUFU.EX2``), in address order: its instructions, its exponentials
    (one a state element), their ratio, its opcodes by count and, with
    ``listing``, its first instructions."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part):
            body = m.group(2).strip()
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            ins.append((int(m.group(1), 16), body))
        spans = []
        for addr, body in ins:
            m = re.match(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", body)
            if m and int(m.group(1), 16) < addr:
                span = [b for a, b in ins if int(m.group(1), 16) <= a <= addr]
                if any(b.startswith("MUFU.EX2") for b in span):
                    spans.append((int(m.group(1), 16), addr, span))
        loops = []
        for lo, hi, span in sorted(spans):
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2, _ in spans):
                continue
            ops = collections.Counter(b.split()[0] for b in span)
            loop = dict(loop_instructions=len(span),
                        exponentials=ops["MUFU.EX2"],
                        per_element=round(len(span) / ops["MUFU.EX2"], 2),
                        opcodes=dict(ops.most_common()))
            if listing:
                loop["listing"] = span[:listing]
            loops.append(loop)
        if loops:
            out[name] = loops
    return out


def bind(lib: Path):
    so = ctypes.CDLL(str(lib))
    fwd = so.mamba_scan_launch
    fwd.argtypes = list(_build.SIGNATURES["mamba_scan"][1])
    bwd = so.mamba_scan_bwd_launch
    bwd.argtypes = list(_build.EXTRA_ENTRIES["mamba_scan_bwd"][2])
    fwd.restype = bwd.restype = ctypes.c_int
    occ = {}
    for k in ("mamba_scan_bwd_blocks_per_sm", "mamba_scan_fwd_blocks_per_sm"):
        if hasattr(so, k):
            occ[k] = getattr(so, k)()
    return fwd, bwd, so.mamba_scan_blocks, occ


def runner(fns, ins, B, S, E):
    fwd, bwd, blocks, _ = fns
    x, dt, A, Bm, Cm, h0, dy, dhT = ins
    nseg, nblk = -(-S // 16), blocks(E)
    st = torch.empty((B, nseg, E, 16), device=x.device)
    y, hT = torch.empty_like(x), torch.empty_like(h0)
    grads = [torch.empty_like(t) for t in (x, dt, A, Bm, Cm, h0)]
    dBp, dCp = (torch.empty((B, nblk, S, 16), device=x.device)
                for _ in range(2))
    ddtp = torch.empty((B, nblk, S), dtype=torch.float64, device=x.device)
    dAp = torch.empty((B, E, 16), dtype=torch.float64, device=x.device)
    p = [t.data_ptr() for t in (x, dt, A, Bm, Cm, h0)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def f(states: bool):
        call(fwd(*p, y.data_ptr(), hT.data_ptr(),
                 st.data_ptr() if states else None, B, S, E, stream))

    def b():
        call(bwd(*p[:5], st.data_ptr(), dy.data_ptr(), dhT.data_ptr(),
                 *(g.data_ptr() for g in grads), dBp.data_ptr(),
                 dCp.data_ptr(), ddtp.data_ptr(), dAp.data_ptr(), B, S, E,
                 nblk, stream))
    f(True)
    b()
    torch.cuda.synchronize()
    outs = [y.clone(), hT.clone(), st.clone()] + [g.clone() for g in grads]
    return {"fwd": lambda: f(False), "fwd_states": lambda: f(True),
            "bwd": b}, outs


def kernel_us(run: dict, n: int = 5) -> dict:
    """Device time a call of each kernel (torch.profiler over ``n`` calls
    of the forward with states and the backward), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run["fwd_states"]()
            run["bwd"]()
        torch.cuda.synchronize()
    return {(re.findall(r"(\w+_kernel)", e.key) or [e.key[:40]])[0]:
            round(e.self_device_time_total / e.count, 2)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", action="append", default=[],
                    help="another revision's mamba_scan.cu (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--listing", type=int, default=0,
                    help="print this many instructions of each token loop")
    ap.add_argument("--sass-only", action="store_true",
                    help="report the builds' ptxas, occupancy and SASS only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mamba_scan_bench: no card")
    card = card_line()
    print(f"card: {card}", flush=True)
    builds = {f"parent{i}": Path(p) for i, p in enumerate(args.parent_src)}
    builds["this"] = _build.CSRC / "mamba_scan.cu"
    libs = build_all(builds)
    fns = {n: bind(lib) for n, (lib, _) in libs.items()}
    for n, (lib, log) in libs.items():
        print(json.dumps(dict(build=n, ptxas=ptxas_entries(log),
                              occupancy=fns[n][3],
                              sass=sass_loops(lib, args.listing))),
              flush=True)
    if args.sass_only:
        return
    names = list(libs)
    order = names + names[::-1]
    for label, B, S, E in CASES:
        ins = mamba_inputs(B, S, E, torch, np, np.random.default_rng(11))
        runs, first, errs_by = {}, None, {}
        for n in names:
            runs[n], outs = runner(fns[n], ins, B, S, E)
            if first is None:
                first = outs
            errs = [float((a - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)
                    for a, w in zip(outs, first)]
            errs_by[n] = max(errs)
            if max(errs) > 1e-4:
                print(f"{n} {label}: outputs differ from {names[0]}'s: "
                      f"{errs}", file=sys.stderr, flush=True)
        times = {n: collections.defaultdict(list) for n in names}
        for n in order:
            for k, fn in runs[n].items():
                times[n][k].append(time_ms(fn, args.reps, warmup=3))
        kernels = {n: kernel_us(runs[n]) for n in names}
        for n in names:
            print(json.dumps(dict(build=n, case=label, B=B, S=S, E=E,
                                  kernels_us=kernels[n],
                                  card=card, rel_err=errs_by[n],
                                  ms=dict(times[n]))), flush=True)
        del ins, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
