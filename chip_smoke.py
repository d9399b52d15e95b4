#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the final line):

1. card: name and power limit from nvidia-smi;
2. build: compile the seven CUDA kernels from ``src/repro_torch`` with
   nvcc for sm_90a, one process per source;
3. tick kernel checks: each tick kernel against its plain torch version
   on the card, at the packet engine's DF-1056 shapes plus ragged sizes
   and out-of-range entries, required ``torch.equal``; tick_rank also on
   one port, all distinct ports, all sentinels, M = 1, 65,536 entries
   over 64 ports and n_ports = 70,000 (its pairwise path), against a
   stable numpy sort where the one-hot plain version is too large, each
   case on the path ``ops.tick_rank_plan`` gives; flow_agg also on bool
   and uint8 rows; spritz_select at P 16, 17, 64, 200 and 256 and with
   u = 0 and u just below 1; the fused rank + RED/ECN launch
   (``ops.tick_rank_red_ecn``) against tick_rank's then red_ecn's plain
   versions at the DF-1056 shapes (t 0 and 70,000), M 17, 1 and 0 (no
   launch), all sentinels, negative and out-of-range ports, every
   occupancy 0..qsize+M with u at the RED probability and one f32 step
   below, and n_ports 70,000 (pairwise path); tick_draws (the tick's
   keys and two uniform draws) at the DF-1056 (F, M), ragged sizes and
   ticks and seeds up to 2**31 - 1; a CUDA graph that captured the fused
   launch and tick_draws, replayed at three ticks written to the tick's
   device tensor, equal to the plain versions at each; CUDA-event times of
   kernel, plain version and (flow_agg) ``index_add_``, and the device
   time of every tick kernel (the fused one beside tick_rank and red_ecn
   alone), of ``index_add_`` and of the engine's torch form of the rank
   (argsort + cummax + scatter) from torch.profiler; the ptxas registers
   and stack of spritz_select, flow_agg and the tick_rank entries
   (spritz_select must have no stack frame and no spills);
4. engine path: the 1,056-endpoint Dragonfly permutation run for ecmp,
   ugal_l, spritz_scout and spritz_spray_w (the scheme set of the
   registered cell engine.dragonfly1056.permutation.quick, and Scout)
   through ``engine.run`` on the card, kernels on, held against the
   committed golden record of the JAX reference.  Each run is the
   engine's loop: one gated step captured in a CUDA graph, replayed with
   a read of the stop flag every ``STEPS_PER_READ`` steps; a run must
   replay fewer than that many steps past its last, and each replay
   launch flow_agg twice and the fused tick_rank_red_ecn (shared-memory
   path), tick_draws and, for Spritz, spritz_select once, nothing else;
4c. the same four schemes as one ``engine.run_batch`` call, every lane
   equal to the golden record (which the reference's ``run_batch``
   wrote), with the same launches per replay;
4d. spritz_spray_w through the graph loop against the private eager loop
   (the same step, its wrappers called and the stop flag read every
   step): equal results and final carry; the warm steps/s of both in
   turns (eager, graph, graph, eager);
4b. failover path: the same run under two failure plans built with the
   port's ``failures.py``, held against the committed failover record:
   ``midrun`` (29 sampled links down at tick 16, up at 528; all 11
   schemes) and ``degraded`` (72 links at a quarter of line rate over the
   same window; ugal_l, flicr_w, ops_u, reps, spritz_spray_w).  Every run
   must report zero down and rate violations and finish every flow;
   per replay of the captured step flow_agg launches twice, tick_draws
   once, spritz_select once for the Spritz schemes and never for the
   others; on ``midrun`` phase E is the fused launch once a replay
   (shared-memory path) and the standalone tick_rank and red_ecn never
   launch; on ``degraded`` (a capacity plan) the standalone tick_rank
   launches once a replay on its shared-memory path and the fused launch
   and red_ecn never.  spritz_spray_w on ``midrun`` run as two segments
   (``until_tick`` 528, then ``resume``) must equal the unsegmented run,
   final carry included.  Warm steps/s for ugal_l, ops_u, reps and
   spritz_spray_w; then phase 4d's graph-against-eager check and timing
   on midrun spritz_spray_w;
4e. experiment matrix: the smoke tier's seven cells that run the packet
   engine (``data.SMOKE_CELLS``: micro adversarial, mid-run failure,
   Slim Fly all-to-all, the compression probe, seeded chaos with its
   healthy sweep, DF-1056 permutation, and the packet-fidelity open-loop
   web-search sweep, segmented at every window), each at its registered
   size through the port's runner (``repro_torch.exp.runner.run_cell``,
   ``force=True``, a temporary directory) on the card: every guard must
   pass (the probe's ``BENCH_engine.json`` baseline included) and every
   row must equal the reference's record ``smoke_cells_golden.json``
   field by field, the wall-time fields excluded; per replay flow_agg
   launches twice, tick_draws and one rank launch (fused, or standalone
   under a capacity plan) once, spritz_select only on Spritz lanes.  One
   line a cell: rows, guards, steps, replays, graph captures, wall s,
   steps/s and the card's name and power limit;
5. model kernel checks: flash attention and chunked RWKV-6 against their
   plain versions at the serving path's shapes (prefill and decode, bf16
   and f32) and at ragged, sliding-window and strong-decay cases, within
   the tolerances of ``tests/test_kernels.py``, each bf16 attention case
   also within 2x of SDPA's max and mean error against the f32 reference,
   each attention case printing the path it took (wgmma, split or simt);
   CUDA-event times of kernel, plain version and (attention)
   ``scaled_dot_product_attention``, and the device times of attention,
   SDPA (at decode also SDPA over the visible keys alone) and RWKV-6 from
   torch.profiler; each RWKV-6 case prints its dynamic shared memory and
   the kernel's ptxas registers and spills;
6. card against CPU: the reduced Phi-3 and RWKV-6 configs in f32 on
   ``cuda`` (kernels) and on ``cpu`` (plain versions) from the same
   weights, prefill and 16 decode steps, logits within 1e-4;
7. prefill against decode at full width, 2 layers, f32: the prefill
   logits equal the step-by-step decode logits at every position;
8. serving path: Phi-3-medium-14B (40 layers) and RWKV-6-7B (32 layers)
   at their published sizes in bf16, random weights from a seeded
   generator on the card: ``make_prefill_step`` on 4 x 1,024 tokens, then
   a 4-slot ``Server`` answering 8 requests of 64 generated tokens; every
   request must complete, the model kernel of each path must launch, and
   Phi-3's attention must take the wgmma path in the prefill and the
   split path in the decode;
9. the script's wall time, a JSON line of kernel numbers, then the final
   JSON line.

``--profile`` adds ``torch.profiler`` breakdowns of one warm engine
run (graph replays: the device's busy share of the warm wall time and
the launches a step), of the failover phase's spritz_spray_w runs
(midrun and degraded), and, per served model, of one prefill and 8
decode steps.
Imports torch and the port only, never jax nor the reference package.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
PEAK_FLOPS = {"bf16": 989e12,  # dense tensor-core rate (data sheet)
              "f32": 67e12}    # f32 outside the tensor cores
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flow_agg": ("src/repro_torch/kernels/csrc/flow_agg.cu",
                 "src/repro/kernels/flow_agg.py:69"),
    "tick_rank": ("src/repro_torch/kernels/csrc/tick_rank.cu",
                  "src/repro/kernels/tick_rank.py:75"),
    "red_ecn": ("src/repro_torch/kernels/csrc/red_ecn.cu",
                "src/repro/kernels/red_ecn.py:90"),
    # tick_rank's launch with red_ecn's stage as its epilogue: the engine's
    # phase E (also carries tick_rank.py:75's work there)
    "tick_rank_red_ecn": ("src/repro_torch/kernels/csrc/tick_rank.cu",
                          "src/repro/kernels/red_ecn.py:90"),
    # the tick's keys and two uniform draws (the reference computes them
    # with jax.random in XLA, not in a Pallas kernel)
    "tick_draws": ("src/repro_torch/kernels/csrc/tick_draws.cu",
                   "src/repro/net/sim/engine.py:130"),
    "spritz_select": ("src/repro_torch/kernels/csrc/spritz_select.cu",
                      "src/repro/kernels/spritz_select.py:72"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "rwkv6_chunked": ("src/repro_torch/kernels/csrc/rwkv6_chunked.cu",
                      "src/repro/kernels/rwkv6_chunked.py:90"),
}
TICK_KERNELS = ("flow_agg", "tick_rank", "red_ecn", "tick_rank_red_ecn",
                "tick_draws", "spritz_select")
SERVE_ARCHS = {"phi3_medium_14b": "flash_attention",
               "rwkv6_7b": "rwkv6_chunked"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# measurements that torch.profiler could not make, by label: those
# were timed with CUDA events instead (see ``device_us``)
EVENT_TIMED: list[str] = []


def timed_by(what: str) -> str:
    return "CUDA events" if what in EVENT_TIMED else "torch.profiler"


def device_us(fn, torch, n: int = 50, what: str = "") -> float:
    """Device time per call, in us, of the CUDA kernels that ``fn``
    launches (torch.profiler over ``n`` warm calls), so that a kernel and
    a library call compare without their host cost.  The sum is divided
    by the calls the trace holds, the fewest launches of any one kernel
    (a call may launch a kernel more than once), not by ``n``: a trace
    can drop a short run's first records.  A trace can also come back
    with no CUDA kernel at all; after three such traces the time is
    taken with CUDA events over ``n`` back-to-back calls (host gaps
    included where the calls are host-paced) and ``what`` is noted in
    ``EVENT_TIMED``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        if kern:
            return sum(e.self_device_time_total for e in kern) / \
                min(e.count for e in kern)
        print(f"chip_smoke: torch.profiler recorded no CUDA kernel for "
              f"{what} (trace {attempt + 1} of 3)", file=sys.stderr,
              flush=True)
    EVENT_TIMED.append(what)
    return time_ms(fn, reps=n, warmup=2) * 1e3


def ptxas_entries(log: str) -> dict:
    """Registers, static shared memory, stack frame and spill store bytes
    of every entry function in nvcc's ``-Xptxas -v`` report, keyed by
    mangled name (ptxas leaves out ``bytes smem`` when it is 0)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key = m.group(1)
            out[key] = dict(registers=None, smem_bytes=None, stack_bytes=None,
                            spill_bytes=None)
        elif key and "stack frame" in line:
            out[key]["stack_bytes"] = int(re.search(
                r"(\d+) bytes stack frame", line).group(1))
            out[key]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[key]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def rwkv_ptxas(log: str) -> dict:
    """(registers, spill store bytes) of each ``rwkv6_chunked_kernel``
    instantiation in nvcc's ``-Xptxas -v`` report, keyed "f32 CP16" (input
    type, chunk padded to a multiple of 16)."""
    out = {}
    for name, ent in ptxas_entries(log).items():
        m = re.search(r"rwkv6_chunked_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      name)
        if m:
            key = f"{'f32' if m.group(1) == 'f' else 'bf16'} CP{m.group(2)}"
            out[key] = (ent["registers"], ent["spill_bytes"])
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(ops, ref, sorted_rank, torch, np, shapes,
                  dev="cuda") -> dict:
    """Phase 3: kernel vs plain version on the card; returns per-kernel
    numbers at the main path's shapes.  ``sorted_rank`` is the engine's
    torch form of the rank, timed as tick_rank's yardstick."""
    N, F, M, NP_, P = (shapes[k] for k in ("N", "F", "M", "n_ports", "P"))
    rng = np.random.default_rng(0)

    def cu(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def same(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{name}: kernel differs from its plain version")
        return max(float((g.double() - w.double()).abs().max())
                   if g.numel() else 0.0 for g, w in zip(got, want))

    out = {}
    i32, f32 = torch.int32, torch.float32

    # ---- flow_agg: K = 6 (phase A) and K = 2 (phase B), ragged, sentinels
    def agg_inputs(K, n, vmax, sentinels, dtype=i32):
        rows = rng.random((K, n)) < 0.05
        if dtype != torch.bool:
            rows = rows * rng.integers(1, vmax + 1, (K, n))
        pflow = rng.integers(0, F, n)
        if sentinels:
            pflow[rng.integers(0, n, 64)] = rng.choice([-1, F, F + 7], 64)
        return cu(rows, dtype), cu(pflow, i32)

    err = 0.0
    for K, n, vmax, sent, dt in (
            (6, N, 1, False, torch.bool), (6, N, 1, False, i32),
            (2, N, 4000, False, i32), (6, 1000, 1, True, i32),
            (3, 257, 9, True, i32), (6, 1000, 1, True, torch.bool),
            (3, 257, 255, True, torch.uint8), (4, 0, 1, False, torch.bool)):
        rows, pflow = agg_inputs(K, n, vmax, sent, dt)
        err = max(err, same(f"flow_agg K {K} N {n} {dt}",
                            ops.flow_agg(rows, pflow, n_flows=F),
                            ref.flow_agg_reference(rows, pflow, n_flows=F)))
    # phase A's call: six stacked bool indicators, as the engine passes them
    rows_b, pflow = agg_inputs(6, N, 1, False, torch.bool)
    rows = rows_b.to(i32)
    rows_t = rows.T.contiguous()

    def lib_agg():
        return torch.zeros((F, 6), dtype=i32, device=dev).index_add_(
            0, pflow, rows_t)
    if not torch.equal(lib_agg().T, ops.flow_agg(rows, pflow, n_flows=F)):
        fail("flow_agg: index_add_ yardstick disagrees")
    out["flow_agg"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.flow_agg(rows_b, pflow, n_flows=F)),
        plain_ms=time_ms(lambda: ref.flow_agg_reference(rows_b, pflow,
                                                        n_flows=F)),
        library_ms=time_ms(lib_agg),
        device_us=device_us(lambda: ops.flow_agg(rows_b, pflow, n_flows=F),
                            torch, what="flow_agg"),
        library_device_us=device_us(lib_agg, torch,
                                    what="flow_agg index_add_"),
        bytes=nbytes(rows_b, pflow) + 6 * F * 4)
    rows2, pflow2 = agg_inputs(2, N, 4000, False)
    out["flow_agg"]["ms_k2"] = time_ms(
        lambda: ops.flow_agg(rows2, pflow2, n_flows=F))
    out["flow_agg"]["k2_device_us"] = device_us(
        lambda: ops.flow_agg(rows2, pflow2, n_flows=F), torch,
        what="flow_agg K 2")

    # ---- tick_rank: a compacted set (valid prefix, sentinel tail), ragged
    def rank_inputs(m, n_valid):
        port = np.full(m, NP_)
        port[:n_valid] = rng.integers(0, NP_, n_valid)
        port[:n_valid:7] = rng.integers(0, 16, len(port[:n_valid:7]))
        port[rng.integers(0, m, 8)] = -1
        return cu(port, i32)

    def stable_rank(port, n_ports):
        """The rank by a stable numpy sort, for shapes whose one-hot plain
        version is too large: position in the sorted run of its bucket."""
        p = port.cpu().numpy()
        b = np.where((p < 0) | (p >= n_ports), n_ports, p)
        order = np.argsort(b, kind="stable")
        srt = b[order]
        rank = np.empty(len(b), np.int32)
        rank[order] = np.arange(len(b)) - np.searchsorted(srt, srt, "left")
        return torch.from_numpy(rank).to(dev)

    err = 0.0
    cases = [(rank_inputs(m, nv), NP_)
             for m, nv in ((M, 4200), (M, M), (1000, 600), (37, 37))]
    cases += [(cu(np.full(M, 5), i32), NP_),                 # one port
              (cu(rng.permutation(NP_), i32), NP_),          # all distinct
              (cu(np.full(M, NP_), i32), NP_),               # all sentinel
              (cu(np.array([3]), i32), NP_),                 # M = 1
              (rank_inputs(M - 1, M - 1), NP_),              # M % 32 != 0
              (cu(rng.integers(-1, 66, 65536), i32), 64),    # 65,536 / 64
              (cu(rng.integers(-1, 70002, 2000), i32), 70000)]  # pairwise
    small = cases[2][0]
    if not torch.equal(stable_rank(small, NP_),
                       ref.tick_rank_reference(small, n_ports=NP_)):
        fail("tick_rank: the stable-sort rank disagrees with the plain "
             "version")
    for port, n in cases:
        path = ops.tick_rank_plan(port.shape[0], n)[0]
        before = dict(ops.TICK_RANK_PATHS)
        got = ops.tick_rank(port, n_ports=n)
        if ops.TICK_RANK_PATHS[path] != before[path] + 1:
            fail(f"tick_rank: M {port.shape[0]}, n_ports {n} did not "
                 f"take its planned path {path}")
        want = (stable_rank(port, n) if port.shape[0] * (n + 1) > 1 << 26
                else ref.tick_rank_reference(port, n_ports=n))
        err = max(err, same(f"tick_rank M {port.shape[0]} n_ports {n} "
                            f"({path})", got, want))
    if ops.tick_rank(cu(np.zeros(0), i32), n_ports=NP_).numel() != 0:
        fail("tick_rank: M = 0 gave a result")
    port = rank_inputs(M, 4200)
    ar_m = torch.arange(M, dtype=i32, device=dev)
    plan = ops.tick_rank_plan(M, NP_)
    out["tick_rank"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_rank(port, n_ports=NP_)),
        plain_ms=time_ms(lambda: ref.tick_rank_reference(port, n_ports=NP_)),
        library_ms=None, bytes=2 * nbytes(port),
        device_us=device_us(lambda: ops.tick_rank(port, n_ports=NP_), torch,
                            what="tick_rank"),
        path=plan[0], segs=plan[1], smem_bytes=plan[2],
        torch_form_ms=time_ms(lambda: sorted_rank(port, ar_m)),
        torch_form_device_us=device_us(lambda: sorted_rank(port, ar_m),
                                       torch, what="tick_rank torch form"))

    # ---- red_ecn: random candidates, then every occupancy 0..qsize+M
    qsize, kmin, kmax = shapes["qsize"], shapes["kmin"], shapes["kmax"]
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=NP_)
    err = 0.0
    for t in (40, 70000):
        eport = rank_inputs(M, 4200).clamp_min(0)
        rank = ref.tick_rank_reference(eport, n_ports=NP_)
        enq = eport < NP_
        unif = cu(rng.random(M), f32)
        q_tail = cu(t + rng.integers(-40, 120, NP_), i32)
        err = max(err, same("red_ecn",
                            ops.red_ecn(eport, rank, enq, unif, q_tail, t,
                                        **kw),
                            ref.red_ecn_reference(eport, rank, enq, unif,
                                                  q_tail, t, **kw)))
    t = 500
    occ_all = torch.arange(qsize + M + 1, dtype=i32, device=dev)
    n_all = occ_all.numel()
    e_all = torch.zeros(n_all, dtype=i32, device=dev)
    qt = torch.full((NP_,), t, dtype=i32, device=dev)
    en = torch.ones(n_all, dtype=torch.bool, device=dev)
    pr = ((occ_all.float() - float(np.float32(kmin)))
          * float(np.float32(1) / np.float32(max(kmax - kmin, 1e-9)))
          ).clamp(0.0, 1.0)
    for u in (pr, torch.nextafter(pr, torch.zeros_like(pr))):
        err = max(err, same("red_ecn",
                            ops.red_ecn(e_all, occ_all, en, u.contiguous(),
                                        qt, t, **kw),
                            ref.red_ecn_reference(e_all, occ_all, en, u, qt,
                                                  t, **kw)))
    eport = rank_inputs(M, 4200).clamp_min(0)
    rank = ref.tick_rank_reference(eport, n_ports=NP_)
    enq = eport < NP_
    unif = cu(rng.random(M), f32)
    q_tail = cu(70000 + rng.integers(-40, 120, NP_), i32)
    # timed with the tick in device memory, as the engine passes it (an
    # int would add a host-to-device copy to each call)
    t_dev = torch.tensor(70000, dtype=i32, device=dev)
    outs = ops.red_ecn(eport, rank, enq, unif, q_tail, t_dev, **kw)
    out["red_ecn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.red_ecn(eport, rank, enq, unif, q_tail,
                                       t_dev, **kw)),
        plain_ms=time_ms(lambda: ref.red_ecn_reference(
            eport, rank, enq, unif, q_tail, t_dev, **kw)),
        library_ms=None,
        device_us=device_us(lambda: ops.red_ecn(eport, rank, enq, unif,
                                                q_tail, t_dev, **kw),
                            torch, what="red_ecn"),
        bytes=nbytes(eport, rank, enq, unif, q_tail, *outs))

    # ---- tick_rank_red_ecn: the rank and red_ecn's stage in one launch,
    # against tick_rank's then red_ecn's plain versions
    def rank_red_plain(port, enq, unif, q_tail, t, n):
        rank = (stable_rank(port, n) if port.shape[0] * (n + 1) > 1 << 26
                else ref.tick_rank_reference(port, n_ports=n))
        return ref.red_ecn_reference(port, rank, enq, unif, q_tail, t,
                                     **dict(kw, n_ports=n))[1:]

    def fused_case(label, port, enq, unif, q_tail, t, n):
        path = ops.tick_rank_plan(port.shape[0], n)[0]
        before = dict(ops.TICK_RANK_PATHS)
        launched = ops.LAUNCHES["tick_rank_red_ecn"]
        got = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t,
                                    **dict(kw, n_ports=n))
        want_launch = int(path != "none")
        if ops.LAUNCHES["tick_rank_red_ecn"] != launched + want_launch or (
                want_launch and
                ops.TICK_RANK_PATHS[path] != before[path] + 1):
            fail(f"tick_rank_red_ecn {label}: not one launch on its planned "
                 f"path {path}")
        return same(f"tick_rank_red_ecn {label} ({path})", got,
                    rank_red_plain(port, enq, unif, q_tail, t, n))

    def tails(t, n):
        return cu(t + rng.integers(-40, 120, n), i32)

    err = 0.0
    for tt in (0, 70000):                      # the DF-1056 shapes
        port = rank_inputs(M, 4200)
        err = max(err, fused_case(f"M {M} t {tt}", port, port < NP_,
                                  cu(rng.random(M), f32), tails(tt, NP_),
                                  tt, NP_))
    for m in (17, 1, 0):                       # ragged, then nothing
        port = rank_inputs(m, m) if m else cu(np.zeros(0), i32)
        err = max(err, fused_case(f"M {m}", port, port < NP_,
                                  cu(rng.random(m), f32), tails(40, NP_), 40,
                                  NP_))
    port = cu(np.full(M, NP_), i32)            # all sentinels
    err = max(err, fused_case("all sentinels", port, port < NP_,
                              cu(rng.random(M), f32), tails(40, NP_), 40,
                              NP_))
    port = cu(rng.integers(-NP_, NP_ + 3, M), i32)   # negative, out of range
    err = max(err, fused_case("negative and out-of-range ports", port,
                              cu(rng.random(M) < 0.8, torch.bool),
                              cu(rng.random(M), f32), tails(40, NP_), 40,
                              NP_))
    # every occupancy 0..qsize+M (red_ecn's t, occ_all, pr and tails qt
    # above): from the rank (one port, tail t) and from the tails (a port
    # each, rank 0), u at the RED probability and one f32 step below it
    for u in (pr, torch.nextafter(pr, torch.zeros_like(pr))):
        u = u.contiguous()
        err = max(err, fused_case("every occupancy, one port",
                                  cu(np.full(n_all, 5), i32), en, u, qt, t,
                                  NP_))
        err = max(err, fused_case("every occupancy, a port each", occ_all,
                                  en, u, t + occ_all, t, n_all))
    port = cu(rng.integers(-1, 70002, 2000), i32)    # the pairwise path
    err = max(err, fused_case("n_ports 70000", port, port < 70000,
                              cu(rng.random(2000), f32), tails(40, 70000),
                              40, 70000))
    port = rank_inputs(M, 4200)
    enq, unif, q_tail = port < NP_, cu(rng.random(M), f32), tails(70000, NP_)
    outs = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)
    out["tick_rank_red_ecn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_rank_red_ecn(port, enq, unif, q_tail,
                                                 t_dev, **kw)),
        plain_ms=time_ms(lambda: rank_red_plain(port, enq, unif, q_tail,
                                                t_dev, NP_)),
        library_ms=None,
        device_us=device_us(lambda: ops.tick_rank_red_ecn(
            port, enq, unif, q_tail, t_dev, **kw), torch,
            what="tick_rank_red_ecn"),
        bytes=nbytes(port, enq, unif, q_tail, *outs),
        path=plan[0], segs=plan[1], dynamic_smem_bytes=plan[2])

    # ---- the tick read from device memory: a graph that captured the fused
    # launch and the draws gives each replay's tick's results
    t_dev = torch.zeros((), dtype=i32, device=dev)
    key = cu(np.array([0, 11]), torch.int64)
    ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)   # warm
    ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_fused = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)
        g_draws = ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    for tt in (69990, 70000, 70100):
        t_dev.fill_(tt)
        graph.replay()
        torch.cuda.synchronize()
        same(f"tick_rank_red_ecn captured, t {tt}", g_fused,
             rank_red_plain(port, enq, unif, q_tail, tt, NP_))
        same(f"tick_draws captured, t {tt}", g_draws,
             ref.tick_draws_reference(key, t_dev, n_flows=F, n_cand=M))
    del graph

    # ---- tick_draws: the tick's keys and both draws at the engine's
    # (F, M), ragged sizes, ticks and seeds up to 2**31 - 1
    err = 0.0
    for seed, tt, f, m in ((0, 0, F, M), (0, 513, F, M), (7, 70000, F, M),
                           (2**31 - 1, 2**31 - 1, F, M), (5, 3, 1, 0),
                           (5, 3, 0, 7), (9, 11, 300, 1)):
        key = cu(np.array([0, seed]), torch.int64)
        t_dev = torch.tensor(tt, dtype=i32, device=dev)
        err = max(err, same(f"tick_draws seed {seed} t {tt} F {f} M {m}",
                            ops.tick_draws(key, t_dev, n_flows=f, n_cand=m),
                            ref.tick_draws_reference(key, t_dev, n_flows=f,
                                                     n_cand=m)))
    key = cu(np.array([0, 0]), torch.int64)
    t_dev = torch.tensor(70000, dtype=i32, device=dev)
    outs = ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    out["tick_draws"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)),
        plain_ms=time_ms(lambda: ref.tick_draws_reference(
            key, t_dev, n_flows=F, n_cand=M)),
        library_ms=None, bytes=nbytes(key, t_dev, *outs),
        device_us=device_us(lambda: ops.tick_draws(key, t_dev, n_flows=F,
                                                   n_cand=M),
                            torch, what="tick_draws"))

    # ---- spritz_select: Eq.-1-like rows, zero rows, wide dynamic range
    thr = shapes["explore_threshold"]

    def sel_inputs(f, p, explore_all=False, wide=False, u_edge=None):
        w = rng.random((f, p)).astype(np.float32) * 7.0 + 1.0
        if wide:
            w = np.exp(rng.normal(0, 6, (f, p))).astype(np.float32)
        npaths = rng.integers(1, p + 1, f)
        w[np.arange(p)[None, :] >= npaths[:, None]] = 0.0
        w[rng.integers(0, f, 5)] = 0.0
        u = rng.random(f).astype(np.float32)
        if u_edge is not None:      # u = 0, or just below 1 (the total)
            u[:] = u_edge
        front = rng.integers(-1, p, f)
        count = (np.full(f, thr) if explore_all
                 else rng.integers(0, 2 * thr, f))
        return (cu(w, f32), cu(u, f32), cu(front, i32), cu(count, i32))

    err = 0.0
    below_one = np.nextafter(np.float32(1), np.float32(0))
    for f, p, ex, wide, ue in (
            (F, P, False, False, None), (F, P, True, False, None),
            (F, P, True, True, None), (1000, 37, True, True, None),
            (33, 1, True, False, None), (257, 200, True, True, None),
            (300, 16, True, True, None), (300, 17, True, True, None),
            (300, 256, True, True, None), (F, P, True, True, 0.0),
            (F, P, True, True, below_one), (300, 17, True, True, 0.0),
            (300, 256, True, True, below_one)):
        args = sel_inputs(f, p, ex, wide, ue)
        err = max(err, same(f"spritz_select F {f} P {p} u {ue}",
                            ops.spritz_select(*args, explore_threshold=thr),
                            ref.spritz_select_reference(
                                *args, explore_threshold=thr)))
    args = sel_inputs(F, P)
    outs = ops.spritz_select(*args, explore_threshold=thr)
    out["spritz_select"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.spritz_select(*args, explore_threshold=thr)),
        plain_ms=time_ms(lambda: ref.spritz_select_reference(
            *args, explore_threshold=thr)),
        library_ms=None, bytes=nbytes(*args, *outs),
        device_us=device_us(lambda: ops.spritz_select(
            *args, explore_threshold=thr), torch, what="spritz_select"))
    return out


def attention_work(q, k, *, causal, window, q_offset):
    """(FLOPs, bytes) that one attention call needs: 4 D flops per
    unmasked (query, key) pair (scores and weighted sum), q and o once,
    and the keys and values that some query may see."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    pairs, k_lo, k_hi = 0, Sk, -1
    for i in range(Sq):
        pos = q_offset + i
        hi = min(Sk - 1, pos) if causal else Sk - 1
        lo = max(0, pos - window + 1) if window else 0
        if hi >= lo:
            pairs += hi - lo + 1
            k_lo, k_hi = min(k_lo, lo), max(k_hi, hi)
    keys = max(k_hi - k_lo + 1, 0)
    elem = q.element_size()
    flops = 4 * B * Hq * D * pairs
    nbytes_ = elem * (2 * B * Sq * Hq * D + 2 * B * keys * Hkv * D)
    return flops, nbytes_


def rwkv_flops(B, S, H, C):
    """FLOPs of the chunked RWKV-6 time mix (head size 64): per chunk the
    inter-chunk product, the strictly-lower scores and their weighted
    sum, the bonus and the state update; each exp counted as one."""
    hd, n = 64, B * H * (S // C)
    low = C * (C - 1) // 2
    per_chunk = (2 * C * hd * hd            # (r * A) @ S
                 + 4 * low * hd             # scores: r*k*exp(.) and sum
                 + 2 * low * hd             # scores @ v
                 + 5 * C * hd               # bonus
                 + 3 * C * hd + 2 * C * hd  # logw, rdec, kdec
                 + 2 * C * hd * hd + 2 * hd * hd)   # state update
    return n * per_chunk


def bound_ms(flops, nbytes_, kind):
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def check_model_kernels(ops, ref, torch, np, rwkv_smem,
                        dev="cuda") -> dict:
    """Phase 5: flash attention and chunked RWKV-6 against their plain
    versions on the card, with the tolerances of tests/test_kernels.py
    (2e-5 f32 and 5e-2 bf16 attention, 1e-4 RWKV-6).  ``rwkv_smem(C)`` is
    the RWKV-6 kernel's dynamic shared memory at chunk C."""
    rng = np.random.default_rng(1)
    F = torch.nn.functional

    def rand(shape, dtype=torch.float32, scale=1.0):
        return torch.as_tensor(rng.normal(0, scale, shape), dtype=dtype,
                               device=dev)

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    def sdpa(q, k, v, kw):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        Sq, Sk = q.shape[1], k.shape[1]
        if kw["q_offset"] == 0 and Sq == Sk and not kw["sliding_window"]:
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        qpos = kw["q_offset"] + torch.arange(Sq, device=dev)[:, None]
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = kpos <= qpos
        if kw["sliding_window"]:
            mask &= kpos > qpos - kw["sliding_window"]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)

    def sdpa_visible(q, k, v, kw):
        """SDPA over only the keys a decode row sees, [0, q_offset + 1),
        unmasked: the same work as the split path's."""
        kend = min(k.shape[1], kw["q_offset"] + 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kend],
                                                  v[:, :kend]))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True).transpose(1, 2)

    def bf16_errors(label, got, lib_out, q, k, v, kw):
        """Max and mean error of the kernel and of SDPA against the f32
        reference on the same (bf16) inputs.  The 5e-2 gate is about the
        size of a late row's output (std ~ sqrt(e / keys) ~ 0.07), so the
        kernel must also be within 2x of SDPA's own error: a wrong
        rescale or a dropped tile on the late rows fails here."""
        want32 = ref.mha_reference(q.float(), k.float(), v.float(), **kw)
        ek = (got.float() - want32).abs()
        es = (lib_out.float() - want32).abs()
        e = dict(max=float(ek.max()), mean=float(ek.mean()),
                 sdpa_max=float(es.max()), sdpa_mean=float(es.mean()))
        if not (e["max"] <= 2 * e["sdpa_max"]
                and e["mean"] <= 2 * e["sdpa_mean"]):
            fail(f"flash_attention {label}: error against the f32 reference "
                 f"max {e['max']:.3g} mean {e['mean']:.3g} above 2x SDPA's "
                 f"(max {e['sdpa_max']:.3g}, mean {e['sdpa_mean']:.3g})")
        return e

    out = {}
    # ---- flash attention: the serving path's shapes, then ragged ones
    B, S, Hq, Hkv, D = 4, 1024, 40, 10, 128
    cases = [  # (label, Sq, Sk, B, Hq, Hkv, D, dtype, window, q_offset)
        ("prefill bf16", S, S, B, Hq, Hkv, D, torch.bfloat16, 0, 0),
        ("prefill bf16 D=64", S, S, B, Hq, Hkv, 64, torch.bfloat16, 0, 0),
        ("prefill f32", S, S, B, Hq, Hkv, D, torch.float32, 0, 0),
        ("decode bf16", 1, S, B, Hq, Hkv, D, torch.bfloat16, 0, 700),
        ("decode bf16 q_offset 63", 1, S, B, Hq, Hkv, D, torch.bfloat16, 0,
         63),
        ("decode f32", 1, S, B, Hq, Hkv, D, torch.float32, 0, 700),
        ("ragged Sk f32", 77, 333, 2, 8, 2, 64, torch.float32, 0, 256),
        ("Sq=1 Sk=1 f32", 1, 1, 3, 4, 4, 32, torch.float32, 0, 0),
        ("window 4096 f32", 8192, 8192, 1, 8, 2, 128, torch.float32, 4096,
         0),
    ]
    worst = 0.0
    for label, sq, sk, b, hq, hkv, d, dt, win, off in cases:
        q, k, v = rand((b, sq, hq, d), dt), rand((b, sk, hkv, d), dt), \
            rand((b, sk, hkv, d), dt)
        kw = dict(causal=True, sliding_window=win, q_offset=off)
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, **kw)
        path = next(p for p, n in ops.FLASH_PATHS.items() if n)
        want = ref.mha_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 5e-2 if dt == torch.bfloat16 else 2e-5
        e = err(got, want)
        lib = sdpa(q, k, v, kw)
        lib_out = lib()
        e_lib = err(lib_out, want)
        if not (e <= tol and e_lib <= tol):
            fail(f"flash_attention {label}: max error {e:.3g} (SDPA "
                 f"{e_lib:.3g}) above {tol}")
        e32 = None
        if dt == torch.bfloat16:
            e32 = bf16_errors(label, got, lib_out, q, k, v, kw)
        del lib_out
        worst = max(worst, e)
        flops, nb = attention_work(q, k, causal=True, window=win,
                                   q_offset=off)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        bms, by = bound_ms(flops, nb, kind)
        reps = 5 if sq >= 1024 else 50
        row = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                              reps=reps, warmup=2),
                   plain_ms=time_ms(lambda: ref.mha_reference(q, k, v, **kw),
                                    reps=reps, warmup=2),
                   library_ms=time_ms(lib, reps=reps, warmup=2),
                   flops=flops, bytes=nb, bound_ms=bms, bound_by=by,
                   max_abs_err=e, path=path)
        # device time alone: the wrapper times above are host-paced at
        # the decode shapes
        row["device_ms"] = device_us(
            lambda: ops.flash_attention(q, k, v, **kw), torch,
            max(reps, 20), what=f"flash_attention {label}") / 1e3
        row["library_device_ms"] = device_us(
            lib, torch, max(reps, 20),
            what=f"flash_attention {label} SDPA") / 1e3
        extra = ""
        if e32 is not None:
            row["f32_ref_err"] = e32
            extra += (f"; vs f32 reference: max {e32['max']:.3g} mean "
                      f"{e32['mean']:.3g}, SDPA max {e32['sdpa_max']:.3g} "
                      f"mean {e32['sdpa_mean']:.3g} (limit 2x SDPA)")
        if sq == 1 and not win:
            row["library_visible_device_ms"] = device_us(
                sdpa_visible(q, k, v, kw), torch, max(reps, 20),
                what=f"flash_attention {label} SDPA visible") / 1e3
            extra += (f"; SDPA on the visible keys alone, device "
                      f"{row['library_visible_device_ms']:.4f} ms")
        print(f"kernel flash_attention {label} {tuple(q.shape)} x "
              f"{tuple(k.shape)}: path {path}; max err {e:.3g} (tol "
              f"{tol}), SDPA err "
              f"{e_lib:.3g}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms; "
              f"device: kernel {row['device_ms']:.4f} ms, SDPA "
              f"{row['library_device_ms']:.4f} ms; "
              f"{flops} FLOP, {nb} B, bound {bms:.4f} ms ({by}){extra}",
              flush=True)
        out[f"flash {label}"] = row
        del q, k, v, got, want
    out["flash_attention"] = dict(out["flash prefill bf16"],
                                  max_abs_err=worst)

    # ---- chunked RWKV-6: the prefill shape (chunk 16 and 64), strong decay
    def rwkv_inputs(b, s, h, lo, hi):
        r, k, v = (rand((b, s, h, 64), scale=0.5) for _ in range(3))
        w = torch.as_tensor(rng.uniform(lo, hi, (b, s, h, 64)),
                            dtype=torch.float32, device=dev)
        return r, k, v, w, rand((h, 64), scale=0.1), \
            rand((b, h, 64, 64), scale=0.1)

    worst = 0.0
    for label, (b, s, h, c, lo, hi) in (
            ("prefill chunk 16", (4, 1024, 64, 16, 0.7, 0.999)),
            ("prefill chunk 64", (4, 1024, 64, 64, 0.7, 0.999)),
            ("strong decay chunk 32", (1, 128, 1, 32, 0.3, 0.6))):
        ins = rwkv_inputs(b, s, h, lo, hi)
        y, sf = ops.rwkv6_chunked(*ins, chunk=c)
        y2, sf2 = ref.rwkv6_chunked_reference(*ins, chunk=c)
        torch.cuda.synchronize()
        e = max(err(y, y2), err(sf, sf2))
        if not (e <= 1e-4 and bool(torch.isfinite(y).all())):
            fail(f"rwkv6_chunked {label}: max error {e:.3g} above 1e-4")
        worst = max(worst, e)
        flops, nb = rwkv_flops(b, s, h, c), nbytes(*ins, y, sf)
        bms, by = bound_ms(flops, nb, "f32")
        row = dict(ms=time_ms(lambda: ops.rwkv6_chunked(*ins, chunk=c),
                              reps=20, warmup=2),
                   plain_ms=time_ms(lambda: ref.rwkv6_chunked_reference(
                       *ins, chunk=c), reps=5, warmup=1),
                   library_ms=None, flops=flops, bytes=nb, bound_ms=bms,
                   bound_by=by, max_abs_err=e, smem_bytes=rwkv_smem(c))
        row["device_ms"] = device_us(
            lambda: ops.rwkv6_chunked(*ins, chunk=c), torch, 20,
            what=f"rwkv6_chunked {label}") / 1e3
        print(f"kernel rwkv6_chunked {label} r {tuple(ins[0].shape)}: max "
              f"err {e:.3g} (tol 1e-4); kernel {row['ms']:.4f} ms, device "
              f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
              f"{flops} FLOP, {nb} B, bound {bms:.4f} ms ({by}); dynamic "
              f"shared memory {row['smem_bytes']} B a block", flush=True)
        out[f"rwkv {label}"] = row
    out["rwkv6_chunked"] = dict(out["rwkv prefill chunk 16"],
                                max_abs_err=worst)
    return out


def card_vs_cpu(C, LM, step, torch, np) -> None:
    """Phase 6: the reduced configs in f32 on the card (kernels) and on
    the CPU (plain versions), same weights; prefill and 16 decode steps.
    Tolerance 1e-4: only summation orders differ (TF32 is off)."""
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(C.get_reduced(arch), dtype=torch.float32)
        cpu = LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, 80)))
        prompt, gen = toks[:, :64], toks[:, 64:]
        errs = [float((step.make_prefill_step(gpu, 80)(
            {"tokens": prompt.cuda()}).cpu()
            - step.make_prefill_step(cpu, 80)({"tokens": prompt})
        ).abs().max())]
        errs.append(float((gpu(prompt.cuda()).cpu() - cpu(prompt))
                          .abs().max()))
        cg, cc = gpu.init_cache(2, 80), cpu.init_cache(2, 80)
        sg, sc = step.make_serve_step(gpu), step.make_serve_step(cpu)
        for i in range(16):
            lg, cg = sg(cg, {"tokens": gen[:, i:i + 1].cuda()})
            lc, cc = sc(cc, {"tokens": gen[:, i:i + 1]})
            errs.append(float((lg.cpu() - lc).abs().max()))
        e = max(errs)
        if not e <= 1e-4:
            fail(f"{arch} reduced: card and CPU differ by {e:.3g} > 1e-4")
        print(f"card vs cpu {arch} reduced f32: prefill [2, 64] + 16 decode "
              f"steps, max logit error {e:.3g} (tol 1e-4)", flush=True)
        del cpu, gpu, cg, cc


# Prefill (flash at Sq = S, the chunked RWKV-6 kernel) against step-by-step
# decode (flash at Sq = 1 against the cache, the per-token recurrence):
# the same f32 arithmetic in another order (GEMMs of [B*S, d] against
# [B, d] rows, chunked against sequential RWKV sums), so the logits (up
# to ~8 at these widths) agree within a few 1e-5; a bf16 or TF32 product
# anywhere would move them by 1e-3 or more.
FULL_WIDTH_TOL = 2e-4


def prefill_vs_decode(C, LM, torch, np) -> None:
    """Phase 7: full published widths, depth cut to 2 layers, f32."""
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(C.get_config(arch), n_layers=2,
                                  dtype=torch.float32)
        model = LM(cfg, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
        B, S = 2, 64
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (B, S)), device="cuda")
        full = model(toks)
        cache = model.init_cache(B, S)
        e = 0.0
        for i in range(S):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache)
            e = max(e, float((lg[:, 0] - full[:, i]).abs().max()))
        scale = float(full.abs().max())
        if not e <= FULL_WIDTH_TOL:
            fail(f"{arch} full width: prefill and decode differ by {e:.3g}")
        print(f"prefill vs decode {arch} full width 2 layers f32: [{B}, {S}],"
              f" max logit error {e:.3g} (tol {FULL_WIDTH_TOL}; max |logit| "
              f"{scale:.3g})", flush=True)
        del model, full, cache
        gc.collect()
        torch.cuda.empty_cache()


def serve_path(arch, C, Server, step, ops, torch, np, card,
               profile=False) -> dict:
    """Phase 8: one published config at full size in bf16 on the card:
    prefill 4 x 1,024 tokens, then 8 requests through a 4-slot Server.
    Launches are counted from just before the prefill to just after the
    last request.  ``profile`` then traces one prefill and 8 decode
    steps."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Server(arch, device="cuda", slots=4, max_len=1024, reduced=False,
                 seed=0)
    torch.cuda.synchronize()
    cfg = srv.cfg
    n_params = sum(p.numel() for p in srv.model.parameters())
    print(f"serve {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({cfg.param_count():.4g} by "
          f"ModelCfg.param_count), {cfg.dtype}, initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1024)),
                              device="cuda")
    prefill = step.make_prefill_step(srv.model, 1024)
    kernel = SERVE_ARCHS[arch]

    torch.cuda.synchronize()
    ops.reset_launches()
    walls = []
    for _ in range(2):          # cold, then warm
        t0 = time.perf_counter()
        logits = prefill({"tokens": prompts})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if logits.shape != (4, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: prefill logits {tuple(logits.shape)} not finite")
    prefill_paths = dict(ops.FLASH_PATHS)
    inner = srv.step

    def checked_step(cache, batch):
        lg, cache = inner(cache, batch)
        if not bool(torch.isfinite(lg).all()):
            fail(f"{arch}: decode logits not finite")
        return lg, cache
    srv.step = checked_step
    gen = 64
    want = {}
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
        srv.submit(rid, prompt, gen)
        want[rid] = gen + len(prompt)
    stats = srv.run()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    done = {r: len(t) for r, t in srv.done.items()}
    if stats["requests"] != 8 or done != want:
        fail(f"{arch}: requests not all answered: {done} != {want}")
    if counts[kernel] == 0:
        fail(f"{arch}: {kernel} never launched on the serving path: "
             f"{counts}")
    decode_paths = {p: n - prefill_paths[p]
                    for p, n in ops.FLASH_PATHS.items()}
    if kernel == "flash_attention" and not (
            prefill_paths["wgmma"] > 0 and decode_paths["split"] > 0 and
            sum(prefill_paths.values()) == prefill_paths["wgmma"] and
            sum(decode_paths.values()) == decode_paths["split"]):
        fail(f"{arch}: attention paths prefill {prefill_paths}, decode "
             f"{decode_paths}; want wgmma for the prefill and split for "
             f"the decode")
    tokens = sum(done.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"serve {arch}: prefill 4 x 1024 tokens in {walls[0]:.3f} s cold, "
          f"{walls[1]:.3f} s warm = {4096 / walls[1]:.1f} tokens/s; decode "
          f"{stats['steps']} steps, {stats['ms_per_step']:.2f} ms/step, "
          f"{tokens} tokens in {stats['wall_s']:.3f} s = "
          f"{tokens / stats['wall_s']:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB; launches {counts}; attention paths "
          f"prefill {prefill_paths} decode {decode_paths}; card {card}",
          flush=True)
    if profile:
        profile_block(f"{arch} prefill 4 x 1024", lambda: prefill(
            {"tokens": prompts}), walls[1], torch)

        def decode8():
            for _ in range(8):
                lg, srv.cache = srv.step(srv.cache, {"tokens": srv.tokens})
                lg[:, -1, :cfg.vocab].argmax(-1).cpu()
        profile_block(f"{arch} decode x 8", decode8,
                      8 * stats["ms_per_step"] / 1e3, torch)
    del srv, logits, prefill, inner
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from repro_torch import configs as C
        from repro_torch import data as GOLD
        from repro_torch.launch.serve import Server
        from repro_torch.models.lm import LM
        from repro_torch.train import step as STEP
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import ref as KREF
        from repro_torch.net.sim import build as B
        from repro_torch.net.sim import engine as E
        from repro_torch.net.sim import failures as FF
        from repro_torch.net.sim.types import enqueue_bound
        from repro_torch.net.topology.dragonfly import make_dragonfly
        from repro_torch.net.workloads.synthetic import permutation
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout): {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        fail("the port imported jax or the reference package")
    # plain versions use f32 products of small integers: keep them exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    for name in KERNELS:
        _build.library(name)
    print(f"build: {time.perf_counter() - t0:.1f} s wall, nvcc "
          f"{_build.BUILD_INFO['seconds']:.1f} s, "
          f"{_build.BUILD_INFO['dir']}", flush=True)
    for name, log in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        for line in log.splitlines():      # entry function, then its use
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # host-side spec of the main path (numpy, the port's own build_spec)
    cfg = GOLD.CONFIG
    t0 = time.perf_counter()
    topo = make_dragonfly(8, 4, 4)
    flows = permutation(topo, size_pkts=32, seed=1)
    base = B.build_spec(topo, flows, cfg["base_scheme"],
                        n_ticks=cfg["n_ticks"])
    n_eps = int(base.src_ep.max()) + 1
    shapes = dict(N=base.n_pkt, F=base.n_flows, n_ports=base.n_ports,
                  M=enqueue_bound(base.n_pkt, base.n_ports, n_eps),
                  P=base.weights.shape[1], qsize=base.qsize,
                  kmin=base.kmin, kmax=base.kmax,
                  explore_threshold=base.explore_threshold)
    print(f"spec: {base.name} built in {time.perf_counter() - t0:.1f} s; "
          f"shapes {shapes}", flush=True)

    # 3. tick kernel checks
    nums = check_kernels(ops, KREF, E.sorted_rank, torch, np, shapes)
    for name, v in nums.items():
        print(f"kernel {name}: equal to plain; kernel {v['ms'] * 1e3:.2f} us,"
              f" plain {v['plain_ms'] * 1e3:.2f} us"
              + (f", library {v['library_ms'] * 1e3:.2f} us"
                 if v["library_ms"] is not None else "")
              + f", {v['bytes']} B", flush=True)
    print(f"kernel flow_agg (K=2): {nums['flow_agg']['ms_k2'] * 1e3:.2f} us",
          flush=True)
    agg = nums["flow_agg"]
    print(f"kernel flow_agg device time ({timed_by('flow_agg')}, zero fill "
          f"included): K 6 bool rows {agg['device_us']:.2f} us a call, "
          f"K 2 int32 "
          f"{agg['k2_device_us']:.2f} us; index_add_ (K 6 int32, its zero "
          f"fill included) {agg['library_device_us']:.2f} us a call",
          flush=True)
    for name in ("spritz_select", "red_ecn", "tick_draws"):
        print(f"kernel {name} device time ({timed_by(name)}): "
              f"{nums[name]['device_us']:.2f} us a call", flush=True)
    tick_ptx = {}
    for name, lib, pattern in (
            ("spritz_select", "spritz_select", "spritz_select_kernel"),
            ("flow_agg", "flow_agg", "flow_agg_kernel"),
            ("tick_rank", "tick_rank", "tick_rank_")):
        ents = ptxas_entries(_build.BUILD_INFO.get("ptxas", {})
                             .get(lib, ""))
        tick_ptx[name] = {k: v for k, v in ents.items() if pattern in k}
        if not tick_ptx[name]:
            fail(f"{name}: no ptxas report of its kernel")
        print(f"kernel {name} ptxas (registers / static shared memory / "
              "stack / spill bytes): "
              + ", ".join(f"{k} {v['registers']} / {v['smem_bytes']} / "
                          f"{v['stack_bytes']} / {v['spill_bytes']}"
                          for k, v in sorted(tick_ptx[name].items())),
              flush=True)
    if any(v["stack_bytes"] or v["spill_bytes"]
           for v in tick_ptx["spritz_select"].values()):
        fail("spritz_select: a stack frame or spills in the ptxas report")
    tr = nums["tick_rank"]
    print(f"kernel tick_rank at M {shapes['M']}, n_ports {shapes['n_ports']}"
          f": path {tr['path']}, {tr['segs']} segments, {tr['smem_bytes']} B"
          f" of shared memory; device time ({timed_by('tick_rank')}) "
          f"{tr['device_us']:.2f} us a call; the engine's torch form "
          f"(argsort + cummax + scatter) {tr['torch_form_device_us']:.2f} us"
          f" a call on the device, {tr['torch_form_ms'] * 1e3:.2f} us "
          f"wrapper", flush=True)
    fu = nums["tick_rank_red_ecn"]
    # the fused smem entry (kRed = true) of the tick_rank library
    fu_ptx = next((v for k, v in tick_ptx["tick_rank"].items()
                   if "tick_rank_smem_kernelILb1E" in k), None)
    if fu_ptx is None:
        fail("tick_rank_red_ecn: no ptxas report of its smem kernel")
    fu.update(registers=fu_ptx["registers"],
              stack_bytes=fu_ptx["stack_bytes"],
              spill_bytes=fu_ptx["spill_bytes"],
              static_smem_bytes=fu_ptx["smem_bytes"])
    print(f"kernel tick_rank_red_ecn at M {shapes['M']}, n_ports "
          f"{shapes['n_ports']}: path {fu['path']}, {fu['segs']} segments; "
          f"device time ({timed_by('tick_rank_red_ecn')}) "
          f"{fu['device_us']:.2f} us a call against tick_rank alone "
          f"{tr['device_us']:.2f} + red_ecn alone "
          f"{nums['red_ecn']['device_us']:.2f} = "
          f"{tr['device_us'] + nums['red_ecn']['device_us']:.2f} us; "
          f"wrapper {fu['ms'] * 1e3:.2f} us; ptxas {fu['registers']} "
          f"registers, {fu['stack_bytes']} B stack, {fu['spill_bytes']} B "
          f"spills, shared memory {fu['static_smem_bytes']} B static + "
          f"{fu['dynamic_smem_bytes']} B dynamic", flush=True)

    # 4. engine path: each run through the captured graph loop
    golden = GOLD.load()["schemes"]
    launches = dict.fromkeys(KERNELS, 0)
    specs = {s: B.respec_scheme(base, s) for s in GOLD.SCHEMES}
    for s, spec in specs.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = E.run(spec, seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        rank_paths = dict(ops.TICK_RANK_PATHS)
        for k in launches:
            launches[k] += counts[k]
        check_golden(f"main {s}", res, golden[s], GOLD, np)
        check_replays(f"main {s}", res, counts, rank_paths, E,
                      s.startswith("spritz"), "tick_rank_red_ecn")
        print(f"main {s}: equal to golden; ticks {res.ticks_simulated} "
              f"steps {res.steps_executed}, replays {res.replays}; wall "
              f"{wall:.3f} s ({res.steps_executed / wall:.1f} steps/s, first "
              f"run, the capture included); launches {counts}; tick_rank "
              f"paths {rank_paths}", flush=True)
    # warm repeat, timed only (launches not counted)
    for s, spec in specs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = E.run(spec, seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"main {s} warm: wall {wall:.3f} s, "
              f"{res.steps_executed / wall:.1f} steps/s, "
              f"{res.ticks_simulated / wall:.1f} ticks/s", flush=True)
    if profile:
        run_profile(E, specs["spritz_spray_w"], cfg["seed"], torch, wall,
                    "main spritz_spray_w")
    # 4c. the four schemes as one run_batch call (the golden record came
    # from the reference's run_batch)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    batch = E.run_batch(base, schemes=list(GOLD.SCHEMES), seeds=[cfg["seed"]],
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    rank_paths = dict(ops.TICK_RANK_PATHS)
    replays = {"all": 0, "spritz": 0}
    for s, res in zip(GOLD.SCHEMES, batch):
        check_golden(f"batch {s}", res, golden[s], GOLD, np)
        if not 0 <= res.replays - res.steps_executed < E.STEPS_PER_READ:
            fail(f"batch {s}: {res.replays} replays for "
                 f"{res.steps_executed} steps")
        replays["all"] += res.replays
        if s.startswith("spritz"):
            replays["spritz"] += res.replays
    want = dict.fromkeys(KERNELS, 0)
    want.update(flow_agg=2 * replays["all"],
                tick_rank_red_ecn=replays["all"],
                tick_draws=replays["all"], spritz_select=replays["spritz"])
    if counts != want or rank_paths != {"smem": replays["all"],
                                        "pairwise": 0}:
        fail(f"batch: launches {counts}, tick_rank paths {rank_paths}; want "
             f"{want} on the smem path")
    for k in launches:
        launches[k] += counts[k]
    print(f"batch {'/'.join(GOLD.SCHEMES)}: one run_batch call, every lane "
          f"equal to golden; steps "
          f"{[r.steps_executed for r in batch]}, replays "
          f"{[r.replays for r in batch]}; wall {wall:.3f} s "
          f"({sum(r.steps_executed for r in batch) / wall:.1f} steps/s, "
          f"graphs warm); launches {counts}", flush=True)
    # 4d. the graph loop against the eager loop (the same gated step, its
    # wrappers called each step, the stop flag read after each)
    graph_vs_eager(E, GOLD, specs["spritz_spray_w"], cfg["seed"],
                   "main spritz_spray_w", torch)
    # 4b. failover path
    failover = failover_path(GOLD, B, E, FF, ops, topo, flows, torch, np,
                             profile)
    card = card_line()
    # 4e. the experiment matrix's packet-engine smoke cells, through the
    # port's runner
    cells = matrix_path(GOLD, E, ops, torch, card)
    launches_by_path = {k: {"permutation": launches[k],
                            "failover": failover[k], "matrix": cells[k]}
                        for k in TICK_KERNELS}
    for k in TICK_KERNELS:
        launches[k] += failover[k] + cells[k]

    # 5. model kernel checks
    rwkv_lib = ctypes.CDLL(str(_build.build()["rwkv6_chunked"]))
    nums.update(check_model_kernels(ops, KREF, torch, np,
                                    rwkv_lib.rwkv6_chunked_smem_bytes))
    ptx = rwkv_ptxas(_build.BUILD_INFO.get("ptxas", {})
                     .get("rwkv6_chunked", ""))
    print("kernel rwkv6_chunked ptxas (registers, spill bytes): "
          + ", ".join(f"{k} {r} / {sp}" for k, (r, sp) in sorted(ptx.items())),
          flush=True)
    for name in TICK_KERNELS:
        nums[name].update(bound_ms=nums[name]["bytes"] / HBM_BYTES_PER_S
                          * 1e3, bound_by="bytes")
    # 6. card against CPU, reduced configs
    card_vs_cpu(C, LM, STEP, torch, np)
    # 7. prefill against decode, full width
    prefill_vs_decode(C, LM, torch, np)
    # 8. serving path, full published configs
    for arch, kernel in SERVE_ARCHS.items():
        launches[kernel] = serve_path(arch, C, Server, STEP, ops, torch, np,
                                      card, profile)[kernel]

    # 9. result lines
    rows = []
    for name, (src, replaces) in KERNELS.items():
        v = nums[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"]})
    flash = next(r for r in rows if r["name"] == "flash_attention")
    flash["path"] = nums["flash prefill bf16"]["path"]
    for key in ("device_ms", "library_device_ms"):
        flash[key] = nums["flash prefill bf16"][key]
    for label in ("decode bf16", "window 4096 f32"):
        key = label.replace(" ", "_")
        flash[f"{key}_ms"] = nums[f"flash {label}"]["ms"]
        flash[f"{key}_library_ms"] = nums[f"flash {label}"]["library_ms"]
        flash[f"{key}_device_ms"] = nums[f"flash {label}"]["device_ms"]
        flash[f"{key}_library_device_ms"] = \
            nums[f"flash {label}"]["library_device_ms"]
        flash[f"{key}_bound_ms"] = nums[f"flash {label}"]["bound_ms"]
        flash[f"{key}_path"] = nums[f"flash {label}"]["path"]
    rwkv = next(r for r in rows if r["name"] == "rwkv6_chunked")
    for key in ("device_ms", "smem_bytes"):
        rwkv[key] = nums["rwkv prefill chunk 16"][key]
    rwkv["registers"] = ptx.get("f32 CP16", (None, None))[0]
    for label in ("prefill chunk 64", "strong decay chunk 32"):
        key = label.replace(" ", "_")
        for k2 in ("ms", "device_ms", "bound_ms"):
            rwkv[f"{key}_{k2}"] = nums[f"rwkv {label}"][k2]
    agg = next(r for r in rows if r["name"] == "flow_agg")
    for key in ("device_us", "k2_device_us", "library_device_us"):
        agg[key] = nums["flow_agg"][key]
    # the instantiation of the main path: P 64 (two registers a lane);
    # 1-byte rows (phase A). Both launch with no dynamic shared memory, so
    # ptxas's static figure is all the block holds.
    for row, key in ((next(r for r in rows if r["name"] == "spritz_select"),
                      "spritz_select_kernelILi2E"),
                     (agg, "flow_agg_kernelIhE")):
        ent = next(v for k, v in tick_ptx[row["name"]].items() if key in k)
        row.update(registers=ent["registers"],
                   stack_bytes=ent["stack_bytes"],
                   smem_bytes=ent["smem_bytes"])
    for name in ("spritz_select", "red_ecn", "tick_draws"):
        next(r for r in rows if r["name"] == name)["device_us"] = \
            nums[name]["device_us"]
    next(r for r in rows if r["name"] == "tick_rank_red_ecn").update(
        {k: nums["tick_rank_red_ecn"][k] for k in (
            "device_us", "path", "segs", "registers", "stack_bytes",
            "spill_bytes", "static_smem_bytes", "dynamic_smem_bytes")})
    for row in rows:
        if row["name"] in launches_by_path:
            row["launches_by_path"] = launches_by_path[row["name"]]
    rank_row = next(r for r in rows if r["name"] == "tick_rank")
    for key in ("device_us", "path", "segs", "smem_bytes",
                "torch_form_device_us", "torch_form_ms"):
        rank_row[key] = nums["tick_rank"][key]
    for row in rows:
        if any("device" in key for key in row):
            late = [w for w in EVENT_TIMED if w.split()[0] == row["name"]]
            row["device_time_by"] = ("CUDA events for " + "; ".join(late)
                                     if late else "torch.profiler")
    if EVENT_TIMED:
        print("device times by CUDA events, torch.profiler having recorded "
              f"no CUDA kernel: {'; '.join(EVENT_TIMED)}", flush=True)
    else:
        print("device times: all from torch.profiler", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all, "
          f"the build included", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def check_golden(label, res, want, GOLD, np) -> None:
    """A run equals its golden record, every flow done, no violation."""
    got = GOLD.summarize(res)
    if got != want:
        fail(f"{label}: result differs from the record in "
             f"{[k for k in got if got[k] != want[k]]}")
    if res.down_violations or res.rate_violations or \
            not bool(np.all(res.done)):
        fail(f"{label}: down_violations {res.down_violations}, "
             f"rate_violations {res.rate_violations}, done "
             f"{int(np.sum(res.done))}/{len(res.done)}")


def check_replays(label, res, counts, paths, E, spritz: bool,
                  rank: str) -> None:
    """The run replayed its captured step ``res.replays`` times, fewer
    than one read's batch past its last step, and each replay launched
    flow_agg twice and ``rank``, tick_draws and (Spritz) spritz_select
    once, ``rank`` on its shared-memory path; nothing else."""
    n, r = res.steps_executed, res.replays
    if not 0 <= r - n < E.STEPS_PER_READ:
        fail(f"{label}: {r} replays for {n} steps (reads every "
             f"{E.STEPS_PER_READ})")
    want = dict.fromkeys(counts, 0)
    want.update({"flow_agg": 2 * r, rank: r, "tick_draws": r})
    if spritz:
        want["spritz_select"] = r
    if counts != want or paths != {"smem": r, "pairwise": 0}:
        fail(f"{label}: launches {counts}, tick_rank paths {paths}; want "
             f"{want} on the smem path ({r} replays)")


def graph_vs_eager(E, GOLD, spec, seed, label, torch) -> None:
    """``engine.run`` (the captured step, replayed) against the private
    eager loop on one spec: equal results and final carry; then the
    warm steps/s of both in turns (eager, graph, graph, eager)."""
    g, g_st = E.run(spec, seed=seed, device="cuda", return_carry=True)
    e, e_st = E._eager_run(spec, seed, device="cuda", return_carry=True)
    bad = same_state(g_st, e_st)
    if GOLD.summarize(g) != GOLD.summarize(e) or bad:
        fail(f"{label}: the graph loop differs from the eager loop (carry "
             f"leaves {bad})")
    runs = {"eager": lambda: E._eager_run(spec, seed, device="cuda"),
            "graph": lambda: E.run(spec, seed=seed, device="cuda")}
    rates = []
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        rates.append((name, res.steps_executed / (time.perf_counter() - t0)))
    print(f"{label}: graph loop equal to the eager loop, final carry "
          f"included ({g.steps_executed} steps, {g.replays} replays); warm "
          f"steps/s " + ", ".join(f"{n} {r:.1f}" for n, r in rates),
          flush=True)


def same_state(a: dict, b: dict, path: str = "") -> list:
    """Keys of two nested-NumPy carry states whose arrays differ."""
    import numpy as np
    bad = []
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            bad += same_state(x, y, f"{path}{k}.")
        elif x is None or y is None or x.dtype != y.dtype or \
                not np.array_equal(x, y):
            bad.append(path + k)
    return bad


def failover_path(GOLD, B, E, FF, ops, topo, flows, torch, np,
                  profile=False) -> dict:
    """Phase 4b: the DF-1056 permutation under the failover record's two
    plans, every listed scheme on the card, kernels on.  Launches are
    counted per run from just before it to just after; returns their
    sums by kernel."""
    record = GOLD.load(GOLD.FAILOVER_GOLDEN)
    if record["config"] != GOLD.FAILOVER_CONFIG:
        fail("failover record: config differs from data.FAILOVER_CONFIG")
    cfg = GOLD.FAILOVER_CONFIG
    totals = dict.fromkeys(KERNELS, 0)
    specs, walls = {}, {}
    for plan in GOLD.FAILOVER_PLANS:
        want = record["plans"][plan]
        compiled = GOLD.failover_schedule(FF, topo, plan).compile()
        if compiled.n_events != want["n_events"]:
            fail(f"failover {plan}: {compiled.n_events} events, record "
                 f"{want['n_events']}")
        rate = compiled.has_rate_events
        if rate != (plan == "degraded"):
            fail(f"failover {plan}: has_rate_events {rate}")
        base = B.build_spec(topo, flows, cfg["base_scheme"],
                            n_ticks=cfg["n_ticks"], failure_plan=compiled,
                            block_ticks=cfg["block_ticks"])
        for s in GOLD.FAILOVER_SCHEMES[plan]:
            spec = specs[plan, s] = B.respec_scheme(base, s)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = E.run(spec, seed=cfg["seed"], device="cuda")
            torch.cuda.synchronize()
            wall = walls[plan, s] = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            paths = dict(ops.TICK_RANK_PATHS)
            for k in totals:
                totals[k] += counts[k]
            check_golden(f"failover {plan} {s}", res, want["schemes"][s],
                         GOLD, np)
            check_replays(f"failover {plan} {s}", res, counts, paths, E,
                          s.startswith("spritz"),
                          "tick_rank" if rate else "tick_rank_red_ecn")
            n = res.steps_executed
            print(f"failover {plan} {s}: equal to the record; ticks "
                  f"{res.ticks_simulated} steps {n}, replays {res.replays}; "
                  f"violations down 0 rate 0; wall {wall:.3f} s "
                  f"({n / wall:.1f} steps/s, first run, the capture "
                  f"included); launches {counts}; tick_rank paths {paths}",
                  flush=True)

    # segments: spritz_spray_w on midrun cut at the end of the outage
    spec = specs["midrun", "spritz_spray_w"]
    full, full_state = E.run(spec, seed=cfg["seed"], device="cuda",
                             return_carry=True)
    bound = GOLD.FAILOVER_WINDOW[1]
    res, st = E.run(spec, seed=cfg["seed"], device="cuda", until_tick=bound,
                    return_carry=True)
    if not bound <= res.ticks_simulated < full.ticks_simulated:
        fail(f"failover resume: the first segment stopped at "
             f"{res.ticks_simulated}, want [{bound}, "
             f"{full.ticks_simulated})")
    res2, st2 = E.run(spec, device="cuda", resume=E.checkpoint(res, st),
                      return_carry=True)
    bad = same_state(st2, full_state)
    if GOLD.summarize(res2) != GOLD.summarize(full) or bad:
        fail(f"failover resume: segmented run differs from the unsegmented "
             f"one (carry leaves {bad})")
    print(f"failover resume midrun spritz_spray_w: segments [0, "
          f"{res.ticks_simulated}] ({res.steps_executed} steps) and on to "
          f"{res2.ticks_simulated} ({res2.steps_executed} steps in all) equal"
          f" the unsegmented run, final carry included", flush=True)

    # warm repeats, timed only (launches not counted)
    for key in [("midrun", s) for s in ("ugal_l", "ops_u", "reps",
                                        "spritz_spray_w")] + \
            [("degraded", "spritz_spray_w")]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = E.run(specs[key], seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        print(f"failover {key[0]} {key[1]} warm: wall {walls[key]:.3f} s, "
              f"{res.steps_executed / walls[key]:.1f} steps/s, "
              f"{res.ticks_simulated / walls[key]:.1f} ticks/s", flush=True)
    graph_vs_eager(E, GOLD, specs["midrun", "spritz_spray_w"], cfg["seed"],
                   "failover midrun spritz_spray_w", torch)
    if profile:
        for plan in GOLD.FAILOVER_PLANS:
            run_profile(E, specs[plan, "spritz_spray_w"], cfg["seed"], torch,
                        walls[plan, "spritz_spray_w"],
                        f"failover {plan} spritz_spray_w")
    return totals


def matrix_path(GOLD, E, ops, torch, card: str) -> dict:
    """Phase 4e: every registered smoke cell that runs the packet engine
    (``data.SMOKE_CELLS``), at its registered size, through the port's
    runner (``run_cell``, ``force=True``, a temporary directory) on the
    card.  Every guard must pass and every row must equal the
    reference's record (``smoke_cells_golden.json``), wall-time fields
    excluded.  Launches are counted per cell from just before it to just
    after; ``run_batch`` and the loop's capture are wrapped to count the
    steps, replays and graph captures each cell made.  Returns the
    launches' sums by kernel."""
    import tempfile

    from repro_torch.exp import matrix, runner
    record = GOLD.load(GOLD.SMOKE_GOLDEN)["cells"]
    if tuple(record) != GOLD.SMOKE_CELLS:
        fail(f"smoke record: cells {list(record)}, want "
             f"{list(GOLD.SMOKE_CELLS)}")
    tally = dict.fromkeys(("steps", "replays", "calls", "captures"), 0)
    inner_batch, inner_capture = E.run_batch, E._Loop._capture

    def run_batch(*a, **kw):
        out = inner_batch(*a, **kw)
        results = out[0] if kw.get("return_carry") else out
        resume = kw.get("resume") or [None] * len(results)
        for res, ck in zip(results, resume):
            # a resumed lane's steps count on from its checkpoint's
            tally["steps"] += res.steps_executed - (
                0 if ck is None else int(ck.steps))
            tally["replays"] += res.replays
        tally["calls"] += 1
        return out

    def capture(loop):
        tally["captures"] += 1
        return inner_capture(loop)

    totals = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    E.run_batch, E._Loop._capture = run_batch, capture
    try:
        with tempfile.TemporaryDirectory() as out:
            for cid in GOLD.SMOKE_CELLS:
                cell, want = matrix.CELLS[cid], record[cid]
                if want["spec"] != json.loads(json.dumps(cell.to_json())):
                    fail(f"{cid}: the record's spec differs from the "
                         f"matrix's")
                tally.update(dict.fromkeys(tally, 0))
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = runner.run_cell(cell, out=Path(out), force=True,
                                      verbose=False, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(ops.LAUNCHES)
                for k in totals:
                    totals[k] += counts[k]
                bad = [g["desc"] for g in res.guards if not g["ok"]]
                if bad:
                    fail(f"{cid}: guards breached: {bad}")
                rows = GOLD.comparable(res.rows)
                if len(rows) != len(want["rows"]):
                    fail(f"{cid}: {len(rows)} rows, record "
                         f"{len(want['rows'])}")
                for i, (got, ref) in enumerate(zip(rows, want["rows"])):
                    diff = sorted(k for k in set(got) | set(ref)
                                  if got.get(k) != ref.get(k))
                    if diff:
                        fail(f"{cid}: row {i} ({got.get('scheme')}) differs"
                             f" from the record in {diff}")
                r = tally["replays"]
                spritz = any(s.startswith("spritz") for s in cell.schemes)
                if counts["tick_draws"] != r or counts["flow_agg"] != 2 * r \
                        or counts["tick_rank"] + \
                        counts["tick_rank_red_ecn"] != r \
                        or counts["red_ecn"] or not r \
                        or bool(counts["spritz_select"]) != spritz \
                        or counts["spritz_select"] > r:
                    fail(f"{cid}: launches {counts} for {r} replays")
                n = tally["steps"]
                print(f"matrix {cid}: {len(rows)} rows equal to the record;"
                      f" guards {len(res.guards)} passed; steps {n}, "
                      f"replays {r} in {tally['calls']} run_batch calls, "
                      f"{tally['captures']} graph captures; wall "
                      f"{wall:.3f} s ({n / wall:.1f} steps/s, captures "
                      f"included); launches {counts}; {card}", flush=True)
    finally:
        E.run_batch, E._Loop._capture = inner_batch, inner_capture
    print(f"matrix: {len(GOLD.SMOKE_CELLS)} cells in "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return totals


def profile_block(label, fn, warm_wall: float, torch, top: int = 8):
    """Device time of the CUDA kernels that ``fn`` launches
    (torch.profiler), against ``warm_wall``, the unprofiled wall time in
    seconds of the same work; prints the kernels with the most device
    time and returns (kernel events, launches, ``fn``'s result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kern:
        print(f"chip_smoke: torch.profiler recorded no CUDA kernel for "
              f"profile {label}; its breakdown is empty", file=sys.stderr,
              flush=True)
    busy_us = sum(e.self_device_time_total for e in kern)
    n_launch = sum(e.count for e in kern)
    print(f"profile {label}: device kernel time {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e4 / warm_wall:.1f} % of the unprofiled wall "
          f"{warm_wall * 1e3:.3f} ms; {n_launch} kernel launches",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile {label}: {e.key[:60]:60s} "
              f"{e.self_device_time_total / 1e3:8.3f} ms {e.count:6d} calls",
              flush=True)
    return kern, n_launch, out


def run_profile(E, spec, seed, torch, warm_wall: float, label: str) -> None:
    """Where one warm engine run spends the card's time: the busy share
    against the unprofiled warm wall time, the kernels launched per step,
    and the device time per call of the tick kernels."""
    kern, n_launch, res = profile_block(
        label, lambda: E.run(spec, seed=seed, device="cuda"), warm_wall,
        torch, top=12)
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"profile {label}: {res.steps_executed} steps, {res.replays} "
          f"replays of the captured step; "
          f"{n_launch / res.replays:.1f} launches per replay, "
          f"{busy_us / 1e3 / res.replays:.4f} ms of device time a "
          f"replay", flush=True)
    tick = re.compile(r"(?:void )?((?:flow_agg|tick_rank_smem|"
                      r"tick_rank_pairwise|red_ecn|tick_draws|"
                      r"spritz_select)_kernel"
                      r"(?:<[^>]*>)?)\(")
    for e in kern:
        m = tick.match(e.key)
        if m:
            print(f"profile {label}: {m.group(1)} device "
                  f"{e.self_device_time_total / e.count:.2f} us per call, "
                  f"{e.count} calls", flush=True)


if __name__ == "__main__":
    main()
