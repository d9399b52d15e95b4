#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the final line):

1. card: name and power limit from nvidia-smi;
2. build: compile the four CUDA tick kernels from ``src/repro_torch``
   with nvcc for sm_90a;
3. kernel checks: each kernel against its plain torch version on the
   card, at the packet engine's DF-1056 shapes plus ragged sizes and
   out-of-range entries, required ``torch.equal``; CUDA-event times of
   kernel, plain version and (flow_agg) ``index_add_``;
4. main path: the 1,056-endpoint Dragonfly permutation run for ecmp,
   spritz_scout and spritz_spray_w through ``engine.run`` on the card,
   kernels on, held against the committed golden record of the JAX
   reference; every kernel must have launched;
5. a JSON line of kernel numbers, then the final JSON line.

``--profile`` adds a ``torch.profiler`` breakdown of one warm run.
Imports torch and the port only, never jax nor the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flow_agg": ("src/repro_torch/kernels/csrc/flow_agg.cu",
                 "src/repro/kernels/flow_agg.py:69"),
    "tick_rank": ("src/repro_torch/kernels/csrc/tick_rank.cu",
                  "src/repro/kernels/tick_rank.py:75"),
    "red_ecn": ("src/repro_torch/kernels/csrc/red_ecn.cu",
                "src/repro/kernels/red_ecn.py:90"),
    "spritz_select": ("src/repro_torch/kernels/csrc/spritz_select.cu",
                      "src/repro/kernels/spritz_select.py:72"),
}


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(ops, ref, torch, np, shapes, dev="cuda") -> dict:
    """Phase 3: kernel vs plain version on the card; returns per-kernel
    numbers at the main path's shapes."""
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
    def agg_inputs(K, n, vmax, sentinels):
        rows = rng.random((K, n)) < 0.05
        rows = rows * rng.integers(1, vmax + 1, (K, n))
        pflow = rng.integers(0, F, n)
        if sentinels:
            pflow[rng.integers(0, n, 64)] = rng.choice([-1, F, F + 7], 64)
        return cu(rows, i32), cu(pflow, i32)

    err = 0.0
    for K, n, vmax, sent in ((6, N, 1, False), (2, N, 4000, False),
                             (6, 1000, 1, True), (3, 257, 9, True)):
        rows, pflow = agg_inputs(K, n, vmax, sent)
        err = max(err, same("flow_agg", ops.flow_agg(rows, pflow, n_flows=F),
                            ref.flow_agg_reference(rows, pflow, n_flows=F)))
    rows, pflow = agg_inputs(6, N, 1, False)
    rows_t = rows.T.contiguous()

    def lib_agg():
        return torch.zeros((F, 6), dtype=i32, device=dev).index_add_(
            0, pflow, rows_t)
    if not torch.equal(lib_agg().T, ops.flow_agg(rows, pflow, n_flows=F)):
        fail("flow_agg: index_add_ yardstick disagrees")
    out["flow_agg"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.flow_agg(rows, pflow, n_flows=F)),
        plain_ms=time_ms(lambda: ref.flow_agg_reference(rows, pflow,
                                                        n_flows=F)),
        library_ms=time_ms(lib_agg),
        bytes=nbytes(rows, pflow) + 6 * F * 4)
    rows2, pflow2 = agg_inputs(2, N, 4000, False)
    out["flow_agg"]["ms_k2"] = time_ms(
        lambda: ops.flow_agg(rows2, pflow2, n_flows=F))

    # ---- tick_rank: a compacted set (valid prefix, sentinel tail), ragged
    def rank_inputs(m, n_valid):
        port = np.full(m, NP_)
        port[:n_valid] = rng.integers(0, NP_, n_valid)
        port[:n_valid:7] = rng.integers(0, 16, len(port[:n_valid:7]))
        port[rng.integers(0, m, 8)] = -1
        return cu(port, i32)

    err = 0.0
    for m, nv in ((M, 4200), (M, M), (1000, 600), (37, 37)):
        port = rank_inputs(m, nv)
        err = max(err, same("tick_rank", ops.tick_rank(port, n_ports=NP_),
                            ref.tick_rank_reference(port, n_ports=NP_)))
    port = rank_inputs(M, 4200)
    out["tick_rank"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_rank(port, n_ports=NP_)),
        plain_ms=time_ms(lambda: ref.tick_rank_reference(port, n_ports=NP_)),
        library_ms=None, bytes=2 * nbytes(port))

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
    outs = ops.red_ecn(eport, rank, enq, unif, q_tail, 70000, **kw)
    out["red_ecn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.red_ecn(eport, rank, enq, unif, q_tail,
                                       70000, **kw)),
        plain_ms=time_ms(lambda: ref.red_ecn_reference(
            eport, rank, enq, unif, q_tail, 70000, **kw)),
        library_ms=None,
        bytes=nbytes(eport, rank, enq, unif, q_tail, *outs))

    # ---- spritz_select: Eq.-1-like rows, zero rows, wide dynamic range
    thr = shapes["explore_threshold"]

    def sel_inputs(f, p, explore_all=False, wide=False):
        w = rng.random((f, p)).astype(np.float32) * 7.0 + 1.0
        if wide:
            w = np.exp(rng.normal(0, 6, (f, p))).astype(np.float32)
        npaths = rng.integers(1, p + 1, f)
        w[np.arange(p)[None, :] >= npaths[:, None]] = 0.0
        w[rng.integers(0, f, 5)] = 0.0
        u = rng.random(f).astype(np.float32)
        front = rng.integers(-1, p, f)
        count = (np.full(f, thr) if explore_all
                 else rng.integers(0, 2 * thr, f))
        return (cu(w, f32), cu(u, f32), cu(front, i32), cu(count, i32))

    err = 0.0
    for f, p, ex, wide in ((F, P, False, False), (F, P, True, False),
                           (F, P, True, True), (1000, 37, True, True),
                           (33, 1, True, False), (257, 200, True, True)):
        args = sel_inputs(f, p, ex, wide)
        err = max(err, same("spritz_select",
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
        library_ms=None, bytes=nbytes(*args, *outs))
    return out


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from repro_torch import data as GOLD
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import ref as KREF
        from repro_torch.net.sim import build as B
        from repro_torch.net.sim import engine as E
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
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

    # 3. kernel checks
    nums = check_kernels(ops, KREF, torch, np, shapes)
    for name, v in nums.items():
        print(f"kernel {name}: equal to plain; kernel {v['ms'] * 1e3:.2f} us,"
              f" plain {v['plain_ms'] * 1e3:.2f} us"
              + (f", library {v['library_ms'] * 1e3:.2f} us"
                 if v["library_ms"] is not None else "")
              + f", {v['bytes']} B", flush=True)
    print(f"kernel flow_agg (K=2): {nums['flow_agg']['ms_k2'] * 1e3:.2f} us",
          flush=True)

    # 4. main path
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
        for k in launches:
            launches[k] += counts[k]
        got = GOLD.summarize(res)
        if got != golden[s]:
            diff = [k for k in got if got[k] != golden[s][k]]
            fail(f"{s}: result differs from the golden record in {diff}")
        if res.down_violations != 0 or not bool(np.all(res.done)):
            fail(f"{s}: down_violations {res.down_violations}, "
                 f"done {int(np.sum(res.done))}/{len(res.done)}")
        need = ["flow_agg", "tick_rank", "red_ecn"]
        if s.startswith("spritz"):
            need.append("spritz_select")
        if any(counts[k] == 0 for k in need):
            fail(f"{s}: a kernel of the path never launched: {counts}")
        print(f"main {s}: equal to golden; ticks {res.ticks_simulated} "
              f"steps {res.steps_executed}; wall {wall:.3f} s "
              f"({res.steps_executed / wall:.1f} steps/s, first run); "
              f"launches {counts}", flush=True)
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
        run_profile(E, specs["spritz_spray_w"], cfg["seed"], torch, wall)

    # 5. result lines
    rows = []
    for name, (src, replaces) in KERNELS.items():
        v = nums[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": v["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_profile(E, spec, seed, torch, warm_wall: float) -> None:
    """Where one warm main-path run spends the card's time
    (torch.profiler): device time of CUDA kernels only, the busy share
    against the unprofiled warm wall time, the kernels launched per step,
    and the device time per call of the port's own kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = E.run(spec, seed=seed, device="cuda")
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    n_launch = sum(e.count for e in kern)
    steps = res.steps_executed
    print(f"profile {spec.name}: device kernel time {busy_us / 1e3:.1f} ms "
          f"over {steps} steps = {busy_us / 1e4 / warm_wall:.1f} % of the "
          f"unprofiled warm wall {warm_wall:.3f} s; {n_launch} kernel "
          f"launches = {n_launch / steps:.0f} per step", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile: {e.key[:70]:70s} {e.self_device_time_total / 1e3:7.2f}"
              f" ms {e.count:6d} calls", flush=True)
    for e in kern:
        if e.key.split("(")[0] in ("flow_agg_kernel", "tick_rank_kernel",
                                   "red_ecn_kernel", "spritz_select_kernel"):
            print(f"profile: {e.key.split('(')[0]} device "
                  f"{e.self_device_time_total / e.count:.2f} us per call, "
                  f"{e.count} calls", flush=True)


if __name__ == "__main__":
    main()
