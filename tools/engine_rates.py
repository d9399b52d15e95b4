"""The packet engine's launches a replay, device time a replay and warm
steps/s at DF-1056, on the card.

    PYTHONPATH=src python tools/engine_rates.py [--reps 10] [--label NAME] \
        [--profile] [--only PLAN[:SCHEME] ...]

The specs are ``chip_smoke.py``'s phase 4 and 4b ones: the 1,056-endpoint
Dragonfly permutation (``data.CONFIG``) for ecmp, ugal_l, spritz_scout
and spritz_spray_w, and the same under the ``degraded`` capacity plan
for its five schemes (``data.FAILOVER_SCHEMES``); ``--only`` keeps those
named (``permutation:ugal_l``, ``degraded``).  Each spec runs once
through ``engine.run`` (the graph's capture; the wrappers' launches a
replay from ``ops.LAUNCHES``), then ``--reps`` times warm, each timed on
the host clock up to a synchronize; with ``--profile`` then once under
``torch.profiler`` (a slow trace: the device's kernels and copies a
replay, their device time a replay, and each tick kernel's device time
a call in the loop and its exposed time, from the end of the device
event before it to its own end, which counts the gap before it and not
what a programmatic dependent launch overlaps; null where the trace
recorded none).  One JSON line a spec, the card's name and power limit in
each.

It imports the port from ``PYTHONPATH``, so two trees compare in one
call of the card by running it with each tree's ``src`` in turns
(parent, change, change, parent).  It needs a card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time


# the tick kernels' names in a trace (each instantiation apart)
TICK = re.compile(r"(?:void )?(?:flow_agg|tick_rank_smem|tick_rank_pairwise|"
                  r"red_ecn|tick_draws|spritz_select|weighted_sample)_kernel")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def specs(only=()) -> list:
    """``(plan, scheme, spec)`` of the DF-1056 specs, those ``only`` names
    (``plan`` or ``plan:scheme``) when given."""
    from repro_torch import data as GOLD
    from repro_torch.net.sim import build as B
    from repro_torch.net.sim import failures as FF
    from repro_torch.net.topology.dragonfly import make_dragonfly
    from repro_torch.net.workloads.synthetic import permutation

    cfg, fcfg = GOLD.CONFIG, GOLD.FAILOVER_CONFIG
    topo = make_dragonfly(8, 4, 4)
    flows = permutation(topo, size_pkts=32, seed=1)
    base = B.build_spec(topo, flows, cfg["base_scheme"],
                        n_ticks=cfg["n_ticks"])
    degraded = B.build_spec(
        topo, flows, fcfg["base_scheme"], n_ticks=fcfg["n_ticks"],
        failure_plan=GOLD.failover_schedule(FF, topo, "degraded").compile(),
        block_ticks=fcfg["block_ticks"])
    out = [("permutation", s, B.respec_scheme(base, s))
           for s in GOLD.SCHEMES]
    out += [("degraded", s, B.respec_scheme(degraded, s))
            for s in GOLD.FAILOVER_SCHEMES["degraded"]]
    return [x for x in out if not only or x[0] in only
            or f"{x[0]}:{x[1]}" in only]


def device_events(prof) -> list:
    """The trace's device events (kernels and copies) in start order."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def exposed_us(events, pattern) -> dict:
    """For each kernel name ``pattern`` matches, the median of its calls'
    exposed time (us): its end less the end of the device event before
    it."""
    out: dict = {}
    for prev, e in zip(events, events[1:]):
        if pattern.match(e.name):
            out.setdefault(e.name[:80], []).append(
                e.time_range.end - prev.time_range.end)
    return {k: statistics.median(v) for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", action="append", default=[])
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("engine_rates: needs a card (torch.cuda.is_available() "
                 "is false)")
    from repro_torch import data as GOLD
    from repro_torch.kernels import ops
    from repro_torch.net.sim import engine as E

    seed = GOLD.CONFIG["seed"]
    name = card()
    for plan, scheme, spec in specs(args.only):
        def run():
            return E.run(spec, seed=seed, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        res = run()
        torch.cuda.synchronize()
        r = res.replays
        per = {k: n / r for k, n in ops.LAUNCHES.items() if n}
        rates = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            rates.append(res.steps_executed / (time.perf_counter() - t0))
        kern, exposed = [], {}
        if args.profile:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = run()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA]
            exposed = exposed_us(device_events(prof), TICK)
        print(json.dumps({
            "label": args.label, "plan": plan, "scheme": scheme,
            "steps": res.steps_executed, "replays": res.replays,
            "wrapper_launches_a_replay": per,
            "tick_kernel_us_a_call": {
                e.key[:80]: e.self_device_time_total / e.count
                for e in kern if TICK.match(e.key)},
            "tick_kernel_exposed_us_a_call": exposed,
            "device_events_a_replay": (sum(e.count for e in kern)
                                       / res.replays if kern else None),
            "device_us_a_replay": (sum(e.self_device_time_total
                                       for e in kern) / res.replays
                                   if kern else None),
            "steps_s_median": statistics.median(rates),
            "steps_s": rates, "card": name}), flush=True)


if __name__ == "__main__":
    main()
