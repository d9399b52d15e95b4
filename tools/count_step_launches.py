"""Count the device launches of one packet-engine step, on the CPU.

A ``TorchDispatchMode`` counts every aten op of one step that would
launch a kernel on the card (views and allocations excluded); each call
of a kernel wrapper in ``repro_torch.kernels.ops`` counts as its
launches (``flow_agg`` two: its zero fill and the kernel) instead of the
plain version's ops it runs here.  The step is the engine's gated step
(``engine._Loop._step``); on a checkout whose engine has no ``_Loop``
(before the device-side loop), the old driver's step: the horizon, the
stop flag read back with it, and one tick.  The spec is ``--scheme``
(spritz_spray_w by default) on the DF(4,2,2) permutation, or on the
1,056-endpoint Dragonfly with ``--df1056``; the count is taken at step
21.  A wrapper a checkout does not have is not counted.

    PYTHONPATH=src python tools/count_step_launches.py [--df1056] \
        [--scheme ugal_l]

A CPU count, not a device measurement: some ops launch nothing on the
card (a CPU scalar) and the card's profiler counts memcpys too.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops as KOPS
from repro_torch.net.sim import build as TB
from repro_torch.net.sim import engine as TE
from repro_torch.net.topology.dragonfly import make_dragonfly
from repro_torch.net.workloads.synthetic import permutation

NO_LAUNCH = {"select", "slice", "view", "expand", "alias", "_reshape_alias",
             "unsqueeze", "squeeze", "t", "as_strided", "empty", "empty_like",
             "detach", "transpose", "permute", "unbind", "split",
             "split_with_sizes", "_unsafe_view", "lift_fresh", "new_empty",
             "empty_strided", "reshape", "narrow"}
WRAPPER_LAUNCHES = {"flow_agg": 2, "tick_rank": 1, "tick_rank_red_ecn": 1,
                    "spritz_select": 1, "tick_draws": 1,
                    "weighted_sample": 1}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n, self.on, self.ops = 0, True, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.on and name not in NO_LAUNCH:
            self.n += 1
            self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def count_wrappers(counter: Count) -> None:
    """Each wrapper call counts as its launches, not as its plain ops."""
    for name, n in WRAPPER_LAUNCHES.items():
        fn = getattr(KOPS, name, None)
        if fn is None:
            continue

        @functools.wraps(fn)
        def counted(*a, _fn=fn, _n=n, **kw):
            counter.on = False
            try:
                return _fn(*a, **kw)
            finally:
                counter.on = True
                counter.n += _n
        setattr(KOPS, name, counted)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--df1056", action="store_true")
    ap.add_argument("--scheme", default="spritz_spray_w")
    args = ap.parse_args()
    torch.set_num_threads(1)
    topo = make_dragonfly(8, 4, 4) if args.df1056 else make_dragonfly(4, 2, 2)
    spec = TB.build_spec(topo, permutation(topo, size_pkts=32, seed=1),
                         args.scheme, n_ticks=1 << 14)
    counter = Count()
    count_wrappers(counter)
    cpu = torch.device("cpu")
    if hasattr(TE, "_Loop"):
        loop = TE._Loop(spec, cpu, False)
        loop.load(TE.init_carry(spec, 0, cpu), -1, 0,
                  np.ones(spec.n_flows, bool), spec.n_ticks)
        for _ in range(20):
            loop._step()
        counter.n, counter.ops = 0, {}
        with counter:
            loop._step()
        what = "gated step"
    else:
        tick, hor = TE.build_tick(spec, cpu), TE.build_horizon(spec, cpu)
        carry, t = TE.init_carry(spec, 0, cpu), -1
        watch = torch.ones(spec.n_flows, dtype=torch.bool)
        for _ in range(20):
            h = int(hor(carry, t))
            carry, t = tick(carry, h), h
        counter.n, counter.ops = 0, {}
        with counter:
            done = torch.where(watch, carry.fct >= 0, True).all()
            h, _ = torch.stack([hor(carry, t), done.to(torch.int32)]).tolist()
            tick(carry, h)
        what = "step (horizon, stop flag, tick)"
    print(f"{args.scheme} {what}: {counter.n} launches")
    print("by op:", sorted(counter.ops.items(), key=lambda kv: -kv[1]))


if __name__ == "__main__":
    main()
