"""Golden records of DF-1056 runs of the JAX reference.

``df1056_permutation_golden.json`` holds, per scheme, the counters and a
sum and sha256 of each per-flow result array of one run: the 1,056
endpoint Dragonfly ``make_dragonfly(8, 4, 4)``, ``permutation(size_pkts=32,
seed=1)``, ``n_ticks = 1 << 14``, seed 0, specs ``respec_scheme(base, s)``
of a base built with ``spritz_spray_w``.  The JAX reference produced it
on the CPU (``tests/test_torch_golden.py --write``).

``df1056_failover_golden.json`` holds the same form for that run under
two failure plans (:data:`FAILOVER_PLANS`): ``midrun`` fails 29 sampled
links at tick 16 and recovers them at 528, ``degraded`` runs 72 sampled
links at a quarter of line rate over the same window.  The reference's
solo ``engine.run`` produced it on the CPU
(``tests/test_torch_golden_failover_{midrun,degraded}.py --write``).

``smoke_cells_golden.json`` holds, per cell of :data:`SMOKE_CELLS` (the
smoke tier's packet and packet-fidelity open-loop cells, at their
registered sizes), the cell's spec (``Cell.to_json()``) and the rows the
reference's ``repro.exp.runner.run_cell`` emitted on the CPU, without
the wall-time fields (:data:`WALL_FIELDS`).  Regenerate it with
``tests/test_torch_exp_packet.py --write``.

``chip_smoke.py`` holds the port's runs on the card against all three.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

GOLDEN = Path(__file__).resolve().parent / "df1056_permutation_golden.json"
FAILOVER_GOLDEN = (Path(__file__).resolve().parent
                   / "df1056_failover_golden.json")
SMOKE_GOLDEN = Path(__file__).resolve().parent / "smoke_cells_golden.json"
CONFIG = {
    "topology": "make_dragonfly(8, 4, 4)",
    "workload": "permutation(size_pkts=32, seed=1)",
    "base_scheme": "spritz_spray_w",
    "n_ticks": 1 << 14,
    "seed": 0,
}
# the schemes of engine.dragonfly1056.permutation.quick
SCHEMES = ("ecmp", "ugal_l", "spritz_scout", "spritz_spray_w")
ARRAYS = ("fct_ticks", "delivered", "trims", "timeouts", "ooo", "retx")

# the failover runs: the permutation run above under a failure plan, with
# the block_ticks (4 x size_pkts) and fail window ((16, 528) =
# fail_window(32)) of the experiment matrix's mid-run failure plans
FAILOVER_WINDOW = (16, 528)
FAILOVER_CONFIG = {
    **CONFIG,
    "block_ticks": 128,
    "plans": {
        "midrun": "FailureSchedule(topo).fail_links(16, links).recover(528)"
                  ", links = sample_links(topo, max(1, int(0.02 * 1452)), "
                  "seed=5)",
        "degraded": "FailureSchedule(topo).degrade_links(16, links, 0.25, "
                    "until=528), links = sample_links(topo, "
                    "max(1, int(0.05 * 1452)), seed=5)",
    },
}
FAILOVER_PLANS = {"midrun": 0.02, "degraded": 0.05}    # plan -> link fraction
FAILOVER_SCHEMES = {
    "midrun": ("minimal", "valiant", "ugal_l", "ecmp", "flicr_w", "ops_u",
               "ops_w", "spritz_scout", "spritz_spray_u", "spritz_spray_w",
               "reps"),
    "degraded": ("ugal_l", "flicr_w", "ops_u", "reps", "spritz_spray_w"),
}


def failover_schedule(failures, topo, plan: str):
    """The ``plan`` schedule over ``topo``, built with the ``failures``
    module given (the port's or the reference's ``net.sim.failures``: the
    two compile the same arrays)."""
    links = failures.all_links(topo)
    k = max(1, int(FAILOVER_PLANS[plan] * len(links)))
    links = failures.sample_links(topo, k, seed=5)
    t_fail, t_recover = FAILOVER_WINDOW
    sched = failures.FailureSchedule(topo)
    if plan == "midrun":
        return sched.fail_links(t_fail, links).recover(t_recover)
    return sched.degrade_links(t_fail, links, 0.25, until=t_recover)


def summarize(res) -> dict:
    """The golden form of one result: counters, and per array its sum
    and the sha256 of its int32 bytes."""
    import numpy as np

    out = {"ticks_simulated": int(res.ticks_simulated),
           "steps_executed": int(res.steps_executed),
           "down_violations": int(res.down_violations),
           "rate_violations": int(res.rate_violations)}
    for name in ARRAYS:
        a = np.ascontiguousarray(np.asarray(getattr(res, name), np.int32))
        out[name] = {"sum": int(a.sum()),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def load(path: Path = GOLDEN) -> dict:
    return json.loads(path.read_text())


# the smoke tier's cells that run the packet engine, in matrix order
SMOKE_CELLS = ("micro.dragonfly.adversarial.smoke",
               "failures.dragonfly.midrun.smoke",
               "collectives.slimfly.alltoall.smoke",
               "engine.dragonfly.probe.smoke",
               "chaos.dragonfly.s7.smoke",
               "engine.dragonfly1056.permutation.quick",
               "serve.dragonfly.websearch.smoke")
# row fields timed on the host's clock: the only ones that may differ
WALL_FIELDS = ("wall_s", "wall_s_dense_warm", "dense_speedup")


def comparable(rows: list) -> list:
    """Cell rows as the record keeps them: through JSON (tuples become
    lists, as in a result file) and without :data:`WALL_FIELDS`."""
    return [{k: v for k, v in r.items() if k not in WALL_FIELDS}
            for r in json.loads(json.dumps(rows))]
