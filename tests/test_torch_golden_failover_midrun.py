"""The JAX reference reproduces the port's DF-1056 failover record, plan
``midrun``.

``src/repro_torch/data/df1056_failover_golden.json`` is what
``chip_smoke.py`` holds the port's failover runs on the card against.
This test reruns the reference's solo ``engine.run`` (all 11 schemes, the
jnp path, JAX on the CPU) under the ``midrun`` plan and requires every
field to match, so the record cannot drift from the reference.  One file
per plan, so that the two share no worker.  Regenerate this plan's part
with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden_failover_midrun.py --write
"""
import json
import sys

import pytest

pytest.importorskip("torch")

from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.sim import failures as JF  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro.net.workloads.synthetic import permutation  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402

PLAN = "midrun"


def reference_record() -> dict:
    """The reference's solo runs of every scheme of the plan, in the
    golden form."""
    cfg = GOLD.FAILOVER_CONFIG
    topo = make_dragonfly(8, 4, 4)
    flows = permutation(topo, size_pkts=32, seed=1)
    plan = GOLD.failover_schedule(JF, topo, PLAN).compile()
    base = B.build_spec(topo, flows, cfg["base_scheme"],
                        n_ticks=cfg["n_ticks"], failure_plan=plan,
                        block_ticks=cfg["block_ticks"])
    return {"n_events": int(plan.n_events),
            "schemes": {s: GOLD.summarize(E.run(B.respec_scheme(base, s),
                                                seed=cfg["seed"]))
                        for s in GOLD.FAILOVER_SCHEMES[PLAN]}}


def test_reference_reproduces_failover_record():
    record = GOLD.load(GOLD.FAILOVER_GOLDEN)
    assert record["config"] == GOLD.FAILOVER_CONFIG
    want = record["plans"][PLAN]
    got = reference_record()
    assert list(want["schemes"]) == list(GOLD.FAILOVER_SCHEMES[PLAN])
    assert got["n_events"] == want["n_events"]
    for s in GOLD.FAILOVER_SCHEMES[PLAN]:
        assert got["schemes"][s] == want["schemes"][s], s
        w = want["schemes"][s]
        # clean, and every flow finished inside the horizon
        assert w["down_violations"] == w["rate_violations"] == 0, s
        assert w["ticks_simulated"] < GOLD.FAILOVER_CONFIG["n_ticks"], s
    # 29 links, both directions, down at 16 and up at 528
    assert want["n_events"] == 116


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(f"usage: test_torch_golden_failover_{PLAN}.py --write")
    path = GOLD.FAILOVER_GOLDEN
    part = reference_record()
    record = (GOLD.load(path) if path.exists()
              else {"config": GOLD.FAILOVER_CONFIG, "plans": {}})
    record["config"] = GOLD.FAILOVER_CONFIG
    record["source"] = ("repro.net.sim.engine.run, solo, jnp path, JAX on "
                        "CPU")
    record["plans"][PLAN] = part
    record["plans"] = {p: record["plans"][p] for p in GOLD.FAILOVER_PLANS
                       if p in record["plans"]}
    path.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote plan {PLAN} of {path}")
