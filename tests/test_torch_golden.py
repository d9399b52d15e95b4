"""The JAX reference reproduces the port's committed DF-1056 golden record.

``src/repro_torch/data/df1056_permutation_golden.json`` is what
``chip_smoke.py`` holds the port's run on the card against.  This test
reruns the reference (one ``run_batch`` over the four schemes on the
jnp path, JAX on the CPU) and requires every field to match, so the
record cannot drift from the reference.  Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""
import json
import sys

import pytest

pytest.importorskip("torch")

from repro.net.sim import build as B  # noqa: E402
from repro.net.sim import engine as E  # noqa: E402
from repro.net.topology.dragonfly import make_dragonfly  # noqa: E402
from repro.net.workloads.synthetic import permutation  # noqa: E402
from repro_torch import data as GOLD  # noqa: E402


def reference_run():
    """The reference's runs of every scheme: results and final carries."""
    cfg = GOLD.CONFIG
    topo = make_dragonfly(8, 4, 4)
    flows = permutation(topo, size_pkts=32, seed=1)
    base = B.build_spec(topo, flows, cfg["base_scheme"],
                        n_ticks=cfg["n_ticks"])
    return E.run_batch(base, schemes=list(GOLD.SCHEMES), seeds=[cfg["seed"]],
                       return_carry=True)


def reference_record(results) -> dict:
    return {"config": GOLD.CONFIG,
            "source": "repro.net.sim.engine.run_batch, jnp path, JAX on CPU",
            "schemes": {s: GOLD.summarize(r)
                        for s, r in zip(GOLD.SCHEMES, results)}}


def test_reference_reproduces_golden_record():
    want = GOLD.load()
    results, states = reference_run()
    got = reference_record(results)
    # no DCTCP round of these runs sees a mark: alpha ends 0 in every
    # flow, so the record needs no hash of the alpha and cwnd carry (the
    # marking test of test_torch_engine.py compares those)
    for s, st in zip(GOLD.SCHEMES, states):
        assert not st["alpha"].any(), s
    assert got["config"] == want["config"]
    for s in GOLD.SCHEMES:
        assert got["schemes"][s] == want["schemes"][s], s
        assert want["schemes"][s]["down_violations"] == 0
        assert want["schemes"][s]["rate_violations"] == 0
    # every flow finished in every scheme
    for s in GOLD.SCHEMES:
        assert want["schemes"][s]["ticks_simulated"] < GOLD.CONFIG["n_ticks"]


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: test_torch_golden.py --write")
    GOLD.GOLDEN.write_text(
        json.dumps(reference_record(reference_run()[0]), indent=1) + "\n")
    print(f"wrote {GOLD.GOLDEN}")
