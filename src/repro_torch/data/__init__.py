"""Golden record of the DF-1056 permutation run.

``df1056_permutation_golden.json`` holds, per scheme, the counters and a
sum and sha256 of each per-flow result array of one run: the 1,056
endpoint Dragonfly ``make_dragonfly(8, 4, 4)``, ``permutation(size_pkts=32,
seed=1)``, ``n_ticks = 1 << 14``, seed 0, specs ``respec_scheme(base, s)``
of a base built with ``spritz_spray_w``.  The JAX reference produced it
on the CPU (``tests/test_torch_golden.py --write``); ``chip_smoke.py``
holds the port's run on the card against it.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

GOLDEN = Path(__file__).resolve().parent / "df1056_permutation_golden.json"
CONFIG = {
    "topology": "make_dragonfly(8, 4, 4)",
    "workload": "permutation(size_pkts=32, seed=1)",
    "base_scheme": "spritz_spray_w",
    "n_ticks": 1 << 14,
    "seed": 0,
}
SCHEMES = ("ecmp", "spritz_scout", "spritz_spray_w")
ARRAYS = ("fct_ticks", "delivered", "trims", "timeouts", "ooo", "retx")


def summarize(res) -> dict:
    """The golden form of one result: counters, and per array its sum
    and the sha256 of its int32 bytes."""
    import numpy as np

    out = {"ticks_simulated": int(res.ticks_simulated),
           "steps_executed": int(res.steps_executed),
           "down_violations": int(res.down_violations)}
    for name in ARRAYS:
        a = np.ascontiguousarray(np.asarray(getattr(res, name), np.int32))
        out[name] = {"sum": int(a.sum()),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def load() -> dict:
    return json.loads(GOLDEN.read_text())
