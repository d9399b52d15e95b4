"""The port's host layer equals the reference's, and the port never
imports jax or the reference package.

Topology, EV path tables, workloads, the registry's host table and
``build_spec`` are numpy code copied into ``repro_torch``; every array
they produce must equal the reference's, field by field, at DF(4,2,2)
and at the paper's DF-1056.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.net import paths as JP  # noqa: E402
from repro.net.policies import registry as JREG  # noqa: E402
from repro.net.sim import build as JB  # noqa: E402
from repro.net.topology import dragonfly as JDF  # noqa: E402
from repro.net.workloads import synthetic as JSYN  # noqa: E402
from repro_torch.net import paths as TP  # noqa: E402
from repro_torch.net.policies import registry as TREG  # noqa: E402
from repro_torch.net.sim import build as TB  # noqa: E402
from repro_torch.net.sim import types as TT  # noqa: E402
from repro_torch.net.topology import dragonfly as TDF  # noqa: E402
from repro_torch.net.workloads import synthetic as TSYN  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLOWS = [(e, 40 + (e % 3), 40 + 8 * (e % 2), 16 * e) for e in range(6)]


def _same_spec(a, b, skip=("use_kernels",)):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k in skip:
            continue
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb and type(va) is type(vb), (k, va, vb)


def _same_flows(a, b):
    assert [dataclasses.astuple(f) for f in a] == \
        [dataclasses.astuple(f) for f in b]


@pytest.mark.parametrize("dims", [(4, 2, 2), (8, 4, 4), (3, 1, 2)])
def test_dragonfly_topology_equal(dims):
    a, b = JDF.make_dragonfly(*dims), TDF.make_dragonfly(*dims)
    assert a.name == b.name and a.params == b.params
    for k in ("nbr", "nbr_type", "sw_group", "port_latency_ticks",
              "static_next", "dist"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.bdp_packets() == b.bdp_packets()
    assert a.slot_of_edge == b.slot_of_edge
    assert a.n_ports == b.n_ports


def test_ev_tables_equal():
    a, b = JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
    for s, d in [(0, 5), (3, 3), (7, 30), (12, 13)]:
        for mp in (None, 8):
            ta = JP.build_ev_table(a, s, d, max_paths=mp)
            tb = TP.build_ev_table(b, s, d, max_paths=mp)
            assert ta.hops == tb.hops
            for k in ("latency_ns", "n_local", "n_global", "mult"):
                np.testing.assert_array_equal(getattr(ta, k), getattr(tb, k))
            np.testing.assert_array_equal(ta.weights(3.0), tb.weights(3.0))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_workloads_equal(seed):
    a, b = JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
    _same_flows(JSYN.permutation(a, 16, seed=seed),
                TSYN.permutation(b, 16, seed=seed))
    _same_flows(JSYN.permutation(a, 8, seed=seed, endpoints=list(range(20))),
                TSYN.permutation(b, 8, seed=seed, endpoints=list(range(20))))
    _same_flows(JSYN.adversarial(a, 16, seed=seed),
                TSYN.adversarial(b, 16, seed=seed))


def test_registry_host_table_equal():
    assert TREG.names() == JREG.names()
    for p, q in zip(JREG.all_policies(), TREG.all_policies()):
        assert (p.name, p.code, p.family, p.uniform_weights, p.pin_minimal,
                p.failover) == (q.name, q.code, q.family, q.uniform_weights,
                                q.pin_minimal, q.failover)
        assert dataclasses.asdict(p.flow_level) == \
            dataclasses.asdict(q.flow_level)


@pytest.mark.parametrize("scheme", ["minimal", "ecmp", "valiant", "ugal_l",
                                    "spritz_scout", "spritz_spray_u",
                                    "spritz_spray_w", "reps"])
def test_build_spec_equal_df422(scheme):
    a, b = JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
    fa = [JB.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    fb = [TB.Flow(s, d, n, start_tick=t) for s, d, n, t in FLOWS]
    _same_spec(JB.build_spec(a, fa, scheme, n_ticks=1 << 12),
               TB.build_spec(b, fb, scheme, n_ticks=1 << 12))
    perm = dict(size_pkts=24, seed=3)
    kw = dict(n_ticks=1 << 12, failed_links=[(0, int(a.nbr[0, 0]))],
              max_paths=16, seed=2)
    _same_spec(JB.build_spec(a, JSYN.permutation(a, **perm), scheme, **kw),
               TB.build_spec(b, TSYN.permutation(b, **perm), scheme, **kw))


def test_respec_scheme_and_lane_arrays_equal():
    a, b = JDF.make_dragonfly(4, 2, 2), TDF.make_dragonfly(4, 2, 2)
    ja = JB.build_spec(a, JSYN.permutation(a, 16, seed=4), "spritz_spray_w")
    tb = TB.build_spec(b, TSYN.permutation(b, 16, seed=4), "spritz_spray_w")
    for s in JREG.names():
        _same_spec(JB.respec_scheme(ja, s), TB.respec_scheme(tb, s))
        for x, y in zip(JREG.lane_arrays(ja, s), TREG.lane_arrays(tb, s)):
            np.testing.assert_array_equal(x, y)


def test_build_spec_equal_df1056():
    a, b = JDF.make_dragonfly(8, 4, 4), TDF.make_dragonfly(8, 4, 4)
    ja = JB.build_spec(a, JSYN.permutation(a, size_pkts=32, seed=1),
                       "spritz_spray_w", n_ticks=1 << 14)
    tb = TB.build_spec(b, TSYN.permutation(b, size_pkts=32, seed=1),
                       "spritz_spray_w", n_ticks=1 << 14)
    _same_spec(ja, tb)
    assert (tb.n_pkt, tb.n_ports, tb.n_flows) == (33856, 3960, 1056)
    assert ja.use_kernels is False and tb.use_kernels is None


def test_spec_from_arrays_roundtrip():
    a = JDF.make_dragonfly(4, 2, 2)
    ja = JB.build_spec(a, JSYN.permutation(a, 16, seed=4), "ecmp")
    tb = TT.spec_from_arrays(dataclasses.asdict(ja))
    _same_spec(ja, tb, skip=())
    with pytest.raises(ValueError):
        TT.spec_from_arrays({"name": "x"})


def test_mib_and_ticks_helpers_equal():
    for mib in (0.001, 1, 2.5, 64):
        assert JB.mib_to_pkts(mib) == TB.mib_to_pkts(mib)
    t = np.arange(0, 5000, 37)
    np.testing.assert_array_equal(JB.ticks_to_us(t), TB.ticks_to_us(t))


_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
import repro_torch.configs as C
for arch in C.ARCHS:
    C.get_config(arch)
    C.get_reduced(arch)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print(" ".join(mods))
'''


def test_port_imports_without_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 40                       # every module was imported
    for m in ("models.common", "models.lm", "models.ssm", "models.convert",
              "models.moe",
              "configs.phi3_medium_14b", "configs.rwkv6_7b", "train.step",
              "launch.serve", "kernels.ops", "net.sim.engine",
              "net.sim.failures", "net.policies.ugal", "net.policies.flicr",
              "net.policies.ops", "net.policies.reps", "net.topology.gf",
              "net.topology.slimfly", "net.workloads.collectives",
              "net.workloads.trace", "net.arrivals", "net.steady", "exp",
              "exp.spec", "exp.matrix", "exp.guards", "exp.hashing",
              "exp.workloads", "exp.packet", "exp.openloop", "exp.host",
              "exp.runner", "exp.__main__", "exp.flow", "exp.cross",
              "exp.report", "fabric", "fabric.flowsim", "fabric.bridge",
              "device", "core", "core.spritz", "train.optim",
              "launch.train", "ckpt", "ckpt.manager", "data.pipeline",
              "launch.mesh", "launch.shardings", "models.tp_align"):
        assert f"repro_torch.{m}" in mods, m


def test_port_sources_name_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    # a module name in a string (importlib) escapes the import pattern
    named = re.compile(r"[\"']repro\.(configs|models|kernels|net|train|"
                       r"launch|exp|fabric)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    for f in files:
        assert not pat.search(f.read_text()), f
        assert not named.search(f.read_text()), f


def test_core_spritz_reexports_the_policy_module():
    """``repro_torch.core.spritz`` holds every name ``repro.core.spritz``
    re-exports, each the port's policy-layer object."""
    from repro.core import spritz as JCS
    from repro_torch.core import spritz as TCS
    from repro_torch.net.policies import base as TPB
    from repro_torch.net.policies import spritz as TPS
    names = [n for n in vars(JCS) if not n.startswith("__")
             and n not in ("annotations",)]
    assert len(names) >= 18
    for n in names:
        want = (TPB.weighted_sample_rows if n == "_weighted_sample"
                else getattr(TPS, n))
        assert getattr(TCS, n) is want, n
    assert (TCS.ACK_OK, TCS.ACK_ECN, TCS.NACK, TCS.TIMEOUT, TCS.NO_FB) == \
        (JCS.ACK_OK, JCS.ACK_ECN, JCS.NACK, JCS.TIMEOUT, JCS.NO_FB)
