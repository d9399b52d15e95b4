"""The port's sharding rules (``repro_torch.launch.shardings``) and meshes
(``repro_torch.launch.mesh``) against the reference's, on the CPU.

For every config at its published size, on both production meshes:
``param_specs`` with and without ``fsdp``, ``batch_specs`` and
``cache_specs`` equal the reference's leaf for leaf.  The reference gets
``jax.eval_shape`` trees and a mesh stub with ``.shape`` and
``.axis_names``; the port gets its model's parameter shapes, built on
the ``meta`` device.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import PartitionSpec as P  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import shardings as TS  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

MESHES = {"pod": True, "single": False}


class _Stub:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.axis_names = mesh.axis_names


def _mesh(kind):
    return _Stub(TM.make_production_mesh(multi_pod=MESHES[kind]))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0),
                                                  JC.get_config(arch)))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    model = TLM.LM(TC.get_config(arch), device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {JS._path_str(path): tuple(spec) for path, spec in leaves}


def _port_flat(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{path}/{k}" if path else str(k)))
    return out


def test_mesh_shapes_and_dp_axes():
    """The reference's shapes and names (its ``make_production_mesh``
    needs 256 or 512 devices, so they are written out here)."""
    for multi in (False, True):
        t = TM.make_production_mesh(multi_pod=multi)
        want = ({"pod": 2, "data": 16, "model": 16} if multi
                else {"data": 16, "model": 16})
        assert t.shape == want and t.axis_names == tuple(want)
        assert t.size == 256 * (1 + multi)
        assert TM.dp_axes(t) == JM.dp_axes(_Stub(t))
    s = TM.make_smoke_mesh()
    j = JM.make_smoke_mesh()
    assert s.shape == dict(j.shape) and s.axis_names == j.axis_names
    assert TM.dp_axes(s) == JM.dp_axes(j) == ("data",)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_specs_equal(arch, mesh, fsdp):
    m = _mesh(mesh)
    want = _ref_flat(JS.param_specs(JC.get_config(arch), _ref_params(arch),
                                    m, fsdp=fsdp))
    got = _port_flat(TS.param_specs(TC.get_config(arch), _port_shapes(arch),
                                    m, fsdp=fsdp))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    if fsdp:
        assert any(any(isinstance(a, tuple) or a in ("data",) for a in s)
                   for s in got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_batch_specs_equal(arch, mesh):
    m = _mesh(mesh)
    for kind in ("train", "serve"):
        for batch in (32, 1):
            want = JS.batch_specs(JC.get_config(arch), m, batch=batch,
                                  kind=kind)
            got = TS.batch_specs(TC.get_config(arch), m, batch=batch,
                                 kind=kind)
            assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cache_specs_equal(arch, mesh):
    m = _mesh(mesh)
    cfg = JC.get_config(arch)
    for batch, max_len in ((32, 32768), (1, 524288), (1, 1000)):
        tree = jax.eval_shape(lambda: JLM.init_cache(cfg, batch, max_len))
        want = JS.cache_specs(cfg, m, batch=batch, max_len=max_len)
        got = TS.cache_specs(TC.get_config(arch), m, batch=batch,
                             max_len=max_len)
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert leaves
        for path, leaf in leaves:
            ps = JS._path_str(path)
            assert got(ps, leaf.shape) == tuple(want(path, leaf)), ps


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_rows_follow_the_rules(mesh):
    """The MoE expert rows the port splits at run time: experts over
    'model' when it divides them, else the f dimension."""
    m = _mesh(mesh)
    for arch, want in (("deepseek_moe_16b", ("model", None, None)),
                       ("mixtral_8x7b", (None, None, "model"))):
        cfg = TC.get_config(arch)
        E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
        assert TS.leaf_spec(cfg, "moe/w_gate", (E, d, f), m) == want
        down = TS.leaf_spec(cfg, "moe/w_down", (E, f, d), m)
        assert down == (want[0], want[2], None)


@pytest.mark.parametrize("n_model", [2, 3, 4, 6, 8, 16])
def test_expert_dim_agrees_with_rules(n_model):
    """``moe.expert_dim`` / ``moe.local_rows``, which split the expert
    rows at run time, put 'model' where ``leaf_spec`` does for every MoE
    config (a rank's block is its slice of that dimension), and refuse
    where the rules' divisibility guard replicates."""
    arches = [a for a in JC.ARCHS if TC.get_config(a).moe is not None]
    assert arches
    for arch in arches:
        cfg = TC.get_config(arch)
        E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
        for r in range(n_model):
            m = TM.Mesh({"data": 1, "model": n_model},
                        {"data": 0, "model": r})
            for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                                ("w_down", (E, f, d))):
                spec = TS.leaf_spec(cfg, f"moe/{name}", shape, m)
                dim = TMOE.expert_dim(cfg, name, m)
                t = torch.empty(shape, device="meta")
                if "model" not in spec:
                    with pytest.raises(ValueError):
                        TMOE.local_rows(cfg, name, t, m)
                    continue
                assert spec == tuple("model" if i == dim else None
                                     for i in range(3)), (arch, name, spec)
                want = list(shape)
                want[dim] //= n_model
                assert tuple(TMOE.local_rows(cfg, name, t, m).shape) == \
                    tuple(want)
