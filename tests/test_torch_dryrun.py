"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's sharding specs, and the kernel wrappers' ``meta`` branch, on
the CPU.

Per-rank bytes: for every config at published width, both production
meshes, ``fsdp`` on and off and heads ``tp_align``-ed or not, the
parameters and AdamW's state under the port's specs over its ``meta``
model equal, to the byte, those under the reference's ``param_specs``
over ``jax.eval_shape(lm.init_params)`` / ``optim.adamw_init`` (nothing
compiled); so do the decode caches at ``decode_32k`` and ``long_500k``
through ``cache_specs``.  A leaf's bytes are its elements over the
product of its sharded extents (rounded up per dimension, as XLA pads),
times its element size.
"""
import dataclasses
import functools
import math
import os
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import PartitionSpec as P  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import tp_align as JTA  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

MESHES = {"pod": True, "single": False}
TRAIN = ("train_4k", 4096, 256, "train")
CACHE_SHAPES = [s for s in TC.SHAPES if s[0] in ("decode_32k", "long_500k")]


class _Stub:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.axis_names = mesh.axis_names


def _ref_cfg(arch, aligned):
    cfg = JC.get_config(arch)
    return JTA.aligned(cfg, tp=16) if aligned else cfg


@functools.lru_cache(maxsize=None)
def _ref_params(arch, aligned):
    cfg = _ref_cfg(arch, aligned)
    return jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_model(arch, aligned):
    return LM(DR.config_of(arch, aligned), device="meta")


def _ref_bytes(shapes, specs, mesh) -> int:
    """Sum over leaves of the reference tree ``shapes`` under ``specs``."""
    flat = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0])
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(flat[path]) + (None,) * len(leaf.shape)
        n = jnp.dtype(leaf.dtype).itemsize
        for d, ax in zip(leaf.shape, spec):
            ext = 1 if ax is None else (
                mesh.shape[ax] if isinstance(ax, str)
                else math.prod(mesh.shape[a] for a in ax))
            n *= -(-d // ext)
        total += n
    return total


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_and_adamw_bytes_equal_reference_specs(arch, mesh, fsdp,
                                                     aligned):
    m = make_production_mesh(multi_pod=MESHES[mesh])
    stub = _Stub(m)
    cfg = _ref_cfg(arch, aligned)
    params = _ref_params(arch, aligned)
    want_p = _ref_bytes(params, JS.param_specs(cfg, params, stub, fsdp=fsdp),
                        stub)
    opt = jax.eval_shape(lambda: JOPT.adamw_init(params))
    want_o = sum(_ref_bytes(t, JS.param_specs(cfg, t, stub, fsdp=fsdp), stub)
                 for t in (opt.m, opt.v)) + 4
    model = _port_model(arch, aligned)
    got = DR.reference_bytes(model.cfg, model, TRAIN, m, fsdp=fsdp)
    assert (got["params"], got["opt"]) == (want_p, want_o)
    assert got["argument_size_in_bytes"] == want_p + want_o + got["batch"]
    if not fsdp:
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        assert want_p < whole


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cache_bytes_equal_reference_specs(arch, mesh, aligned):
    m = make_production_mesh(multi_pod=MESHES[mesh])
    stub = _Stub(m)
    cfg = _ref_cfg(arch, aligned)
    model = _port_model(arch, aligned)
    for shape in CACHE_SHAPES:
        _, seq, gbs, _ = shape
        tree = jax.eval_shape(lambda: JLM.init_cache(cfg, gbs, seq))
        spec_for = JS.cache_specs(cfg, stub, batch=gbs, max_len=seq)
        want = _ref_bytes(tree, jax.tree_util.tree_map_with_path(spec_for,
                                                                 tree), stub)
        got = DR.reference_bytes(model.cfg, model, shape, m,
                                 cache=model.init_cache(gbs, seq))
        assert got["cache"] == want, shape


def test_placed_parameters_a_rank():
    """Whole Mixtral-8x7B on a {data: 1, model: 4} mesh holds
    12,879,925,248 parameters a rank (the f slice of every expert); the
    estimate's static bytes are those parameters' bytes.  MiniCPM-2B on
    one card: 3,008,289,024."""
    mesh = Mesh({"data": 1, "model": 4})
    model, _, _ = DR.build(TC.get_config("mixtral_8x7b"), "prefill", 4, 1024,
                           mesh)
    got = DR.placed_bytes(model)
    assert got["params"] == 12_879_925_248

    def f32(m):   # the norms' scales and the routers are f32
        return sum(p.numel() for p in m.parameters()
                   if p.dtype == torch.float32)
    assert got["placed_bytes"] == 2 * 12_879_925_248 + 2 * f32(model)
    model, opt, _ = DR.build(TC.get_config("minicpm_2b"), "train", 8, 2048)
    got = DR.placed_bytes(model, opt)
    assert got["params"] == 3_008_289_024
    assert got["placed_bytes"] == (2 * 3_008_289_024 + 2 * f32(model)
                                   + 8 * 3_008_289_024 + 4)
    assert got["fits_80gb"]
    model, _, cache = DR.build(TC.get_config("rwkv6_7b"), "decode", 4, 1024)
    got = DR.placed_bytes(model, cache=cache)
    d, H = model.cfg.d_model, model.cfg.d_model // 64
    assert got["cache_bytes"] == model.cfg.n_layers * 4 * (
        2 * 2 * d + 4 * H * 64 * 64)


def _inputs(dev, dtype, grad=False):
    rng = np.random.default_rng(0)

    def t(*shape, dt=dtype):
        x = torch.as_tensor(rng.normal(size=shape), dtype=dt).to(dev)
        return x.requires_grad_(grad)
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_attention_has_the_card_paths_shapes(dtype):
    """On ``meta`` the attention wrappers return what the card's path
    returns (the plain versions' shapes and dtypes), launch nothing and
    credit ``work``'s figures."""
    calls = []
    before = ops.launch_counts()
    for dev in ("cpu", "meta"):
        t = _inputs(dev, dtype)
        q, k, v = t(2, 40, 8, 64), t(2, 48, 2, 64), t(2, 48, 2, 64)
        do = t(2, 40, 8, 64)
        with work.listen(lambda *a: calls.append(a)):
            outs = [ops.flash_attention(q, k, v, causal=True,
                                        sliding_window=16, q_offset=8),
                    *ops.flash_attention_lse(q, k[:, :40], v[:, :40])]
            lse = outs[-1]
            outs += ops.flash_attention_bwd(q, k[:, :40], v[:, :40], outs[1],
                                            lse, do)
        calls.append(None)
        if dev == "cpu":
            want = [(o.shape, o.dtype) for o in outs]
        else:
            assert [(o.shape, o.dtype) for o in outs] == want
            assert all(o.is_meta for o in outs)
    assert ops.launch_counts() == before
    meta = calls[calls.index(None) + 1:-1]
    q = torch.empty(2, 40, 8, 64, dtype=dtype, device="meta")
    k = torch.empty(2, 48, 2, 64, dtype=dtype, device="meta")
    f, nb = work.attention_work(q, k, causal=True, window=16, q_offset=8)
    assert meta[0] == ("flash_attention", f, nb, True)
    f, nb = work.attention_work(q, k[:, :40], causal=True, window=0,
                                q_offset=0)
    assert meta[1] == ("flash_attention", f, nb + 4 * 2 * 8 * 40, True)
    assert meta[2] == ("flash_attention_bwd", *work.attention_bwd_work(
        q, k[:, :40], causal=True, window=0), True)


def test_meta_autograd_and_rwkv_have_the_card_paths_shapes():
    """Autograd through the wrappers on ``meta`` (the ``Function``s of the
    card path) and the RWKV-6 wrappers: the plain versions' shapes and
    dtypes, the chunk-start states the card writes."""
    got = {}
    for dev in ("cpu", "meta"):
        t = _inputs(dev, torch.float32, grad=True)
        q, k, v = t(1, 32, 4, 32), t(1, 32, 2, 32), t(1, 32, 2, 32)
        ops.flash_attention(q, k, v).sum().backward()
        r, kk, vv, w = (t(2, 32, 2, 64) for _ in range(4))
        u = t(2, 64)
        s0 = t(2, 2, 64, 64, dt=torch.float32).detach()
        y, sf = ops.rwkv6_chunked(r, kk, vv, w, u, s0, chunk=16)
        (y.sum() + sf.sum()).backward()
        with torch.no_grad():
            y2, sf2, states = ops.rwkv6_chunked_states(r, kk, vv, w, u, s0,
                                                       chunk=16)
            back = ops.rwkv6_chunked_bwd(r, kk, vv, w, u, states, y2, sf2,
                                         chunk=16)
        got[dev] = [(x.shape, x.dtype) for x in (
            q.grad, k.grad, v.grad, y, sf, r.grad, u.grad, y2, sf2, states,
            *back)]
    assert got["meta"] == got["cpu"]


def test_wrappers_refuse_other_devices_and_mixes():
    """The ``meta`` branch does not hide the device: a mix of devices
    raises, and the tick kernels refuse ``meta``."""
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, torch.zeros(1, 4, 2, 32),
                            torch.zeros(1, 4, 2, 32))
    rows = torch.empty(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.flow_agg(rows, torch.empty(3, dtype=torch.int32, device="meta"),
                     n_flows=2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.tick_rank(torch.empty(5, dtype=torch.int32, device="meta"),
                      n_ports=4)
    assert ops._where(q, meta=True) == "meta"
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops._where(q)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def test_full_width_cell_allocates_nothing_on_the_host():
    """A full-width MoE cell (Mixtral-8x7B, prefill_32k on pod16x16: ~93
    GB of weights, a 32 x 32,768 batch, the mesh's collectives) runs on
    ``meta``: its ops make no storage off ``meta`` and the process grows
    by less than 1 GB."""
    DR._whole_step.cache_clear()
    before = _rss()
    rec = DR.estimate(DR.config_of("mixtral_8x7b"),
                      ("prefill_32k", 32768, 32, "prefill"),
                      make_production_mesh())
    grew = _rss() - before
    assert rec["host_bytes"] == 0 and rec["rank_host_bytes"] == 0
    assert grew < 1 << 30, grew
    assert rec["temp_size_in_bytes"] > 100e9
    # 8 experts over 16: the f-split EP path, no aux in a prefill
    assert rec["collectives"]["all-to-all"]["count"] == 32
    assert rec["collectives"]["all-gather"]["count"] == 64
    assert rec["collectives"]["all-reduce"]["count"] == 0


def test_hybrid_train_cell_is_not_ported():
    """The hybrid family trains, so Jamba's train cells carry the step's
    bytes, FLOPs and temp, its mesh pass the backward's collectives too
    (one 8-layer unit at published width, the cell's shapes, on the
    production mesh): the Mamba scan credited twice a Mamba layer (the
    forward and remat's recomputation) and its backward once, attention
    likewise."""
    cfg = dataclasses.replace(DR.config_of("jamba_1_5_large"), n_layers=8)
    rec = DR.estimate(cfg, TRAIN, make_production_mesh())
    assert "not_ported" not in rec
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["temp_size_in_bytes"] > 0 and rec["rank_temp_size_in_bytes"] > 0
    assert rec["argument_size_in_bytes"] > 0 and rec["placed_bytes"] > 80e9
    cred = rec["credited"]
    assert cred["mamba_scan"]["calls"] == 2 * 7
    assert cred["mamba_scan_bwd"]["calls"] == 7
    assert cred["flash_attention"]["calls"] == 2
    assert cred["flash_attention_bwd"]["calls"] == 1
    # the MoE layers' backward: the gradients' all-to-alls back and the
    # router's and expert rows' sums over the ranks that fed them
    coll = rec["collectives"]
    assert coll["all-to-all"]["count"] == 4 * 2 * 3
    assert coll["all-reduce"]["count"] > 0
    TSTEP.make_train_step(TC.get_config("jamba_1_5_large"))


def test_run_cell_writes_a_record(tmp_path):
    rec = DR.run_cell("rwkv6_7b", ("long_500k", 524288, 1, "decode"), True,
                      tmp_path)
    assert rec["status"] == "ok" and rec["ok"]
    assert (tmp_path / "rwkv6_7b__long_500k__pod2x16x16.json").exists()
    assert rec["credited"] == {}     # decode: the per-token recurrence
    assert rec["placed"]["fits_80gb"] and rec["flops"] > 0
    assert os.path.basename(rec["cell"]) == rec["cell"]
