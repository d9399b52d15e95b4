"""Gradients on a mesh: the port's MoE layer and reduced Jamba over 4
``gloo`` processes against the reference's ``jax.grad`` on a forced
4-device host mesh, on the CPU.

The port's mesh gradients are held against the reference's *mesh*
gradients, not its one-device run: the EP paths' ``aux`` is the mean of
the ranks' own load-balance estimates (a ``pmean``), not the global one,
so with a non-zero aux weight the router's and the input's gradients
differ from one device's (the experts' do not).  The reference runs in
one subprocess under a forced 4-device platform with its shard context
set (``set_shard_ctx``), as ``tests/test_torch_moe_ep.py`` sets both
sides up; the port in 4 processes over ``gloo``.  Weights and inputs are
drawn with numpy from fixed seeds.

- MoE layer (f32, aux weight 0.37): the all-to-all at E 8 and the
  f-split at E 6 on (1, 4), each dropless and at capacity factor 1.0;
  one of each on (2, 2) (the expert rows' gradients summed over 'data');
  the decode path (S 3, S % tp != 0) of each split.  ``sum(out r) + 0.37
  aux``'s gradient in x (whole, every rank), the router (every rank) and
  each rank's block of the expert rows within 1e-4 of the reference's
  largest entry; every rank's x and router gradient the same bits.
- Reduced Jamba (8 layers, 4 experts, all-to-all) on (1, 4), 2 x 64
  tokens: the loss and every gradient, remat on and off (the expert rows
  against the reference's slices), within 1e-4 of each tensor's largest
  entry; then one mesh train step (cosine; int8 compression off and
  on): loss, gnorm, lr, the parameters, ``m`` and ``v`` within 1e-4 of
  each tensor's largest, but for ``tests/test_torch_train.py``'s
  near-zero and rounding-boundary elements; every replicated parameter
  (and its gradient) the same bits on every rank.
"""
import hashlib
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from test_torch_moe_ep import (B, D, ROOT, _draw, _moe_cfg,  # noqa: E402
                               _moe_params, _run)
from test_torch_train import _flips, _near_zero  # noqa: E402

W = 4
TOL = 1e-4
AUX = 0.37
# name -> (experts, mesh (data, model), capacity factor; None: dropless,
# sequence length)
MOE_CASES = {
    "a2a8_dropless": (8, (1, 4), None, 16), "a2a8_cf1": (8, (1, 4), 1.0, 16),
    "fshard6_dropless": (6, (1, 4), None, 16),
    "fshard6_cf1": (6, (1, 4), 1.0, 16),
    "a2a8_mesh22_cf1": (8, (2, 2), 1.0, 16),
    "fshard6_mesh22_dropless": (6, (2, 2), None, 16),
    "a2a8_decode": (8, (1, 4), 1.0, 3), "fshard6_decode": (6, (1, 4), 1.0, 3),
}
ARCH = "jamba_1_5_large"
LM_B, LM_S = 2, 64
KW = dict(schedule="cosine", warmup=2, total=20)
COMPRESSION = (False, True)
ROWS = ("w_gate", "w_up", "w_down")

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle
import jax, jax.numpy as jnp, numpy as np
from repro import configs as JC
from repro.models import moe
from repro.models.common import ModelCfg, MoECfg, set_shard_ctx
from repro.train import optim as JOPT
from repro.train import step as JSTEP

d, AUX = sys.argv[1], float(sys.argv[2])
spec = json.load(open(os.path.join(d, "cases.json")))
data = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
np_tree = lambda t: jax.tree.map(np.asarray, t)
res = {}
for name, c in spec["moe"].items():
    cfg = ModelCfg(dtype=jnp.float32, moe=MoECfg(**c["moe"]), **c["cfg"])
    p = jax.tree.map(jnp.asarray, data[name]["params"])
    x, r = jnp.asarray(data[name]["x"]), jnp.asarray(data[name]["r"])
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"))
    set_shard_ctx(dp_axes=("data",), tp_axis="model", mesh=mesh)

    def f(p, x):
        o, a = moe.apply_moe(p, x, cfg)
        return jnp.sum(o * r) + AUX * a
    with mesh:
        loss, (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(p, x)
    set_shard_ctx()
    res[name] = {"loss": float(loss), "gx": np.asarray(gx),
                 "gp": np_tree(gp)}
jcfg = dataclasses.replace(JC.get_reduced(spec["arch"]), dtype=jnp.float32)
params = jax.tree.map(jnp.asarray, data["lm"]["params"])
batch = {k: jnp.asarray(v) for k, v in data["lm"]["batch"].items()}
# Auto axes: the model's sharding hints constrain them
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
set_shard_ctx(dp_axes=("data",), tp_axis="model", mesh=mesh)
with mesh:
    (loss, m), g = jax.jit(jax.value_and_grad(
        JSTEP.make_loss_fn(jcfg, remat=True), has_aux=True))(params, batch)
    res["lm"] = {"loss": float(loss), "aux": float(m["aux"]),
                 "grads": np_tree(g), "steps": {}}
    for comp in spec["compression"]:
        p2, o2, met = jax.jit(JSTEP.make_train_step(jcfg, **spec["kw"]))(
            params, JOPT.adamw_init(params, compression=comp), batch)
        res["lm"]["steps"][comp] = {
            "params": np_tree(p2), "m": np_tree(o2.m), "v": np_tree(o2.v),
            "err": None if o2.err is None else np_tree(o2.err),
            "metrics": {k: float(v) for k, v in met.items()}}
set_shard_ctx()
pickle.dump(res, open(os.path.join(d, "ref.pkl"), "wb"))
"""

_PORT = r"""
import dataclasses, hashlib, os, sys, json, pickle
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs as TC
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models import moe as M
from repro_torch.models.common import ModelCfg, MoECfg
from repro_torch.train import optim as TOPT
from repro_torch.train import step as TSTEP

d, rank, AUX = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "rdv"), world_size=4, rank=rank)
spec = json.load(open(os.path.join(d, "cases.json")))
data = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))
meshes = {}


def mesh_of(shape):
    shape = tuple(shape)
    if shape not in meshes:      # every rank asks in the same order
        meshes[shape] = make_mesh(shape, ("data", "model"), backend="gloo")
    return meshes[shape]


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def keep(tree, sharded):
    # rank 0 keeps every leaf; the others their expert blocks, and a
    # digest of the rest
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if rank == 0 or ("moe" in path and path[-1] in sharded):
            return node
        return digest(node)
    return walk(tree, ())


res = {}
for name, c in spec["moe"].items():
    cfg = ModelCfg(dtype=torch.float32, moe=MoECfg(**c["moe"]), **c["cfg"])
    mesh = mesh_of(c["mesh"])
    m = M.MoE(cfg, device="cpu", mesh=mesh)
    for n, p in m.named_parameters():
        t = torch.from_numpy(data[name]["params"][n])
        p.data.copy_(M.local_rows(cfg, n, t, mesh) if n in M.EXPERT_ROWS
                     else t)
    m.requires_grad_(True)
    x = torch.from_numpy(data[name]["x"]).requires_grad_(True)
    out, aux = m(x, with_aux=True)
    loss = (out * torch.from_numpy(data[name]["r"])).sum() + AUX * aux
    named = dict(m.named_parameters())
    gs = torch.autograd.grad(loss, [x, *named.values()])
    res[name] = {"loss": float(loss), "gx": gs[0].numpy(),
                 "gp": {n: g.numpy() for n, g in zip(named, gs[1:])},
                 "split": m.split}
cfg = dataclasses.replace(TC.get_reduced(spec["arch"]), dtype=torch.float32)
mesh = mesh_of((1, 4))
batch = {k: torch.from_numpy(v) for k, v in data["lm"]["batch"].items()}
model = convert.from_jax_params(cfg, data["lm"]["params"], device="cpu",
                                mesh=mesh)
model.requires_grad_(True)
named = dict(model.named_parameters())
lm = {"sharded": sorted(model.sharded_params()), "grads": {}, "steps": {}}
for remat in (True, False):
    loss, met = TSTEP.make_loss_fn(cfg, remat=remat)(model, batch)
    gs = torch.autograd.grad(loss, list(named.values()))
    lm["grads"][remat] = {
        "loss": float(loss), "aux": float(met["aux"]),
        "tree": keep(convert.to_numpy_tree(model, dict(zip(named, gs))),
                     M.EXPERT_ROWS)}
for comp in spec["compression"]:
    model = convert.from_jax_params(cfg, data["lm"]["params"], device="cpu",
                                    mesh=mesh)
    opt = TOPT.adamw_init(dict(model.named_parameters()), compression=comp)
    model, opt, met = TSTEP.make_train_step(cfg, **spec["kw"])(model, opt,
                                                              batch)
    lm["steps"][comp] = {
        "params": keep(convert.to_numpy_tree(model), M.EXPERT_ROWS),
        "m": keep(convert.to_numpy_tree(model, opt.m), M.EXPERT_ROWS),
        "v": keep(convert.to_numpy_tree(model, opt.v), M.EXPERT_ROWS),
        "err": None if opt.err is None else keep(
            convert.to_numpy_tree(model, opt.err), M.EXPERT_ROWS),
        "metrics": {k: float(v) for k, v in met.items()}}
res["lm"] = lm
pickle.dump(res, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rows_of(leaf, name, E, mesh, rank, stacked=False):
    """Rank ``rank``'s block of the reference's expert weight ``name`` of
    ``E`` experts on ``mesh`` (data, model): whole experts over 'model'
    when it divides E, else an f slice (``moe.expert_dim``); ``stacked``
    leaves carry a leading unit axis."""
    tp = mesh[1]
    dim = 0 if E % tp == 0 else (1 if name == "w_down" else 2)
    dim += int(stacked)
    size = leaf.shape[dim] // tp
    return np.take(leaf, range((rank % tp) * size, (rank % tp + 1) * size),
                   axis=dim)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep_grad")
    spec = {"moe": {}, "arch": ARCH, "kw": KW,
            "compression": list(COMPRESSION)}
    data = {}
    for i, (name, (E, mesh, cf, S)) in enumerate(MOE_CASES.items()):
        c = {**_moe_cfg(E, cf), "mesh": mesh}
        spec["moe"][name] = c
        rng = np.random.default_rng(40 + i)
        data[name] = {"params": _moe_params(c, 40 + i),
                      "x": rng.normal(0, 1, (B, S, D)).astype(np.float32),
                      "r": rng.normal(0, 1, (B, S, D)).astype(np.float32)}
    jcfg = JC.get_reduced(ARCH)
    shapes = jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(50)
    toks = rng.integers(0, jcfg.vocab, (LM_B, LM_S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, 3] = -1
    data["lm"] = {"params": _draw(shapes, 50), "batch": batch}
    (d / "cases.json").write_text(json.dumps(spec))
    (d / "inputs.pkl").write_bytes(pickle.dumps(data))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cmds = [[sys.executable, "-c", _REF, str(d), str(AUX)]] + \
        [[sys.executable, "-c", _PORT, str(d), str(r), str(AUX)]
         for r in range(W)]
    _run(cmds, env, timeout=300)
    ref = pickle.loads((d / "ref.pkl").read_bytes())
    ranks = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
             for r in range(W)]
    return spec, ref, ranks


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_grads_equal_reference_mesh(runs, name):
    """x's, the router's and each rank's expert blocks' gradients against
    the reference's mesh gradients (aux weight 0.37)."""
    _, ref, ranks = runs
    E, mesh, _, _ = MOE_CASES[name]
    want = ref[name]
    for r, got in enumerate(ranks):
        res = got[name]
        assert res["split"] == ("experts" if E % mesh[1] == 0 else "f")
        assert _rel(res["loss"], want["loss"]) <= TOL
        assert _rel(res["gx"], want["gx"]) <= TOL, r
        assert _rel(res["gp"]["router"], want["gp"]["router"]) <= TOL, r
        for n in ROWS:
            w = _rows_of(want["gp"][n], n, E, mesh, r)
            assert res["gp"][n].shape == w.shape, n
            assert _rel(res["gp"][n], w) <= TOL, (r, n, _rel(res["gp"][n], w))


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_replicated_grads_agree_across_ranks(runs, name):
    """Every rank ends the backward with the same bits of x's and the
    router's gradients, and the ranks that share a 'model' coordinate
    with the same expert blocks' gradients."""
    _, _, ranks = runs
    _, mesh, _, _ = MOE_CASES[name]
    first = ranks[0][name]
    for r, got in enumerate(ranks):
        res = got[name]
        np.testing.assert_array_equal(res["gx"], first["gx"])
        np.testing.assert_array_equal(res["gp"]["router"],
                                      first["gp"]["router"])
        twin = ranks[r % mesh[1]][name]          # data coordinate 0
        for n in ROWS:
            np.testing.assert_array_equal(res["gp"][n], twin["gp"][n])


def _walk(got, want, fn, path=()):
    """``fn(path, got_leaf, want_leaf)`` over the reference tree's leaves;
    stacked block leaves are [units, ...]."""
    if isinstance(want, dict):
        for k in want:
            _walk(got[k], want[k], fn, path + (k,))
    elif isinstance(want, list):
        for i, (a, b) in enumerate(zip(got, want)):
            _walk(a, b, fn, path + (i,))
    else:
        fn(path, got, np.asarray(want))


def _lm_check(ranks, want_tree, get, skip=None):
    """Each rank's tree ``get(rank)`` against the reference's, expert rows
    against the rank's slices; the replicated leaves of every rank equal
    rank 0's bits (the others hold their digests)."""
    E = JC.get_reduced(ARCH).moe.n_experts
    mask = {}
    if skip is not None:
        _walk(skip, skip, lambda p, a, b: mask.__setitem__(p, a))

    def one(rank):
        def fn(path, got, want):
            stacked = path[0] == "blocks"
            if _expert(path):
                want = _rows_of(want, path[-1], E, (1, W), rank, stacked)
                m = mask.get(path)
                if m is not None:
                    m = _rows_of(m, path[-1], E, (1, W), rank, stacked)
            elif rank != 0:
                ref0 = _leaf(get(0), path)
                assert got == _digest(ref0), (rank, path)
                return
            else:
                m = mask.get(path)
            diff = np.abs(np.asarray(got, np.float64) - want)
            if m is not None:
                diff = np.where(m, 0, diff)
            err = float(diff.max() / max(np.abs(want).max(), 1e-30))
            assert err <= TOL, (rank, path, err)
        _walk(get(rank), want_tree, fn)
    for r in range(W):
        one(r)


def _expert(path) -> bool:
    """Whether the leaf at ``path`` is an MoE layer's expert rows."""
    return "moe" in path and path[-1] in ROWS


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _joined(get):
    """Rank 0's tree ``get(0)``, each expert leaf the ranks' blocks joined
    (whole experts over 'model': axis 1 of the stacked leaf)."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path + (i,)) for i, v in enumerate(node)]
        if _expert(path):
            return np.concatenate([_leaf(get(r), path) for r in range(W)],
                                  axis=1)
        return node
    return build(get(0), ())


@pytest.mark.parametrize("remat", [True, False])
def test_jamba_loss_and_grads_equal_reference_mesh(runs, remat):
    """Reduced Jamba on (1, 4): the loss, the aux and every gradient; the
    expert rows against the reference's slices, every other gradient the
    same bits on every rank."""
    _, ref, ranks = runs
    want = ref["lm"]
    for got in ranks:
        g = got["lm"]["grads"][remat]
        assert abs(g["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert abs(g["aux"] - want["aux"]) <= TOL * abs(want["aux"])
        assert want["aux"] > 0
    assert ranks[0]["lm"]["sharded"] == sorted(
        f"blocks.{i}.moe.{n}" for i in range(1, 8, 2) for n in ROWS)
    _lm_check(ranks, want["grads"],
              lambda r: ranks[r]["lm"]["grads"][remat]["tree"])


@pytest.mark.parametrize("compression", COMPRESSION)
def test_jamba_train_step_equals_reference_mesh(runs, compression):
    """One train step on the mesh from the same weights and batch:
    metrics, the parameters, ``m`` and ``v`` (and the int8 error
    buffers) within 1e-4 of each tensor's largest entry, but for the
    near-zero and rounding-boundary elements (at most 1 in 1,000); the
    replicated parameters and moments the same bits on every rank."""
    _, ref, ranks = runs
    want = ref["lm"]["steps"][compression]
    for got in ranks:
        mine = got["lm"]["steps"][compression]["metrics"]
        for k in ("loss", "gnorm", "lr"):
            assert _rel(mine[k], want["metrics"][k]) <= TOL, k
    skip = _near_zero(ref["lm"]["grads"])
    if compression:
        err = _joined(lambda r: ranks[r]["lm"]["steps"][compression]["err"])
        skip = jax.tree.map(np.logical_or, skip, _flips(err, want["err"]))
    n = sum(int(s.sum()) for s in jax.tree.leaves(skip))
    assert n <= sum(s.size for s in jax.tree.leaves(skip)) / 1000
    for key in ("params", "m", "v"):
        _lm_check(ranks, want[key],
                  lambda r: ranks[r]["lm"]["steps"][compression][key], skip)
