"""MoE expert parallelism in the port (``repro_torch.models.moe`` on a
``repro_torch.launch.mesh`` mesh) against the reference's ``shard_map``
paths, on the CPU.

The reference runs in one subprocess under a forced 4-device host
platform (as ``tests/test_moe_ep.py`` does); the port runs in 4
processes over ``gloo``, started once for the file.  Both take the same
weights, in the reference's layout (``init_moe`` / ``lm.init_params``
shapes) and carried into the port by ``convert``, and the same inputs,
all drawn with numpy from fixed seeds.

- all-to-all at E 8 and 16 and f-sharded at E 6 on a (1, 4) mesh, and
  one case each on a (2, 2) mesh; each dropless and at capacity factor
  1.0 (where tokens are dropped): every rank's kept set and ``dst``
  equal the reference's per-device dispatch, the output within 1e-5 and
  ``aux`` within 1e-6 of the reference's EP (f32);
- the same in bf16 (an all-to-all and an f-sharded case), with expert
  weights under which every expert row is exact in bf16: the EP paths
  combine in f32, as the reference's do, so at most ``BF16_DIFFER`` of
  the bf16 outputs differ from the reference's, each by at most one ulp
  of the largest; a combine in bf16 (gates cast to bf16) changes 7% and
  27% of them;
- ``S % tp != 0`` (decode): the mesh layer equals the one-process dense
  layer and the reference's ``_apply_moe_dense``;
- the plain per-rank oracle (``moe.ep_oracle``) equals the reference's
  EP;
- an MoE ``LM`` on the mesh (``convert.from_jax_params(mesh=)``), its
  prefill and decode logits against the reference's ``lm.forward`` /
  ``decode_step`` (dropless); every rank the same logits.

The gradients on the mesh are ``tests/test_torch_moe_ep_grad.py``'s.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import lm as JLM  # noqa: E402
from repro.models.common import ModelCfg, MoECfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
W = 4
TOL_OUT, TOL_AUX = 1e-5, 1e-6
B, S, D, F, K = 2, 16, 32, 16, 2
# name -> (experts, mesh (data, model), capacity factor; None: dropless)
MOE_CASES = {
    "a2a8_dropless": (8, (1, 4), None), "a2a8_cf1": (8, (1, 4), 1.0),
    "a2a16_dropless": (16, (1, 4), None), "a2a16_cf1": (16, (1, 4), 1.0),
    "fshard6_dropless": (6, (1, 4), None), "fshard6_cf1": (6, (1, 4), 1.0),
    "a2a8_mesh22_cf1": (8, (2, 2), 1.0),
    "fshard6_mesh22_cf1": (6, (2, 2), 1.0),
}
# bf16 activations and expert weights (router f32), on (1, 4)
BF16_CASES = {"a2a8_bf16_cf1": (8, (1, 4), 1.0),
              "fshard6_bf16_dropless": (6, (1, 4), None)}
BF16_DIFFER = 0.01
DECODE_CASES = {"a2a8_decode": 8, "fshard6_decode": 6}     # S = 3
LM_CASES = {"lm_a2a8": 8, "lm_fshard6": 6}
LM_S, LM_DECODE = 8, 3

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.models import lm, moe
from repro.models.common import ModelCfg, MoECfg, set_shard_ctx

d = sys.argv[1]
spec = json.load(open(os.path.join(d, "cases.json")))
data = pickle.load(open(os.path.join(d, "inputs.pkl"), "rb"))


def cfg_of(c, **kw):
    return ModelCfg(dtype=jnp.dtype(c.get("dtype", "float32")),
                    moe=MoECfg(**c["moe"]), **c["cfg"], **kw)


res = {}
for name, c in spec["moe"].items():
    cfg = cfg_of(c)
    me = cfg.moe
    p = {k: jnp.asarray(v, jnp.float32 if k == "router" else cfg.dtype)
         for k, v in data[name]["params"].items()}
    x = jnp.asarray(data[name]["x"], cfg.dtype)
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"))
    set_shard_ctx(dp_axes=("data",), tp_axis="model", mesh=mesh)
    with mesh:
        o, a = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg))(p, x)
    set_shard_ctx()
    r = {"out": np.asarray(o, np.float32), "aux": float(a), "dst": [],
         "keep": []}
    nd, nm = c["mesh"]
    Bx, Sx, dm = x.shape
    b, s = Bx // nd, Sx // nm
    for i in range(nd):
        for j in range(nm):
            blk = x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(-1, dm)
            probs = jax.nn.softmax(blk @ p["router"], -1)
            cap = int(max(1, me.capacity_factor * me.top_k * blk.shape[0]
                          / me.n_experts))
            _, dst, keep, _, _ = moe._local_dispatch(blk, probs, me.top_k,
                                                     cap, me.n_experts)
            r["dst"].append(np.asarray(dst))
            r["keep"].append(np.asarray(keep))
    res[name] = r
for name, c in spec["decode"].items():
    cfg = cfg_of(c)
    p = jax.tree.map(jnp.asarray, data[name]["params"])
    o, a = moe._apply_moe_dense(p, jnp.asarray(data[name]["x"]), cfg)
    res[name] = {"out": np.asarray(o), "aux": float(a)}
for name, c in spec["lm"].items():
    cfg = cfg_of(c)
    p = jax.tree.map(jnp.asarray, data[name]["params"])
    toks = jnp.asarray(data[name]["tokens"], jnp.int32)
    logits, _ = jax.jit(lambda p, t: lm.forward(p, cfg, t, remat=False))(
        p, toks)
    cache = lm.init_cache(cfg, toks.shape[0], c["decode"])
    step = jax.jit(lambda p, t, cache: lm.decode_step(p, cfg, t, cache))
    steps = []
    for i in range(c["decode"]):
        lg, cache = step(p, toks[:, i:i + 1], cache)
        steps.append(np.asarray(lg))
    res[name] = {"logits": np.asarray(logits), "decode": np.stack(steps)}
pickle.dump(res, open(os.path.join(d, "ref.pkl"), "wb"))
"""

_PORT = r"""
import os, sys, json, pickle
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models import moe as M
from repro_torch.models.common import ModelCfg, MoECfg

d, rank = sys.argv[1], int(sys.argv[2])
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


def cfg_of(c, **kw):
    return ModelCfg(dtype=getattr(torch, c.get("dtype", "float32")),
                    moe=MoECfg(**c["moe"]), **c["cfg"], **kw)


def layer(cfg, params, mesh=None):
    m = M.MoE(cfg, device="cpu", mesh=mesh)
    for n, p in m.named_parameters():
        t = torch.from_numpy(params[n])
        if n in M.EXPERT_ROWS and mesh is not None:
            t = M.local_rows(cfg, n, t, mesh)
        p.data.copy_(t)
    return m


res = {}
with torch.no_grad():
    for name, c in spec["moe"].items():
        cfg, mesh = cfg_of(c), mesh_of(c["mesh"])
        me = cfg.moe
        x = torch.from_numpy(data[name]["x"]).to(cfg.dtype)
        m = layer(cfg, data[name]["params"], mesh)
        out, aux = m(x, with_aux=True)
        out = out.float()
        xt = M.rank_tokens(x, mesh)
        cap = M.capacity(me.capacity_factor, me.top_k, xt.shape[0],
                         me.n_experts)
        _, dst, keep, *_ = M.local_dispatch(xt, M.route(xt, m.router),
                                            me.top_k, cap, me.n_experts)
        r = {"out": out.numpy(), "aux": float(aux), "dst": dst.numpy(),
             "keep": keep.numpy(), "split": m.split,
             "rows": tuple(m.w_gate.shape)}
        if rank == 0:
            o, a = M.ep_oracle(layer(cfg, data[name]["params"]), x,
                               *c["mesh"])
            r["oracle"], r["oracle_aux"] = o.float().numpy(), float(a)
        res[name] = r
    for name, c in spec["decode"].items():
        cfg, mesh = cfg_of(c), mesh_of((1, 4))
        x = torch.from_numpy(data[name]["x"])
        out, aux = layer(cfg, data[name]["params"], mesh)(x, with_aux=True)
        one, one_aux = layer(cfg, data[name]["params"])(x, with_aux=True)
        res[name] = {"out": out.numpy(), "aux": float(aux),
                     "one": one.numpy(), "one_aux": float(one_aux)}
    for name, c in spec["lm"].items():
        cfg, mesh = cfg_of(c), mesh_of((1, 4))
        model = convert.from_jax_params(cfg, data[name]["params"],
                                        device="cpu", mesh=mesh)
        toks = torch.from_numpy(data[name]["tokens"])
        logits = model(toks)
        cache = model.init_cache(toks.shape[0], c["decode"])
        steps = []
        for i in range(c["decode"]):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache)
            steps.append(lg.numpy())
        res[name] = {"logits": logits.numpy(), "decode": np.stack(steps),
                     "rows": tuple(model.blocks[0].moe.w_gate.shape)}
pickle.dump(res, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _moe_cfg(E, cf, dtype="float32"):
    return {"dtype": dtype,
            "cfg": dict(name="t", family="moe", n_layers=2, d_model=D,
                        n_heads=4, n_kv=2, d_ff=64, vocab=128, d_head=8),
            "moe": dict(n_experts=E, top_k=K, d_ff_expert=F,
                        capacity_factor=float(E) if cf is None else cf)}


def _jcfg(c, **kw):
    return ModelCfg(dtype=jnp.float32, moe=MoECfg(**c["moe"]), **c["cfg"],
                    **kw)


def _draw(tree, seed):
    """A tree of the reference's layout (``jax.eval_shape`` leaves) filled
    from a numpy seed: norms 1, every other leaf normal / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(a.shape, np.float32)
        fan_in = a.shape[-2] if len(a.shape) > 1 else a.shape[-1]
        return (rng.normal(0, 1, a.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _moe_params(c, seed):
    """The layer's weights; a bf16 case's experts from
    :func:`_exact_experts`."""
    me = c["moe"]
    E, f = me["n_experts"], me["d_ff_expert"]
    shapes = {"router": (D, E), "w_gate": (E, D, f), "w_up": (E, D, f),
              "w_down": (E, f, D)}
    p = _draw({k: jax.ShapeDtypeStruct(v, jnp.float32)
               for k, v in shapes.items()}, seed)
    if c["dtype"] == "bfloat16":
        p.update(_exact_experts(E, f, seed))
    return p


def _exact_experts(E, f, seed):
    """Expert weights under which, for inputs of 1 or 2, every expert's
    output is exact in bf16 whatever the backend's rounding of ``silu``
    or order of summation: each hidden unit reads one input for ``g``, an
    integer from 20 to 80 (so ``silu(g) == g`` in f32 and bf16), and one
    for ``u`` (+-1 or +-2); each output unit reads one hidden unit, times
    +-2**k (an f slice that does not hold it adds exact zeros).  So the
    reference and the port hold the same expert rows, and their bf16
    outputs differ only by how each combines them with its f32 gates."""
    rng = np.random.default_rng(seed)
    wg, wu = np.zeros((2, E, D, f), np.float32)
    wd = np.zeros((E, f, D), np.float32)
    for e in range(E):
        wg[e, rng.integers(0, D, f), np.arange(f)] = \
            rng.integers(20, 41, f)
        wu[e, rng.integers(0, D, f), np.arange(f)] = rng.choice([-1, 1], f)
        wd[e, rng.integers(0, f, D), np.arange(D)] = \
            rng.choice([-1, 1], D) * 2.0 ** rng.integers(-2, 3, D)
    return {"w_gate": wg, "w_up": wu, "w_down": wd}


def _run(cmds, env, timeout):
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    spec = {"moe": {}, "decode": {}, "lm": {}}
    data = {}
    cases = [(n, c, "float32") for n, c in MOE_CASES.items()] + \
        [(n, c, "bfloat16") for n, c in BF16_CASES.items()]
    for i, (name, (E, mesh, cf), dtype) in enumerate(cases):
        spec["moe"][name] = {**_moe_cfg(E, cf, dtype), "mesh": mesh}
        rng = np.random.default_rng(i)
        x = (rng.integers(1, 3, (B, S, D)) if dtype == "bfloat16"
             else rng.normal(0, 1, (B, S, D))).astype(np.float32)
        data[name] = {"params": _moe_params(spec["moe"][name], i), "x": x}
    for i, (name, E) in enumerate(DECODE_CASES.items()):
        spec["decode"][name] = _moe_cfg(E, 1.0)
        data[name] = {"params": _moe_params(spec["decode"][name], 20 + i),
                      "x": np.random.default_rng(
            20 + i).normal(0, 1, (4, 3, D)).astype(np.float32)}
    for i, (name, E) in enumerate(LM_CASES.items()):
        spec["lm"][name] = {**_moe_cfg(E, None), "decode": LM_DECODE}
        shapes = jax.eval_shape(lambda: JLM.init_params(
            jax.random.PRNGKey(0), _jcfg(spec["lm"][name])))
        data[name] = {"params": _draw(shapes, 30 + i),
                      "tokens": np.random.default_rng(30 + i).integers(
                          0, 128, (2, LM_S))}
    (d / "cases.json").write_text(json.dumps(spec))
    (d / "inputs.pkl").write_bytes(pickle.dumps(data))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cmds = [[sys.executable, "-c", _REF, str(d)]] + \
        [[sys.executable, "-c", _PORT, str(d), str(r)] for r in range(W)]
    _run(cmds, env, timeout=240)
    ref = pickle.loads((d / "ref.pkl").read_bytes())
    ranks = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
             for r in range(W)]
    return spec, ref, ranks


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_ep_equals_reference(runs, name):
    spec, ref, ranks = runs
    E, _, cf = MOE_CASES[name]
    want = ref[name]
    for r, got in enumerate(ranks):
        res = got[name]
        assert res["split"] == ("experts" if E % spec["moe"][name]["mesh"][1]
                                == 0 else "f")
        np.testing.assert_array_equal(res["keep"], want["keep"][r])
        np.testing.assert_array_equal(res["dst"], want["dst"][r])
        np.testing.assert_allclose(res["out"], want["out"], rtol=TOL_OUT,
                                   atol=TOL_OUT)
        assert abs(res["aux"] - want["aux"]) <= TOL_AUX
        np.testing.assert_array_equal(res["out"], ranks[0][name]["out"])
    kept = np.concatenate([k for k in want["keep"]])
    assert kept.all() == (cf is None), "capacity 1.0 must drop tokens"
    n = spec["moe"][name]["mesh"][1]
    rows = ranks[0][name]["rows"]
    assert rows == ((E // n, D, F) if E % n == 0 else (E, D, F // n))


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_ep_bf16_equals_reference(runs, name):
    """bf16: the same kept sets, and the outputs (and the per-rank
    oracle's) the reference's but for at most ``BF16_DIFFER`` of them,
    each within one bf16 ulp of the largest entry.  The expert rows are
    exact (``_exact_experts``), so only the combine can differ: the
    reference's EP combines in f32 (its gates are f32, the rows bf16),
    and a port that cast the gates to bf16 first exceeds the share."""
    _, ref, ranks = runs
    want = ref[name]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want["out"]).max())) - 7)

    def close(got):
        diff = np.abs(got - want["out"])
        assert diff.max() <= ulp, (diff.max(), ulp)
        assert np.mean(diff > 0) <= BF16_DIFFER, np.mean(diff > 0)
    for r, got in enumerate(ranks):
        res = got[name]
        np.testing.assert_array_equal(res["keep"], want["keep"][r])
        np.testing.assert_array_equal(res["dst"], want["dst"][r])
        close(res["out"])
        assert abs(res["aux"] - want["aux"]) <= TOL_AUX
        np.testing.assert_array_equal(res["out"], ranks[0][name]["out"])
    close(ranks[0][name]["oracle"])


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_per_rank_oracle_equals_reference(runs, name):
    _, ref, ranks = runs
    np.testing.assert_allclose(ranks[0][name]["oracle"], ref[name]["out"],
                               rtol=TOL_OUT, atol=TOL_OUT)
    assert abs(ranks[0][name]["oracle_aux"] - ref[name]["aux"]) <= TOL_AUX


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_path_equals_dense(runs, name):
    """S = 3 does not split over 4 ranks: every rank dispatches every
    token, computes its experts or its f slice, and the layer equals the
    one-process layer and the reference's dense path."""
    _, ref, ranks = runs
    for got in ranks:
        res = got[name]
        np.testing.assert_allclose(res["out"], res["one"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res["out"], ref[name]["out"],
                                   rtol=TOL_OUT, atol=TOL_OUT)
        assert res["aux"] == res["one_aux"]
        assert abs(res["aux"] - ref[name]["aux"]) <= TOL_AUX
        np.testing.assert_array_equal(res["out"], ranks[0][name]["out"])
    if name.startswith("a2a"):        # whole experts: gathered, not summed
        np.testing.assert_array_equal(ranks[0][name]["out"],
                                      ranks[0][name]["one"])


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_on_mesh_equals_reference(runs, name):
    _, ref, ranks = runs
    E = LM_CASES[name]
    for got in ranks:
        res = got[name]
        assert res["rows"] == ((E // W, D, F) if E % W == 0
                               else (E, D, F // W))
        np.testing.assert_allclose(res["logits"], ref[name]["logits"],
                                   rtol=TOL_OUT, atol=TOL_OUT)
        np.testing.assert_allclose(res["decode"], ref[name]["decode"],
                                   rtol=TOL_OUT, atol=TOL_OUT)
        np.testing.assert_array_equal(res["logits"],
                                      ranks[0][name]["logits"])
        np.testing.assert_array_equal(res["decode"],
                                      ranks[0][name]["decode"])


def test_lm_on_mesh_draws_the_one_card_model():
    """``LM(cfg, mesh=..., generator=g)`` keeps each expert's rank block
    of the weights the one-card ``LM`` draws from the same seed, and every
    other parameter whole (a one-rank stand-in mesh: coordinates only)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm as TLM
    from repro_torch.models.common import ModelCfg as TCfg
    from repro_torch.models.common import MoECfg as TMoE
    for E, split in ((8, "experts"), (6, "f")):
        cfg = TCfg(dtype=torch.float32,
                   moe=TMoE(**_moe_cfg(E, None)["moe"]),
                   **_moe_cfg(E, None)["cfg"])
        one = TLM.LM(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
        for m in range(W):
            mesh = Mesh({"data": 1, "model": W}, {"data": 0, "model": m},
                        {"data": None, "model": None}, torch.device("cpu"))
            part = TLM.LM(cfg, mesh=mesh,
                          generator=torch.Generator().manual_seed(3))
            assert part.device.type == "cpu"
            own = dict(one.named_parameters())
            for n, p in part.named_parameters():
                want = own[n]
                leaf = n.rsplit(".", 1)[-1]
                if ".moe." in n and leaf in ("w_gate", "w_up", "w_down"):
                    assert part.blocks[0].moe.split == split
                    dim = 0 if split == "experts" else (
                        1 if leaf == "w_down" else 2)
                    size = want.shape[dim] // W
                    want = want.narrow(dim, m * size, size)
                assert torch.equal(p, want), n
