"""The dry run's collectives against the bytes the collectives move when
the MoE layer really runs on a mesh, on the CPU.

The port runs in 4 processes over ``gloo`` (rendezvous ``file://`` under
the test's tmp_path), each wrapping ``torch.distributed``'s calls to sum
the bytes they write (every call's output, as the reference's
``hlo_collective_bytes`` sums them) and count them by kind.  The dry run
counts the same layer on the ``meta`` device, on a mesh of the same
shape that holds only its sizes (``dryrun.mesh_of``), from the call
shapes (``cost_analysis.analyze``).  Reduced MoE layers: the all-to-all
path (E 8) and the f-split path (E 6) on (1, 4), the all-to-all path on
(2, 2) (``aux`` averaged over both axes), the decode path (S 3) of each
split, and a reduced Mixtral ``LM``'s prefill on (1, 4); then a forward
and backward of the all-to-all and f-split paths on (1, 4), of the
all-to-all path on (2, 2) and of the f-split decode path, whose
gradients add collectives of their own.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import cost_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
W = 4
# name -> (experts, mesh (data, model), x shape or None for the LM)
CASES = {"a2a": (8, (1, 4), (2, 16)), "fshard": (6, (1, 4), (2, 16)),
         "a2a_mesh22": (8, (2, 2), (2, 16)),
         "a2a_decode": (8, (1, 4), (4, 3)),
         "fshard_decode": (6, (1, 4), (4, 3)),
         "lm_prefill": (4, (1, 4), None),
         # a forward and backward of out.sum() + aux: the backward's
         # collectives too
         "a2a_grad": (8, (1, 4), (2, 16)),
         "fshard_grad": (6, (1, 4), (2, 16)),
         "a2a_mesh22_grad": (8, (2, 2), (2, 16)),
         "fshard_decode_grad": (6, (1, 4), (4, 3))}
LM_TOKENS = (2, 8)


def step(m, x, grad: bool):
    """The MoE layer's forward on x and, with ``grad``, the gradient of
    ``out.sum() + aux`` in x and every parameter."""
    if grad:
        m.requires_grad_(True)
        x = x.requires_grad_(True)
    out, aux = m(x, with_aux=True)
    if grad:
        torch.autograd.grad(out.sum() + aux, [x, *m.parameters()])


def cfg_of(E):
    cfg = TC.get_reduced("mixtral_8x7b")
    return dataclasses.replace(cfg, dtype=torch.float32,
                               moe=dataclasses.replace(cfg.moe, n_experts=E))


_RANK = r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_dryrun_ep import CASES, LM_TOKENS, cfg_of
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import LM
from repro_torch.models.moe import MoE
from test_torch_dryrun_ep import step

d, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "rdv"), world_size=4, rank=rank)
moved = {}


def wrap(name, kind, out_arg):
    orig = getattr(dist, name)

    def f(*a, **kw):
        t = a[out_arg]
        moved[kind] = [x + y for x, y in zip(moved.get(kind, [0, 0]),
                                              (t.numel() * t.element_size(),
                                               1))]
        return orig(*a, **kw)
    setattr(dist, name, f)


wrap("all_to_all_single", "all-to-all", 0)
wrap("all_gather_into_tensor", "all-gather", 0)
if hasattr(dist, "all_gather_single"):
    wrap("all_gather_single", "all-gather", 0)
wrap("all_reduce", "all-reduce", 0)
meshes, out = {}, {}
for name, (E, shape, xs) in CASES.items():
    if shape not in meshes:       # every rank asks in the same order
        meshes[shape] = make_mesh(shape, ("data", "model"), backend="gloo")
    mesh = meshes[shape]
    gen = torch.Generator().manual_seed(0)
    cfg = cfg_of(E)
    moved.clear()
    grad = name.endswith("_grad")
    with torch.set_grad_enabled(grad):
        if xs is None:
            m = LM(cfg, device="cpu", generator=gen, mesh=mesh)
            m(torch.zeros(LM_TOKENS, dtype=torch.long), with_aux=True)
        else:
            m = MoE(cfg, device="cpu", generator=gen, mesh=mesh)
            x = torch.randn((*xs, cfg.d_model), generator=gen)
            step(m, x, grad)
    out[name] = dict(moved)
with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ep")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(d), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(W)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(W)]


@pytest.mark.parametrize("name", list(CASES))
def test_collective_bytes_from_call_shapes_equal_gloo(moved, name):
    E, shape, xs = CASES[name]
    mesh = DR.mesh_of({"data": shape[0], "model": shape[1]})
    cfg = cfg_of(E)
    if xs is None:
        m = LM(cfg, device="meta", mesh=mesh)
        x = torch.zeros(LM_TOKENS, dtype=torch.long, device="meta")
    else:
        m = MoE(cfg, device="meta", mesh=mesh)
        x = torch.empty((*xs, cfg.d_model), device="meta")
    grad = name.endswith("_grad")
    with torch.set_grad_enabled(grad):
        cost = (CA.analyze(step, m, x, grad, world=W) if xs is not None
                else CA.analyze(m, x, with_aux=True, world=W))
    want = {k: [cost["collective_bytes"][k], cost["collective_counts"][k]]
            for k in CA.COLLECTIVE_OPS if cost["collective_counts"][k]}
    assert want
    for r in range(W):
        assert moved[r][name] == want, (r, moved[r][name], want)
    assert cost["collective_bytes_total"] == sum(b for b, _ in want.values())
    rows = CA.attribute_collectives(cost, top=None)
    assert sum(r["bytes"] for r in rows) == cost["collective_bytes_total"]
