"""du of the RWKV-6 backward kernel against an f64 sum, on the card.

Replays the first step of ``tests/test_torch_cuda.py::
test_train_step_on_card_equals_cpu`` for the reduced ``rwkv6_7b`` in f32
(weights from seed 0, tokens from numpy seed 4, microbatch 0): the
loss's gradient on the CPU (autograd through the plain forward) and on
the card (the kernels).  Each layer's ``ops.rwkv6_chunked_bwd`` inputs
on the card are kept, and the gradient of ``u`` there is compared with
``du = sum_{b,t} (dy_t . v_t) r_t k_t`` summed in f64 over the same
inputs: the kernel's, the plain backward's on those inputs, the card's
autograd result and the CPU's (whose own inputs differ by the upstream
f32 rounding).  ``--parent-src`` builds another revision's
``rwkv6_chunked_bwd.cu`` (same C interface) and adds its du.  Needs a
card:

    PYTHONPATH=src python tools/rwkv_du_against_f64.py [--parent-src F]

Also printed: for each layer, the element of u with the smallest
``|g| / eps`` above the test's near-zero mask (``|g| <= 1e-5 max|g|``),
where AdamW's ``g / (|g| + eps)`` turns a gradient gap into the largest
parameter gap.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import subprocess
import sys

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.kernels import _build, ops, ref
from repro_torch.models.lm import LM
from repro_torch.train import step as STEP

EPS = 1e-8          # AdamW's eps (repro_torch.train.optim.adamw_update)


def build_other(src: str):
    """The launch function of ``src`` compiled with the port's flags."""
    lib = _build.BUILD_ROOT / "parent_rwkv6_chunked_bwd.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          src], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(lib)).rwkv6_chunked_bwd_launch
    fn.argtypes = _build.library("rwkv6_chunked_bwd").argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", help="another rwkv6_chunked_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rwkv_du_against_f64: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.device("cuda")
    kernel = _build.library("rwkv6_chunked_bwd")
    other = build_other(args.parent_src) if args.parent_src else None

    inputs = []
    wrapper = ops.rwkv6_chunked_bwd

    def keep(*a, **kw):
        inputs.append((a, kw))
        return wrapper(*a, **kw)
    ops.rwkv6_chunked_bwd = keep

    cfg = dataclasses.replace(C.get_reduced("rwkv6_7b"), dtype=torch.float32)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    cpu.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = STEP.make_loss_fn(cfg)
    names = [n for n, _ in cpu.named_parameters()]
    g_cpu = dict(zip(names, torch.autograd.grad(
        loss_fn(cpu, batch)[0], list(cpu.parameters()))))
    gpu = copy.deepcopy(cpu).to(card)
    g_card = dict(zip(names, torch.autograd.grad(
        loss_fn(gpu, {k: v.to(card) for k, v in batch.items()})[0],
        list(gpu.parameters()))))
    ops.rwkv6_chunked_bwd = wrapper

    print(torch.cuda.get_device_name(0))
    # autograd runs the layers last to first
    for layer, (a, kw) in zip(reversed(range(len(inputs))), inputs):
        r, k, v, w, u, states, dy, dwkv = a
        d = [t.detach().cpu().double() for t in (r, k, v, dy)]
        f64 = ((d[3] * d[2]).sum(-1, keepdim=True) * d[0] * d[1]).sum(
            (0, 1)).reshape(-1)
        name = f"blocks.{layer}.tmix.u"
        rows = {"kernel": wrapper(*a, **kw)[4],
                "plain on the card's inputs":
                    ref.rwkv6_chunked_backward_reference(
                        *[t.cpu() for t in (r, k, v, w, u, states, dy)],
                        None if dwkv is None else dwkv.cpu(), **kw)[4],
                "card autograd": g_card[name], "CPU autograd": g_cpu[name]}
        if other is not None:
            _build._FUNCS["rwkv6_chunked_bwd"] = other
            rows["--parent-src kernel"] = wrapper(*a, **kw)[4]
            _build._FUNCS["rwkv6_chunked_bwd"] = kernel
        g = g_cpu[name].double().reshape(-1)
        live = g.abs() > 1e-5 * g.abs().max()
        i = int(torch.where(live, g.abs(), torch.inf).argmin())
        print(f"{name}: max |du| {float(f64.abs().max()):.4e}; element {i}: "
              f"f64 {float(f64[i]):.6e}, |g| / eps {float(g[i].abs()) / EPS:.1f}")
        for label, x in rows.items():
            x = x.detach().cpu().double().reshape(-1)
            e = (x - f64).abs()
            print(f"  {label}: max |du - f64| {float(e.max()):.3e}, mean "
                  f"{float(e.mean()):.3e}; element {i} {float(x[i]):.6e}")


if __name__ == "__main__":
    main()
