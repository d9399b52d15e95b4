#!/usr/bin/env python3
"""Where Mixtral-8x7B's prefill on a (1, 4) mesh parts from the same
seed's one-card model, layer by layer, over NCCL on four cards (one
spawned rank a card).

    python3 tools/ep_divergence.py

Both models run ``chip_smoke.EP_PLAN["cut"]``'s Mixtral (4 of 32 layers,
bf16, full width) on the same 4 x 1,024 tokens, dropless, under two
combine rules: ``bf16`` (every MoE layer casts its gates to bf16, the
dense path's rule, forced on the mesh too) and ``f32`` (every layer
combines in f32, the EP paths' rule, ``chip_smoke.combine_in_f32`` on
the one-card side).  For each MoE layer rank 0 prints how far apart the
two models' inputs and outputs are, how far the mesh layer's output is
from the one-card layer fed the mesh layer's own input, and in how many
outputs those two differ; then the logits' largest difference.  Run from
the repo root with ``src`` on the path, after the kernels are built.
"""
from __future__ import annotations

import dataclasses
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def rank_main(rank: int, world: int, init: str) -> None:
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=init, world_size=world,
                            rank=rank, device_id=torch.device("cuda", rank))
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.lm import LM
    mesh = make_mesh((1, world), ("data", "model"), backend="nccl")
    dev = mesh.device
    p = cs.EP_PLAN["cut"]
    cfg = dataclasses.replace(C.get_config(p["arch"]), n_layers=p["layers"])
    models = [LM(cfg, mesh=mesh,
                 generator=torch.Generator(device=dev).manual_seed(0)),
              LM(cfg, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(0))]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (p["B"], p["S"])), device=dev)
    for m in models:
        cs.with_capacity(m, float(cfg.moe.n_experts))
    combine = M._combine

    def run(rule: str) -> None:
        if rule == "bf16":
            M._combine = lambda ye, dst, keep, gate, k, f32=False: \
                combine(ye, dst, keep, gate, k, False)
        else:
            cs.combine_in_f32(models[1], True)
        seen = [[], []]
        hooks = [m.register_forward_hook(
            lambda mod, inp, out, i=i: seen[i].append((inp[0], out[0])))
            for i, model in enumerate(models) for m in cs.moe_layers(model)]
        with torch.no_grad():
            logits = [model(toks).float() for model in models]
            lines = []
            for layer, one in enumerate(cs.moe_layers(models[1])):
                (x0, y0), (x1, y1) = seen[0][layer], seen[1][layer]
                own = one(x0)[0]
                lines.append(
                    f"layer {layer}: inputs "
                    f"{float((x0.float() - x1.float()).abs().max()):.3g} "
                    f"apart, outputs "
                    f"{float((y0.float() - y1.float()).abs().max()):.3g}, on "
                    f"the same input "
                    f"{float((y0.float() - own.float()).abs().max()):.3g} in "
                    f"{int((y0 != own).sum())} of {own.numel()} outputs")
        for h in hooks:
            h.remove()
        M._combine = combine
        cs.combine_in_f32(models[1], False)
        if rank == 0:
            e = float((logits[0] - logits[1]).abs().max())
            print(f"{rule} combine: " + "; ".join(lines)
                  + f"; logits {e:.3g} apart", flush=True)

    run("bf16")
    run("f32")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, WORLD, f"tcp://localhost:{port}"))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    return max(abs(p.exitcode or 0) for p in procs)


if __name__ == "__main__":
    sys.exit(main())
