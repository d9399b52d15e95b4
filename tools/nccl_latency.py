#!/usr/bin/env python3
"""Latency and rate of the collectives expert parallelism uses, over NCCL
on every visible card (one spawned rank a card, up to four).

    python3 tools/nccl_latency.py [--iters 50]

For payloads from 16 KB to 64 MB a rank (bf16): ``all_gather`` (the
list form), ``all_to_all_single`` and
``all_reduce``, each timed with CUDA events over ``--iters`` back-to-back
calls after a barrier.  Rank 0 prints one JSON line a collective and
size (us a call, GB/s of the bytes a rank sends), after the card's name
and power limit and ``nvidia-smi topo -m``.  Run with ``NCCL_DEBUG=INFO``
in the environment to have NCCL name the transport it chose (P2P, SHM
or NET) on the standard error.  Needs two or more cards.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys

SIZES = (16 << 10, 256 << 10, 4 << 20, 64 << 20)


def rank_main(rank: int, world: int, init: str, iters: int) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, world_size=world,
                            rank=rank, device_id=torch.device("cuda", rank))
    for size in SIZES:
        n = size // 2
        x = torch.ones(n, dtype=torch.bfloat16, device="cuda")
        parts = [torch.empty_like(x) for _ in range(world)]
        y = torch.empty_like(x)
        calls = {"all_gather": lambda: dist.all_gather(parts, x),
                 "all_to_all_single": lambda: dist.all_to_all_single(y, x),
                 "all_reduce": lambda: dist.all_reduce(y)}
        for name, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            us = a.elapsed_time(b) / iters * 1e3
            if rank == 0:
                print(json.dumps({"collective": name, "ranks": world,
                                  "bytes_a_rank": size, "us": us,
                                  "GB_s": size / us / 1e3}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        sys.exit(f"needs two or more cards, {world} visible")
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ["nvidia-smi", "topo", "-m"]):
        print(subprocess.run(cmd, capture_output=True, text=True).stdout,
              flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.start_processes(
        rank_main, args=(world, f"tcp://localhost:{port}", args.iters),
        nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
