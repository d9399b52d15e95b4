"""End-to-end training driver: the port of ``repro.launch.train``.

Checkpoint/restart (resumable mid-run), preemption (SIGTERM) handling,
watchdog-based stall detection, deterministic data skip-ahead, optional
int8 gradient compression.  Runs on the card unless ``device`` names
another; parameters are drawn from a ``torch.Generator`` seeded with
``seed`` on that device (the JAX PRNG's initial weights are not
reproduced: a comparison with the reference carries weights through
``models.convert``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch import configs as C
from repro_torch.ckpt.manager import CheckpointManager, Watchdog
from repro_torch.data.pipeline import DataCfg, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.train import optim
from repro_torch.train.step import make_train_step


def train(arch: str, *, reduced: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 128, ckpt_dir=None,
          ckpt_every: int = 50, compression: bool = False, seed: int = 0,
          schedule: str | None = None, log_every: int = 10,
          watchdog_s: float = 300.0, on_step=None, device=None):
    """Train ``steps`` steps; returns ``(model, opt_state, losses)``, the
    losses of the steps this call ran."""
    dev = resolve_device(device)
    cfg = C.get_reduced(arch) if reduced else C.get_config(arch)
    data = TokenStream(DataCfg(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        enc_frames=64 if cfg.family == "encdec" else 0,
        d_model=cfg.d_model, seed=seed + 7))

    model = LM(cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(seed))
    opt = optim.adamw_init(dict(model.named_parameters()),
                           compression=compression)
    sched = schedule or ("wsd" if arch == "minicpm_2b" else "cosine")
    step_fn = make_train_step(cfg, schedule=sched, total=steps,
                              warmup=max(1, steps // 20))

    mgr = CheckpointManager(ckpt_dir, keep_n=3) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        model, opt = mgr.restore(start_step, (model, opt))
        print(f"[train] restored checkpoint @ step {start_step}")

    preempted = {"flag": False}

    def _sigterm(_sig, _frm):
        preempted["flag"] = True
    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # non-main thread (tests)

    wd = Watchdog(watchdog_s).start()
    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        model, opt, metrics = step_fn(model, opt, batch)
        wd.beat()
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step:
            on_step(step, loss)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/max(step-start_step+1,1):.2f}s/step)",
                  flush=True)
        if mgr is not None and ((step + 1) % ckpt_every == 0 or
                                preempted["flag"] or step == steps - 1):
            mgr.save(step + 1, (model, opt))
        if preempted["flag"]:
            print(f"[train] preempted at step {step}; checkpoint saved")
            break
    wd.stop()
    if mgr is not None:
        mgr.wait()
    return model, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                         global_batch=args.batch, seq_len=args.seq,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         compression=args.compression, device=args.device)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
