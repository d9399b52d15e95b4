#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the final line):

1. card: name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``src/repro_torch`` with nvcc
   for sm_90a, one process per source;
3. tick kernel checks: each tick kernel against its plain torch version
   on the card, at the packet engine's DF-1056 shapes plus ragged sizes
   and out-of-range entries, required ``torch.equal``; tick_rank also on
   one port, all distinct ports, all sentinels, M = 1, 65,536 entries
   over 64 ports and n_ports = 70,000 (its pairwise path), against a
   stable numpy sort where the one-hot plain version is too large, each
   case on the path ``ops.tick_rank_plan`` gives; flow_agg also on bool
   and uint8 rows; spritz_select at P 16, 17, 64, 200 and 256 and with
   u = 0 and u just below 1; the fused rank + RED/ECN launch
   (``ops.tick_rank_red_ecn``) against tick_rank's then red_ecn's plain
   versions at the DF-1056 shapes (t 0 and 70,000), M 17, 1 and 0 (no
   launch), all sentinels, negative and out-of-range ports, every
   occupancy 0..qsize+M with u at the RED probability and one f32 step
   below, and n_ports 70,000 (pairwise path); tick_draws (the tick's
   keys and two uniform draws) at the DF-1056 (F, M), ragged sizes and
   ticks and seeds up to 2**31 - 1; a CUDA graph that captured the fused
   launch and tick_draws, replayed at three ticks written to the tick's
   device tensor, equal to the plain versions at each; the draws made in
   place (the fused launch with ``rng=``, spritz_select with ``rng=`` and
   ``weighted_sample``) against tick_draws' plain version then the consumer's, at the
   DF-1056 (F, M), ragged
   sizes, ticks 0 and 2**31 - 1, three seeds and in a graph replayed at
   three ticks, with the device time of each beside its two-step form's;
   CUDA-event times of
   kernel, plain version and (flow_agg) ``index_add_``, and the device
   time of every tick kernel (the fused one beside tick_rank and red_ecn
   alone), of ``index_add_`` and of the engine's torch form of the rank
   (argsort + cummax + scatter) from torch.profiler; the ptxas registers
   and stack of spritz_select, weighted_sample, flow_agg and the
   tick_rank entries (spritz_select and weighted_sample must have no
   stack frame and no spills);
4. engine path: the 1,056-endpoint Dragonfly permutation run for ecmp,
   ugal_l, spritz_scout and spritz_spray_w (the scheme set of the
   registered cell engine.dragonfly1056.permutation.quick, and Scout)
   through ``engine.run`` on the card, kernels on, held against the
   committed golden record of the JAX reference.  Each run is the
   engine's loop: one gated step captured in a CUDA graph, replayed with
   a read of the stop flag every ``STEPS_PER_READ`` steps; a run must
   replay fewer than that many steps past its last, and each replay
   launch flow_agg twice and the fused tick_rank_red_ecn (shared-memory
   path, drawing the RED uniforms) once, for Spritz spritz_select and
   for ugal_l weighted_sample once (drawing the path uniforms), no
   tick_draws, nothing else; a line a scheme gives the launches a
   replay;
4c. the same four schemes as one ``engine.run_batch`` call, every lane
   equal to the golden record (which the reference's ``run_batch``
   wrote), with the same launches per replay;
4d. spritz_spray_w through the graph loop against the private eager loop
   (the same step, its wrappers called and the stop flag read every
   step): equal results and final carry; the warm steps/s of both in
   turns (eager, graph, graph, eager);
4b. failover path: the same run under two failure plans built with the
   port's ``failures.py``, held against the committed failover record:
   ``midrun`` (29 sampled links down at tick 16, up at 528; all 11
   schemes) and ``degraded`` (72 links at a quarter of line rate over the
   same window; ugal_l, flicr_w, ops_u, reps, spritz_spray_w).  Every run
   must report zero down and rate violations and finish every flow;
   per replay of the captured step flow_agg launches twice, spritz_select
   once for the Spritz schemes, weighted_sample once for valiant, ugal_l,
   flicr_w, ops_u, ops_w and reps; on ``midrun`` phase E is the fused
   launch once a replay and tick_draws never
   (shared-memory path) and the standalone tick_rank and red_ecn never
   launch; on ``degraded`` (a capacity plan) the standalone tick_rank
   and tick_draws (``n_flows`` 0: the torch RED math reads unif) launch
   once a replay, the rank on its shared-memory path, and the fused
   launch and red_ecn never; a line a scheme gives the launches a
   replay.  spritz_spray_w on ``midrun`` run as two segments
   (``until_tick`` 528, then ``resume``) must equal the unsegmented run,
   final carry included.  Warm steps/s for ugal_l, ops_u, reps and
   spritz_spray_w; then phase 4d's graph-against-eager check and timing
   on midrun spritz_spray_w;
4e. experiment matrix: the smoke tier's seven cells that run the packet
   engine (``data.SMOKE_CELLS``: micro adversarial, mid-run failure,
   Slim Fly all-to-all, the compression probe, seeded chaos with its
   healthy sweep, DF-1056 permutation, and the packet-fidelity open-loop
   web-search sweep, segmented at every window), each at its registered
   size through the port's runner (``repro_torch.exp.runner.run_cell``,
   ``force=True``, a temporary directory) on the card: every guard must
   pass (the probe's ``BENCH_engine.json`` baseline included) and every
   row must equal the reference's record ``smoke_cells_golden.json``
   field by field, the wall-time fields excluded; per replay flow_agg
   launches twice and one rank launch (fused, or standalone with
   tick_draws under a capacity plan) once, spritz_select only on Spritz
   lanes and weighted_sample only on the sampling schemes' lanes.  One
   line a cell: rows, guards, steps, replays, graph captures, wall s,
   steps/s and the card's name and power limit;
4f. flow-level engine: the smoke tier's three flow cells
   (``data.FABRIC_CELLS``: DF-1056 ring all-reduce, SF-1134 all-to-all,
   DF-1056 under a mid-run outage of its 8 most loaded global links), each
   at its registered size through the port's runner on the card
   (``force=True``, a temporary directory): every guard must pass (the
   ``BENCH_fabric.json`` baselines and spritz_spray_w's ``forced >= 1``
   included), every row must equal the reference's record
   ``fabric_cells_golden.json`` field by field, the wall-time fields
   excluded, every lane's ``fct`` must have its sha256 there (that of
   the bytes the reference's ``simulate`` returned), and every lane's
   state tensors (``choice``, ``remaining``) must have lived on ``cuda``
   (``FlowResult.stats.device``).  The flow
   engine launches none of the port's kernels, so every count stays 0.
   One line a cell and scheme: epochs, water-fill levels, host reads,
   wall s (the table build apart) and the card's name and power limit;
5. model kernel checks: flash attention and chunked RWKV-6 against their
   plain versions at the serving path's shapes (prefill and decode, bf16
   and f32; bf16 also at LLaVA's 56 / 8 heads over 1,600 positions,
   DeepSeek-MoE's 16 / 16 and Mixtral's 32 / 8 with its 4,096 window
   over 1 x 4,608, each on the path phase 8 takes; bf16 and f32 at
   Jamba's 64 / 8 heads, prefill and decode, and at Whisper's 12 / 12
   heads of 64: the encoder over 4 x 1,500 frames and the cross-attention
   of a 4 x 448 prefill and of a decode row to them, not causal, and the
   decoder's causal 4 x 448) and at ragged,
   sliding-window and strong-decay cases, within
   the tolerances of ``tests/test_kernels.py``, each bf16 attention case
   also within 2x of SDPA's max and mean error against the f32 reference,
   each attention case printing the path it took (wgmma, split or simt);
   CUDA-event times of kernel, plain version and (attention)
   ``scaled_dot_product_attention``, and the device times of attention,
   SDPA (at decode also SDPA over the visible keys alone) and RWKV-6 from
   torch.profiler; each RWKV-6 case prints its dynamic shared memory and
   the kernel's ptxas registers and spills; every forward case at
   q_offset 0 off the split path also runs ``ops.flash_attention_lse``
   (the forward writing the row log-sum-exp, as training takes it), whose
   o must equal the case's and whose LSE the plain one within 1e-3;
6. card against CPU: the reduced Phi-3, RWKV-6, DeepSeek-MoE, Mixtral,
   LLaVA (with seeded patch embeddings), Jamba and Whisper (with seeded
   frames [2, 64, d]) configs in f32 on ``cuda``
   (kernels) and on ``cpu`` (plain versions) from the same weights,
   prefill and 16 decode steps, logits within 1e-4; every MoE layer's
   integer dispatch (top-k experts, ``keep``, ``dst``, ``counts``) on the
   card equal to the CPU's for the CPU layer's input, in the prefill and
   in each decode step;
7. prefill against decode at full width, 2 layers, f32: the prefill
   logits equal the step-by-step decode logits at every position (the
   MoE archs with a dropless capacity factor, since capacity drops differ
   between T tokens and one; LLaVA with its 576 patch embeddings put
   through the cache by ``decode_embeds``; Jamba's attention and Mamba +
   MoE layers; Whisper's 2 decoder and 2 encoder layers over 1,500
   seeded frames, encoded in every decode step);
8. serving path: Phi-3-medium-14B (40 layers), RWKV-6-7B (32 layers),
   DeepSeek-MoE-16B (28 layers), Mixtral-8x7B (its width, 16 of its 32
   layers: whole it is ~93 GB of bf16), LLaVA-NeXT-34B (60 layers) and
   Jamba-1.5-Large (its width, 4 of its 72 layers: every block kind;
   the Mamba scan kernel once a Mamba layer a prefill, its backward
   never) in bf16, random weights from a seeded generator on the card:
   ``make_prefill_step`` on 4 x 1,024 tokens (LLaVA after 4 x 576 seeded
   patch embeddings), then a 4-slot ``Server`` answering 8 requests of 64
   generated tokens; every request must complete, the model kernel of
   each path must launch, and attention must take the wgmma path in the
   prefill and the split path in the decode; the MoE archs print the
   (token, expert) assignments the prefill dropped for capacity and the
   per-expert demand behind the drops (each layer's input taken by a
   forward pre-hook, its dispatch recomputed); Mixtral
   also runs one 1 x 4,608-token prefill, past its 4,096-token window;
   Whisper-small whole (12 + 12 layers), which the ``Server`` refuses,
   through the steps: a 4 x 448-token prefill over 4 x 1,500 seeded
   frame embeddings, then 64 greedy decode steps on 4 slots with the
   frames in each batch (the encoder, wgmma, in every step; self- and
   cross-attention on the split path);
5b. (the training phases run after serving's, so that phase 8's peak
   memory is serving's alone) attention's backward kernel
   (``ops.flash_attention_bwd``: dQ, then dK / dV, on the path
   ``ops.flash_bwd_plan`` picks, printed a case; MiniCPM's and Phi-3's
   bf16 shapes must take wgmma) against
   ``ref.mha_backward_reference`` on the forward kernel's o and LSE:
   MiniCPM-2B's training shape as phase 9 trains it (8 x 2,048, 36 / 36
   heads of 64, causal) in bf16 and f32, Phi-3's 40 / 10 heads of 128
   at 1 x 2,048, and ragged, non-causal Sq != Sk, windowed and causal
   Sq < Sk cases; each case's LSE forward within 1e-3 of ``ref.mha_lse``
   and its o equal to the serving launch's where both take one path;
   f32 within 1e-4, bf16 within 5e-2 of each gradient's largest entry
   and within 2x of SDPA's backward's max and mean error against the f32
   plain backward; CUDA-event and profiler times of the kernel, the
   plain version and SDPA's backward, the bound (2.5x the forward's
   FLOPs; q, k, v, o, dO, dq, dk, dv and the LSE once), the kernels'
   ptxas registers, stack and spills (a wgmma kernel that spills
   fails); the same at this slice's bf16 training shapes, each on the
   path ``ops.flash_bwd_plan`` gives (wgmma): Whisper's encoder over 8 x
   1,500 frames (ragged: 1,500 is no multiple of 64) and its
   cross-attention of 8 x 448 to them, not causal, its causal decoder 8
   x 448, DeepSeek-MoE's 16 / 16 heads of 128 at 4 x 2,048, causal;
   then the chunked RWKV-6 time mix's backward kernel
   (``ops.rwkv6_chunked_bwd``) against
   ``ref.rwkv6_chunked_backward_reference``, fed the forward kernel's own
   y and chunk-start states (``ops.rwkv6_chunked_states``: its y equal to
   the serving launch's, its states within 1e-4 of the plain ones), at
   RWKV-6-7B's training shape (4 x 2,048, 64 heads of 64, f32, chunk 16,
   wkv0 zero), at strong decay (w in [0.3, 0.6), chunk 32) and with a
   non-zero wkv0 and a final state's gradient: every gradient within
   1e-4 of its largest entry, the same bits twice; CUDA-event and
   profiler times of the kernel and of the plain version, the bound, its
   ptxas registers, stack and spills (none allowed), its blocks an SM
   (at least 2 at chunk 16); at the training shape also the
   forward kernel's device time with and without its states pointer;
   attention's backward also at Jamba-1.5-Large's training shape (2 x
   2,048, 64 / 8 heads of 128, bf16, causal; wgmma); then the Mamba
   scan's kernels (``ops.mamba_scan_states``, the forward writing its
   checkpoints every 16 tokens, and ``ops.mamba_scan_bwd``) against
   ``ref.mamba_scan_reference`` / ``ref.mamba_scan_backward_reference``
   at Jamba's width (d_in 16,384, d_state 16, f32) over 1 and 2 x 2,048
   tokens, h0 zero and not, with a final state's gradient, and at the
   tiles' edges (S 77 and 40, S 5 under one 16-token sub-tile, d_in 200,
   130 and 4,100, B 3): y, the final state, the checkpoints and every
   gradient within 1e-4 of its largest entry, the same bits twice,
   autograd one launch each way, the decays within expf's 2 ulp of exp
   of the rounded dt A; ptxas registers, stack and spills (a stack frame or
   spills fail), the backward's blocks an SM (at least 2), the forward's
   grid at B 1 in one wave, CUDA-event and profiler times of the kernels
   and plain versions, and the bound (the exponentials at 16 a clock an
   SM: ``work.mamba_scan_work``);
6b. training card against CPU: reduced MiniCPM, Phi-3, LLaVA,
   DeepSeek-MoE, Whisper (seeded frames [4, 64, d]), RWKV-6 and Jamba in
   f32, the loss within 1e-4 and every gradient within 1e-4 of its
   largest entry (every MoE layer's integer dispatch equal on both; the
   RWKV-6 time mix launching its forward kernel twice a layer, the
   forward and its recomputation, and its backward kernel once; Jamba's
   Mamba scan likewise a Mamba layer), then three train
   steps (the second with ``microbatch=2``),
   each from the CPU's state: before each, the gradient the step takes
   within 1e-4 of each tensor's largest entry on every element; after
   it, the parameters and AdamW's ``m`` / ``v`` within 1e-4 of each
   tensor's largest entry but for elements in AdamW's amplifying regime
   (a nonzero gradient within 1e-5 of its tensor's largest, or at most
   100 x ``eps`` and past that tolerance), bounded apart; Jamba's
   ``dt_bias`` leaves against the port's own step in f64 on the CPU,
   within 1e-4 or twice the plain versions' gap to it on the card; the
   CPU at ``CPU_THREADS`` threads;
9. training: MiniCPM-2B whole (40 layers, 3,008,289,024 parameters in
   bf16, AdamW moments in f32) trained 8 steps of 8 x 2,048 tokens by
   ``repro_torch.launch.train.train`` (WSD, remat): every loss finite and
   the last below the first, attention's forward launched 80 times a
   step (40 and 40 recomputed, all wgmma) and its backward 80 (40 x dQ
   and dK / dV, all wgmma), no other kernel of the port; one line with
   the losses,
   warm ms/step, tokens/s, model FLOP/s (6 N D without the embedding
   table, attention's backward 2.5x its forward, remat's recomputation
   left out) against 989 TFLOP/s, peak memory
   and the card; then the reduced MiniCPM's restart check (6 steps
   straight against 3, a checkpoint and a resume to 6: losses within
   2e-4, whether bit-equal); then the other trainable families at their
   published widths, 8 steps each through ``make_train_step`` and AdamW
   as ``launch.train`` composes them (cosine, remat, weights from a
   seeded generator, batches from the data pipeline): Whisper-small
   whole, 8 x 448 tokens over 8 x 1,500 frames; DeepSeek-MoE-16B at 4
   of its 28 layers and RWKV-6-7B at 8 of its 32 (``TRAIN_FAMILIES``),
   4 x 2,048 tokens each: every loss finite, the last below the first,
   exactly the kernels of the family's path launched (attention's
   forward twice and its backward twice an attention call, on the paths
   the plans give; RWKV-6's forward twice and its backward once a
   layer); one line a family with the losses, warm ms/step, tokens/s,
   model FLOP/s against 989 TFLOP/s, peak memory and the card;
10a. TP head alignment, one card: Phi-3-medium-14B's 40 / 10 heads
   padded for tp 16 (``models/tp_align.py``: 64 / 16, 24 dead query
   heads); at 2 layers in f32 the padded model's prefill logits and 8
   decode steps equal the exact model's from the same seed within phase
   7's tolerance; then whole in bf16 through phase 8's serving path, its
   decode ms/step, prefill tokens/s, peak memory and attention paths
   beside phase 8's exact model's;
10b. expert parallelism over NCCL, with two or more cards visible (on one
   it prints a line saying it did not run): 4 ranks with four cards,
   else 2, spawned by ``torch.multiprocessing``, one a card; a rank that
   fails, or a spawn past ``EP_TIMEOUT_S``, fails the phase.  Checks
   (``EP_PLAN``): DeepSeek-MoE-16B's MoE layer (64 experts, d 2,048, f
   1,408, top 6) in f32 on the all-to-all path, dropless equal to the
   one-card layer within 1e-5 and at the config's capacity factor (tokens
   dropped) to the plain per-rank oracle (``moe.ep_oracle``) within 1e-5
   of the output's largest entry, aux within 1e-6; the f-split path at
   Mixtral's d and f with 3 x W / 2 experts, both checks within 1e-5 of
   the largest entry (f32 GEMMs over other row sets or f slices round
   apart by a few ulp of it); Mixtral-8x7B at 4 of 32 layers in bf16 on the
   mesh against one card from the same seed: in the dropless prefill
   each MoE layer against the one-card layer on the same input (both
   combining in f32, as the reference's EP does), and 8 decode steps'
   logits, within 5e-2 (the prefill's logits are printed, not held:
   ulp-level differences flip routing choices downstream); Mixtral-8x7B
   whole (32 layers) served 8 requests through the ``Server`` on the
   mesh, every rank the same
   tokens: prefill tokens/s, decode ms/step, peak memory a card, the
   flash_attention launches of each rank (``--profile``: the NCCL
   kernels' device time in a prefill and a decode step, from each
   rank's torch.profiler trace).  Rank 0 shares card 0 with this
   process, which frees its cached memory first; each rank's
   flash_attention launches join the kernel line's.  ``rehearse_ep``
   (never called here) runs the same ranks over gloo on the CPU at the
   reduced configs;
10c. hybrid training over NCCL, with four cards visible (with fewer
   it prints a line saying it did not run): Jamba-1.5-Large at its
   published widths, cut to its first 3 of 72 layers (attention, Mamba
   + MoE, Mamba: every block kind), bf16, 4 ranks on a (data 1, model
   4) mesh (its 16 experts 4 a rank), spawned one a card; 8 steps of 2 x
   2,048 tokens from the data pipeline through ``make_train_step`` and
   AdamW as ``launch.train`` composes them (cosine, remat, weights from a
   seeded generator): every loss finite, the last below the first,
   every rank the same losses, every replicated parameter the same bits
   on every rank after the last step (broadcast from rank 0 and
   compared); each step exactly attention's forward twice and its
   backward's two launches an attention layer, the Mamba scan twice and
   its backward once a Mamba layer, nothing else; one line with the
   losses, warm ms/step, tokens/s, peak memory by card and the launches
   a step (``--profile``: the NCCL kernels' device time in one step);
   ``rehearse_hybrid`` (never called here) runs the same ranks over gloo
   on the CPU at the reduced config;
11. the dry run against the card: each step phases 8-10 measured
   (phase 9's MiniCPM-2B train step, phase 8's seven served models,
   phase 10a's padded Phi-3, phase 10b's whole Mixtral on each rank,
   phase 10c's Jamba train step on each rank)
   estimated on the ``meta`` device by ``repro_torch.launch.dryrun``
   for the same config, shapes and dtype, no model run of its own: the
   estimate's static bytes (parameters, AdamW's state, cache; a rank's
   share on the mesh) must equal the summed ``nbytes`` of the live
   tensors on the card to the byte; the estimate's static + temp
   against ``torch.cuda.max_memory_allocated`` and the train step's
   FLOPs against ``work.family_flops`` are printed, one line a step;
12. the script's wall time, a JSON line of kernel numbers, then the final
   JSON line.

``--profile`` adds ``torch.profiler`` breakdowns of one warm engine
run (graph replays: the device's busy share of the warm wall time and
the launches a step), of the failover phase's spritz_spray_w runs
(midrun and degraded), of one flow-engine lane (phase 4f's DF-1056
train cell, spritz_spray_w: busy share, launches and device time a
water-fill level, the host ops with the most CPU time), and, per served
model, of one prefill and 8 decode steps (busy share, launches, the
kernels and host ops with the most time, and the synchronizing CUDA
calls of one prefill and of one decode step), and of one MiniCPM-2B
train step (device time by kind: GEMMs, attention forward and backward,
the rest; the AdamW update and the loss's forward and backward timed
apart) and of one train step of each other family (by kind, the RWKV-6
kernels and the MoE dispatch apart).
Imports torch and the port only, never jax nor the reference package.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import inspect
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' work formulas, the card's peak rates and the bound: one
# copy in the package (the dry run credits kernels on ``meta`` with them)
try:
    from repro_torch.kernels.work import (
        HBM_BYTES_PER_S, PEAK_FLOPS, attention_bwd_work, attention_work,
        bound_ms, family_flops, mamba_scan_bound, mamba_scan_work,
        rwkv_bwd_flops, rwkv_flops)
except ImportError as e:
    sys.exit(f"chip_smoke: FAIL: cannot import the port (run from a "
             f"checkout): {e}")
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flow_agg": ("src/repro_torch/kernels/csrc/flow_agg.cu",
                 "src/repro/kernels/flow_agg.py:69"),
    "tick_rank": ("src/repro_torch/kernels/csrc/tick_rank.cu",
                  "src/repro/kernels/tick_rank.py:75"),
    "red_ecn": ("src/repro_torch/kernels/csrc/red_ecn.cu",
                "src/repro/kernels/red_ecn.py:90"),
    # tick_rank's launch with red_ecn's stage as its epilogue: the engine's
    # phase E (also carries tick_rank.py:75's work there)
    "tick_rank_red_ecn": ("src/repro_torch/kernels/csrc/tick_rank.cu",
                          "src/repro/kernels/red_ecn.py:90"),
    # the tick's keys and two uniform draws (the reference computes them
    # with jax.random in XLA, not in a Pallas kernel)
    "tick_draws": ("src/repro_torch/kernels/csrc/tick_draws.cu",
                   "src/repro/net/sim/engine.py:130"),
    "spritz_select": ("src/repro_torch/kernels/csrc/spritz_select.cu",
                      "src/repro/kernels/spritz_select.py:72"),
    # the weighted-sample schemes' sampler, drawing the tick's path
    # uniforms itself (the reference draws and samples with jax.random and
    # XLA, not in a Pallas kernel)
    "weighted_sample": ("src/repro_torch/kernels/csrc/weighted_sample.cu",
                        "src/repro/net/policies/base.py:151"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    # attention's gradient (the reference trains through XLA's autodiff of
    # its plain chunked attention, not through a Pallas kernel)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/common.py:166"),
    "rwkv6_chunked": ("src/repro_torch/kernels/csrc/rwkv6_chunked.cu",
                      "src/repro/kernels/rwkv6_chunked.py:90"),
    # the time mix's gradient (the reference trains through XLA's autodiff
    # of its plain chunked form, not through a Pallas kernel)
    "rwkv6_chunked_bwd": ("src/repro_torch/kernels/csrc/rwkv6_chunked_bwd.cu",
                          "src/repro/models/ssm.py:129"),
    # Mamba's selective scan and its gradient (the reference gives both to
    # XLA: an associative scan in 256-token chunks and its autodiff, not a
    # Pallas kernel)
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/models/ssm.py:88"),
    "mamba_scan_bwd": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                       "src/repro/models/ssm.py:88"),
}
TICK_KERNELS = ("flow_agg", "tick_rank", "red_ecn", "tick_rank_red_ecn",
                "tick_draws", "spritz_select", "weighted_sample")
SERVE_ARCHS = {"phi3_medium_14b": "flash_attention",
               "rwkv6_7b": "rwkv6_chunked",
               "deepseek_moe_16b": "flash_attention",
               "mixtral_8x7b": "flash_attention",
               "llava_next_34b": "flash_attention",
               "jamba_1_5_large": "flash_attention",
               "whisper_small": "flash_attention"}
# phase 8's depth cuts (widths stay published): Mixtral-8x7B's 32 layers
# are ~93 GB of bf16, over the card's 80 GB; Jamba-1.5-Large's first 4
# layers (attention, Mamba + MoE, Mamba, Mamba + MoE: every block kind)
# are ~46 GB, its whole 8-layer unit ~90 GB
SERVE_LAYERS = {"mixtral_8x7b": 16, "jamba_1_5_large": 4}
# Whisper-small's serving shapes: 1,500 frames (n_audio_ctx, 30 s of
# audio) and 448 decoder positions (n_text_ctx), arXiv:2212.04356
WHISPER_FRAMES, WHISPER_TEXT = 1500, 448


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host's CPU model and the cores this process may use: the
    host-paced numbers (decode steps, flow cells) depend on them.  Some
    virtualized hosts report the model name as "unknown"; the vendor,
    family and model numbers, clock and the board's product name still
    tell hosts apart."""
    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                      # the first processor only
                key, _, val = line.partition(":")
                cpu[key.strip()] = val.strip()
    except OSError:
        pass
    try:
        with open("/sys/devices/virtual/dmi/id/product_name") as f:
            board = f.read().strip() or "unknown"
    except OSError:
        board = "unknown"
    usable = (len(os.sched_getaffinity(0))
              if hasattr(os, "sched_getaffinity") else os.cpu_count())
    return (f"host: {cpu.get('model name', platform.machine())} "
            f"({cpu.get('vendor_id', '?')} family "
            f"{cpu.get('cpu family', '?')} model {cpu.get('model', '?')}, "
            f"{cpu.get('cpu MHz', '?')} MHz), board {board}, "
            f"{os.cpu_count()} logical cores, {usable} usable by this "
            f"process")


def time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# measurements that torch.profiler could not make, by label: those
# were timed with CUDA events instead (see ``device_us``)
EVENT_TIMED: list[str] = []


def timed_by(what: str) -> str:
    return "CUDA events" if what in EVENT_TIMED else "torch.profiler"


def device_us(fn, torch, n: int = 50, what: str = "") -> float:
    """Device time per call, in us, of the CUDA kernels that ``fn``
    launches (torch.profiler over ``n`` warm calls), so that a kernel and
    a library call compare without their host cost.  The sum is divided
    by the calls the trace holds, the fewest launches of any one kernel
    (a call may launch a kernel more than once), not by ``n``: a trace
    can drop a short run's first records.  A trace can also come back
    with no CUDA kernel at all; after three such traces the time is
    taken with CUDA events over ``n`` back-to-back calls (host gaps
    included where the calls are host-paced) and ``what`` is noted in
    ``EVENT_TIMED``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        if kern:
            return sum(e.self_device_time_total for e in kern) / \
                min(e.count for e in kern)
        print(f"chip_smoke: torch.profiler recorded no CUDA kernel for "
              f"{what} (trace {attempt + 1} of 3)", file=sys.stderr,
              flush=True)
    EVENT_TIMED.append(what)
    return time_ms(fn, reps=n, warmup=2) * 1e3


def ptxas_entries(log: str) -> dict:
    """Registers, static shared memory, stack frame and spill store bytes
    of every entry function in nvcc's ``-Xptxas -v`` report, keyed by
    mangled name (ptxas leaves out ``bytes smem`` when it is 0)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            key = m.group(1)
            out[key] = dict(registers=None, smem_bytes=None, stack_bytes=None,
                            spill_bytes=None)
        elif key and "stack frame" in line:
            out[key]["stack_bytes"] = int(re.search(
                r"(\d+) bytes stack frame", line).group(1))
            out[key]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[key]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def rwkv_ptxas(log: str) -> dict:
    """(registers, spill store bytes) of each ``rwkv6_chunked_kernel``
    instantiation in nvcc's ``-Xptxas -v`` report, keyed "f32 CP16" (input
    type, chunk padded to a multiple of 16)."""
    out = {}
    for name, ent in ptxas_entries(log).items():
        m = re.search(r"rwkv6_chunked_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      name)
        if m:
            key = f"{'f32' if m.group(1) == 'f' else 'bf16'} CP{m.group(2)}"
            out[key] = (ent["registers"], ent["spill_bytes"])
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(ops, ref, sorted_rank, torch, np, shapes,
                  dev="cuda") -> dict:
    """Phase 3: kernel vs plain version on the card; returns per-kernel
    numbers at the main path's shapes.  ``sorted_rank`` is the engine's
    torch form of the rank, timed as tick_rank's yardstick."""
    N, F, M, NP_, P = (shapes[k] for k in ("N", "F", "M", "n_ports", "P"))
    rng = np.random.default_rng(0)

    def cu(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def same(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{name}: kernel differs from its plain version")
        return max(float((g.double() - w.double()).abs().max())
                   if g.numel() else 0.0 for g, w in zip(got, want))

    out = {}
    i32, f32 = torch.int32, torch.float32

    # ---- flow_agg: K = 6 (phase A) and K = 2 (phase B), ragged, sentinels
    def agg_inputs(K, n, vmax, sentinels, dtype=i32):
        rows = rng.random((K, n)) < 0.05
        if dtype != torch.bool:
            rows = rows * rng.integers(1, vmax + 1, (K, n))
        pflow = rng.integers(0, F, n)
        if sentinels:
            pflow[rng.integers(0, n, 64)] = rng.choice([-1, F, F + 7], 64)
        return cu(rows, dtype), cu(pflow, i32)

    err = 0.0
    for K, n, vmax, sent, dt in (
            (6, N, 1, False, torch.bool), (6, N, 1, False, i32),
            (2, N, 4000, False, i32), (6, 1000, 1, True, i32),
            (3, 257, 9, True, i32), (6, 1000, 1, True, torch.bool),
            (3, 257, 255, True, torch.uint8), (4, 0, 1, False, torch.bool)):
        rows, pflow = agg_inputs(K, n, vmax, sent, dt)
        err = max(err, same(f"flow_agg K {K} N {n} {dt}",
                            ops.flow_agg(rows, pflow, n_flows=F),
                            ref.flow_agg_reference(rows, pflow, n_flows=F)))
    # phase A's call: six stacked bool indicators, as the engine passes them
    rows_b, pflow = agg_inputs(6, N, 1, False, torch.bool)
    rows = rows_b.to(i32)
    rows_t = rows.T.contiguous()

    def lib_agg():
        return torch.zeros((F, 6), dtype=i32, device=dev).index_add_(
            0, pflow, rows_t)
    if not torch.equal(lib_agg().T, ops.flow_agg(rows, pflow, n_flows=F)):
        fail("flow_agg: index_add_ yardstick disagrees")
    out["flow_agg"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.flow_agg(rows_b, pflow, n_flows=F)),
        plain_ms=time_ms(lambda: ref.flow_agg_reference(rows_b, pflow,
                                                        n_flows=F)),
        library_ms=time_ms(lib_agg),
        device_us=device_us(lambda: ops.flow_agg(rows_b, pflow, n_flows=F),
                            torch, what="flow_agg"),
        library_device_us=device_us(lib_agg, torch,
                                    what="flow_agg index_add_"),
        bytes=nbytes(rows_b, pflow) + 6 * F * 4)
    rows2, pflow2 = agg_inputs(2, N, 4000, False)
    out["flow_agg"]["ms_k2"] = time_ms(
        lambda: ops.flow_agg(rows2, pflow2, n_flows=F))
    out["flow_agg"]["k2_device_us"] = device_us(
        lambda: ops.flow_agg(rows2, pflow2, n_flows=F), torch,
        what="flow_agg K 2")

    # ---- tick_rank: a compacted set (valid prefix, sentinel tail), ragged
    def rank_inputs(m, n_valid):
        port = np.full(m, NP_)
        port[:n_valid] = rng.integers(0, NP_, n_valid)
        port[:n_valid:7] = rng.integers(0, 16, len(port[:n_valid:7]))
        port[rng.integers(0, m, 8)] = -1
        return cu(port, i32)

    def stable_rank(port, n_ports):
        """The rank by a stable numpy sort, for shapes whose one-hot plain
        version is too large: position in the sorted run of its bucket."""
        p = port.cpu().numpy()
        b = np.where((p < 0) | (p >= n_ports), n_ports, p)
        order = np.argsort(b, kind="stable")
        srt = b[order]
        rank = np.empty(len(b), np.int32)
        rank[order] = np.arange(len(b)) - np.searchsorted(srt, srt, "left")
        return torch.from_numpy(rank).to(dev)

    err = 0.0
    cases = [(rank_inputs(m, nv), NP_)
             for m, nv in ((M, 4200), (M, M), (1000, 600), (37, 37))]
    cases += [(cu(np.full(M, 5), i32), NP_),                 # one port
              (cu(rng.permutation(NP_), i32), NP_),          # all distinct
              (cu(np.full(M, NP_), i32), NP_),               # all sentinel
              (cu(np.array([3]), i32), NP_),                 # M = 1
              (rank_inputs(M - 1, M - 1), NP_),              # M % 32 != 0
              (cu(rng.integers(-1, 66, 65536), i32), 64),    # 65,536 / 64
              (cu(rng.integers(-1, 70002, 2000), i32), 70000)]  # pairwise
    small = cases[2][0]
    if not torch.equal(stable_rank(small, NP_),
                       ref.tick_rank_reference(small, n_ports=NP_)):
        fail("tick_rank: the stable-sort rank disagrees with the plain "
             "version")
    for port, n in cases:
        path = ops.tick_rank_plan(port.shape[0], n)[0]
        before = dict(ops.TICK_RANK_PATHS)
        got = ops.tick_rank(port, n_ports=n)
        if ops.TICK_RANK_PATHS[path] != before[path] + 1:
            fail(f"tick_rank: M {port.shape[0]}, n_ports {n} did not "
                 f"take its planned path {path}")
        want = (stable_rank(port, n) if port.shape[0] * (n + 1) > 1 << 26
                else ref.tick_rank_reference(port, n_ports=n))
        err = max(err, same(f"tick_rank M {port.shape[0]} n_ports {n} "
                            f"({path})", got, want))
    if ops.tick_rank(cu(np.zeros(0), i32), n_ports=NP_).numel() != 0:
        fail("tick_rank: M = 0 gave a result")
    port = rank_inputs(M, 4200)
    ar_m = torch.arange(M, dtype=i32, device=dev)
    plan = ops.tick_rank_plan(M, NP_)
    out["tick_rank"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_rank(port, n_ports=NP_)),
        plain_ms=time_ms(lambda: ref.tick_rank_reference(port, n_ports=NP_)),
        library_ms=None, bytes=2 * nbytes(port),
        device_us=device_us(lambda: ops.tick_rank(port, n_ports=NP_), torch,
                            what="tick_rank"),
        path=plan[0], segs=plan[1], smem_bytes=plan[2],
        torch_form_ms=time_ms(lambda: sorted_rank(port, ar_m)),
        torch_form_device_us=device_us(lambda: sorted_rank(port, ar_m),
                                       torch, what="tick_rank torch form"))

    # ---- red_ecn: random candidates, then every occupancy 0..qsize+M
    qsize, kmin, kmax = shapes["qsize"], shapes["kmin"], shapes["kmax"]
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=NP_)
    err = 0.0
    for t in (40, 70000):
        eport = rank_inputs(M, 4200).clamp_min(0)
        rank = ref.tick_rank_reference(eport, n_ports=NP_)
        enq = eport < NP_
        unif = cu(rng.random(M), f32)
        q_tail = cu(t + rng.integers(-40, 120, NP_), i32)
        err = max(err, same("red_ecn",
                            ops.red_ecn(eport, rank, enq, unif, q_tail, t,
                                        **kw),
                            ref.red_ecn_reference(eport, rank, enq, unif,
                                                  q_tail, t, **kw)))
    t = 500
    occ_all = torch.arange(qsize + M + 1, dtype=i32, device=dev)
    n_all = occ_all.numel()
    e_all = torch.zeros(n_all, dtype=i32, device=dev)
    qt = torch.full((NP_,), t, dtype=i32, device=dev)
    en = torch.ones(n_all, dtype=torch.bool, device=dev)
    pr = ((occ_all.float() - float(np.float32(kmin)))
          * float(np.float32(1) / np.float32(max(kmax - kmin, 1e-9)))
          ).clamp(0.0, 1.0)
    for u in (pr, torch.nextafter(pr, torch.zeros_like(pr))):
        err = max(err, same("red_ecn",
                            ops.red_ecn(e_all, occ_all, en, u.contiguous(),
                                        qt, t, **kw),
                            ref.red_ecn_reference(e_all, occ_all, en, u, qt,
                                                  t, **kw)))
    eport = rank_inputs(M, 4200).clamp_min(0)
    rank = ref.tick_rank_reference(eport, n_ports=NP_)
    enq = eport < NP_
    unif = cu(rng.random(M), f32)
    q_tail = cu(70000 + rng.integers(-40, 120, NP_), i32)
    # timed with the tick in device memory, as the engine passes it (an
    # int would add a host-to-device copy to each call)
    t_dev = torch.tensor(70000, dtype=i32, device=dev)
    outs = ops.red_ecn(eport, rank, enq, unif, q_tail, t_dev, **kw)
    out["red_ecn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.red_ecn(eport, rank, enq, unif, q_tail,
                                       t_dev, **kw)),
        plain_ms=time_ms(lambda: ref.red_ecn_reference(
            eport, rank, enq, unif, q_tail, t_dev, **kw)),
        library_ms=None,
        device_us=device_us(lambda: ops.red_ecn(eport, rank, enq, unif,
                                                q_tail, t_dev, **kw),
                            torch, what="red_ecn"),
        bytes=nbytes(eport, rank, enq, unif, q_tail, *outs))

    # ---- tick_rank_red_ecn: the rank and red_ecn's stage in one launch,
    # against tick_rank's then red_ecn's plain versions
    def rank_red_plain(port, enq, unif, q_tail, t, n):
        rank = (stable_rank(port, n) if port.shape[0] * (n + 1) > 1 << 26
                else ref.tick_rank_reference(port, n_ports=n))
        return ref.red_ecn_reference(port, rank, enq, unif, q_tail, t,
                                     **dict(kw, n_ports=n))[1:]

    def fused_case(label, port, enq, unif, q_tail, t, n):
        path = ops.tick_rank_plan(port.shape[0], n)[0]
        before = dict(ops.TICK_RANK_PATHS)
        launched = ops.LAUNCHES["tick_rank_red_ecn"]
        got = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t,
                                    **dict(kw, n_ports=n))
        want_launch = int(path != "none")
        if ops.LAUNCHES["tick_rank_red_ecn"] != launched + want_launch or (
                want_launch and
                ops.TICK_RANK_PATHS[path] != before[path] + 1):
            fail(f"tick_rank_red_ecn {label}: not one launch on its planned "
                 f"path {path}")
        return same(f"tick_rank_red_ecn {label} ({path})", got,
                    rank_red_plain(port, enq, unif, q_tail, t, n))

    def tails(t, n):
        return cu(t + rng.integers(-40, 120, n), i32)

    err = 0.0
    for tt in (0, 70000):                      # the DF-1056 shapes
        port = rank_inputs(M, 4200)
        err = max(err, fused_case(f"M {M} t {tt}", port, port < NP_,
                                  cu(rng.random(M), f32), tails(tt, NP_),
                                  tt, NP_))
    for m in (17, 1, 0):                       # ragged, then nothing
        port = rank_inputs(m, m) if m else cu(np.zeros(0), i32)
        err = max(err, fused_case(f"M {m}", port, port < NP_,
                                  cu(rng.random(m), f32), tails(40, NP_), 40,
                                  NP_))
    port = cu(np.full(M, NP_), i32)            # all sentinels
    err = max(err, fused_case("all sentinels", port, port < NP_,
                              cu(rng.random(M), f32), tails(40, NP_), 40,
                              NP_))
    port = cu(rng.integers(-NP_, NP_ + 3, M), i32)   # negative, out of range
    err = max(err, fused_case("negative and out-of-range ports", port,
                              cu(rng.random(M) < 0.8, torch.bool),
                              cu(rng.random(M), f32), tails(40, NP_), 40,
                              NP_))
    # every occupancy 0..qsize+M (red_ecn's t, occ_all, pr and tails qt
    # above): from the rank (one port, tail t) and from the tails (a port
    # each, rank 0), u at the RED probability and one f32 step below it
    for u in (pr, torch.nextafter(pr, torch.zeros_like(pr))):
        u = u.contiguous()
        err = max(err, fused_case("every occupancy, one port",
                                  cu(np.full(n_all, 5), i32), en, u, qt, t,
                                  NP_))
        err = max(err, fused_case("every occupancy, a port each", occ_all,
                                  en, u, t + occ_all, t, n_all))
    port = cu(rng.integers(-1, 70002, 2000), i32)    # the pairwise path
    err = max(err, fused_case("n_ports 70000", port, port < 70000,
                              cu(rng.random(2000), f32), tails(40, 70000),
                              40, 70000))
    port = rank_inputs(M, 4200)
    enq, unif, q_tail = port < NP_, cu(rng.random(M), f32), tails(70000, NP_)
    outs = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)
    out["tick_rank_red_ecn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_rank_red_ecn(port, enq, unif, q_tail,
                                                 t_dev, **kw)),
        plain_ms=time_ms(lambda: rank_red_plain(port, enq, unif, q_tail,
                                                t_dev, NP_)),
        library_ms=None,
        device_us=device_us(lambda: ops.tick_rank_red_ecn(
            port, enq, unif, q_tail, t_dev, **kw), torch,
            what="tick_rank_red_ecn"),
        bytes=nbytes(port, enq, unif, q_tail, *outs),
        path=plan[0], segs=plan[1], dynamic_smem_bytes=plan[2])

    # ---- the tick read from device memory: a graph that captured the fused
    # launch and the draws gives each replay's tick's results
    t_dev = torch.zeros((), dtype=i32, device=dev)
    key = cu(np.array([0, 11]), torch.int64)
    ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)   # warm
    ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_fused = ops.tick_rank_red_ecn(port, enq, unif, q_tail, t_dev, **kw)
        g_draws = ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    for tt in (69990, 70000, 70100):
        t_dev.fill_(tt)
        graph.replay()
        torch.cuda.synchronize()
        same(f"tick_rank_red_ecn captured, t {tt}", g_fused,
             rank_red_plain(port, enq, unif, q_tail, tt, NP_))
        same(f"tick_draws captured, t {tt}", g_draws,
             ref.tick_draws_reference(key, t_dev, n_flows=F, n_cand=M))
    del graph

    # ---- tick_draws: the tick's keys and both draws at the engine's
    # (F, M), ragged sizes, ticks and seeds up to 2**31 - 1
    err = 0.0
    for seed, tt, f, m in ((0, 0, F, M), (0, 513, F, M), (7, 70000, F, M),
                           (2**31 - 1, 2**31 - 1, F, M), (5, 3, 1, 0),
                           (5, 3, 0, 7), (9, 11, 300, 1)):
        key = cu(np.array([0, seed]), torch.int64)
        t_dev = torch.tensor(tt, dtype=i32, device=dev)
        err = max(err, same(f"tick_draws seed {seed} t {tt} F {f} M {m}",
                            ops.tick_draws(key, t_dev, n_flows=f, n_cand=m),
                            ref.tick_draws_reference(key, t_dev, n_flows=f,
                                                     n_cand=m)))
    key = cu(np.array([0, 0]), torch.int64)
    t_dev = torch.tensor(70000, dtype=i32, device=dev)
    outs = ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)
    out["tick_draws"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.tick_draws(key, t_dev, n_flows=F, n_cand=M)),
        plain_ms=time_ms(lambda: ref.tick_draws_reference(
            key, t_dev, n_flows=F, n_cand=M)),
        library_ms=None, bytes=nbytes(key, t_dev, *outs),
        device_us=device_us(lambda: ops.tick_draws(key, t_dev, n_flows=F,
                                                   n_cand=M),
                            torch, what="tick_draws"))

    # ---- spritz_select: Eq.-1-like rows, zero rows, wide dynamic range
    thr = shapes["explore_threshold"]

    def sel_inputs(f, p, explore_all=False, wide=False, u_edge=None):
        w = rng.random((f, p)).astype(np.float32) * 7.0 + 1.0
        if wide:
            w = np.exp(rng.normal(0, 6, (f, p))).astype(np.float32)
        npaths = rng.integers(1, p + 1, f)
        w[np.arange(p)[None, :] >= npaths[:, None]] = 0.0
        w[rng.integers(0, f, 5)] = 0.0
        u = rng.random(f).astype(np.float32)
        if u_edge is not None:      # u = 0, or just below 1 (the total)
            u[:] = u_edge
        front = rng.integers(-1, p, f)
        count = (np.full(f, thr) if explore_all
                 else rng.integers(0, 2 * thr, f))
        return (cu(w, f32), cu(u, f32), cu(front, i32), cu(count, i32))

    err = 0.0
    below_one = np.nextafter(np.float32(1), np.float32(0))
    for f, p, ex, wide, ue in (
            (F, P, False, False, None), (F, P, True, False, None),
            (F, P, True, True, None), (1000, 37, True, True, None),
            (33, 1, True, False, None), (257, 200, True, True, None),
            (300, 16, True, True, None), (300, 17, True, True, None),
            (300, 256, True, True, None), (F, P, True, True, 0.0),
            (F, P, True, True, below_one), (300, 17, True, True, 0.0),
            (300, 256, True, True, below_one)):
        args = sel_inputs(f, p, ex, wide, ue)
        err = max(err, same(f"spritz_select F {f} P {p} u {ue}",
                            ops.spritz_select(*args, explore_threshold=thr),
                            ref.spritz_select_reference(
                                *args, explore_threshold=thr)))
    args = sel_inputs(F, P)
    outs = ops.spritz_select(*args, explore_threshold=thr)
    out["spritz_select"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.spritz_select(*args, explore_threshold=thr)),
        plain_ms=time_ms(lambda: ref.spritz_select_reference(
            *args, explore_threshold=thr)),
        library_ms=None, bytes=nbytes(*args, *outs),
        device_us=device_us(lambda: ops.spritz_select(
            *args, explore_threshold=thr), torch, what="spritz_select"))
    # the main path's numbers are the in-place forms'; the forms given
    # the uniforms keep theirs as given_ms / given_device_us
    for name, v in check_draws_in_place(ops, ref, torch, np, shapes, cu,
                                        same, rank_red_plain, sel_inputs,
                                        kw).items():
        given = out.get(name)
        if given:
            v = {**given, **v, "given_ms": given["ms"],
                 "given_device_us": given["device_us"],
                 "max_abs_err": max(given["max_abs_err"], v["max_abs_err"])}
        out[name] = v
    return out


# the schemes that sample a weighted path per packet through
# ops.weighted_sample (one launch a replay)
SAMPLERS = ("valiant", "ugal_l", "flicr_w", "ops_u", "ops_w", "reps")


def check_draws_in_place(ops, ref, torch, np, shapes, cu, same,
                         rank_red_plain, sel_inputs, kw) -> dict:
    """Phase 3, the draws made in place: the fused rank + RED/ECN launch
    with ``rng=``, ``spritz_select`` with ``rng=`` and ``weighted_sample``
    against the two-step form (tick_draws' plain version, then the
    consumer's plain version) at the DF-1056 (F, M), ragged sizes, ticks
    0 and 2**31 - 1 and several seeds, and a CUDA graph of the three
    replayed at three ticks; each ``torch.equal``.  Returns each one's
    numbers (the main path's form), with the device time of its two-step
    form on the card (a tick_draws launch, then the consumer's launch on
    the drawn uniforms; the weighted sample's torch form, as the engine
    ran it before, beside it)."""
    from repro_torch.net.policies.base import weighted_sample_rows
    F, M, NP_, P = (shapes[k] for k in ("F", "M", "n_ports", "P"))
    thr = shapes["explore_threshold"]
    i32 = torch.int32
    gen = np.random.default_rng(29)

    def key(seed):
        return cu(np.array([0, seed]), torch.int64)

    def tick(t):
        return cu(np.int64(t), i32).reshape(())

    def draws(k, t, f, m):
        return ref.tick_draws_reference(k, t, n_flows=f, n_cand=m)

    band = int(kw["kmax"]) + 40     # tails give occupancies across RED's

    def fused_inputs(m, n, t):
        port = cu(gen.integers(-1, n + 2, m), i32)
        t0 = min(t, 2**31 - 1 - band)                 # no int32 overflow
        return port, port < n, cu(t0 + gen.integers(-40, band, n), i32)

    def weights(f, p):
        w = np.exp(gen.normal(0, 4, (f, p))) * (gen.random((f, p)) < 0.7)
        w[gen.integers(0, f, 2)] = 0.0
        return cu(w, torch.float32)

    err = {"tick_rank_red_ecn": 0.0, "spritz_select": 0.0,
           "weighted_sample": 0.0}
    cases = [(seed, tt, f, m, n) for seed in (0, 7, 2**31 - 1)
             for tt in (0, 2**31 - 1)
             for f, m, n in ((F, M, NP_), (300, 17, NP_), (1, 1, NP_))]
    cases += [(5, 70000, 33, 2000, 70000), (3, 40, 9, 0, NP_)]
    for seed, tt, f, m, n in cases:
        k, t = key(seed), tick(tt)
        u_path, unif = draws(k, t, f, m)
        port, enq, q = fused_inputs(m, n, tt)
        kwn = dict(kw, n_ports=n)
        label = f"seed {seed} t {tt} F {f} M {m} n_ports {n}"
        err["tick_rank_red_ecn"] = max(err["tick_rank_red_ecn"], same(
            f"tick_rank_red_ecn drawn in place, {label}",
            ops.tick_rank_red_ecn(port, enq, q_tail=q, t=t, rng=k, **kwn),
            rank_red_plain(port, enq, unif, q, t, n)))
        for p in (P, 17):
            w, _, front, count = sel_inputs(f, p, wide=True)
            err["spritz_select"] = max(err["spritz_select"], same(
                f"spritz_select drawn in place, {label} P {p}",
                ops.spritz_select(w, None, front, count,
                                  explore_threshold=thr, rng=k, t=t),
                ref.spritz_select_reference(w, u_path[:, 0], front, count,
                                            explore_threshold=thr)))
            w = weights(f, p)
            err["weighted_sample"] = max(err["weighted_sample"], same(
                f"weighted_sample, {label} P {p}",
                ops.weighted_sample(w, k, t),
                ref.weighted_sample_reference(w, k, t)))

    # a graph that captured the three reads each replay's tick
    k, t = key(11), tick(0)
    port, enq, q = fused_inputs(M, NP_, 70000)
    w, _, front, count = sel_inputs(F, P)
    ws = weights(F, P)

    def step():
        return (ops.tick_rank_red_ecn(port, enq, q_tail=q, t=t, rng=k, **kw),
                ops.spritz_select(w, None, front, count,
                                  explore_threshold=thr, rng=k, t=t),
                ops.weighted_sample(ws, k, t))
    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_fused, g_sel, g_ws = step()
    for tt in (69990, 70000, 2**31 - 1):
        t.fill_(tt)
        graph.replay()
        torch.cuda.synchronize()
        u_path, unif = draws(k, t, F, M)
        same(f"tick_rank_red_ecn drawn in place, captured, t {tt}", g_fused,
             rank_red_plain(port, enq, unif, q, t, NP_))
        same(f"spritz_select drawn in place, captured, t {tt}", g_sel,
             ref.spritz_select_reference(w, u_path[:, 0], front, count,
                                         explore_threshold=thr))
        same(f"weighted_sample captured, t {tt}", g_ws,
             ref.weighted_sample_reference(ws, k, t))
    del graph

    # times at the engine's shapes: the in-place form, its two-step form
    # (tick_draws, then the consumer on the drawn uniforms).  The fused
    # launch's work follows its data: the inputs above enqueue every
    # entry with most occupancies in the RED band (every entry draws),
    # the engine's tick enqueues ENGINE_ENQ of M, first (the compaction's
    # order), and ENGINE_BAND of them fall in the band
    # (tools/red_band_entries.py, a CPU count of phase 4's run); the
    # fused launch is timed on both, the engine's first
    t = tick(70000)
    worst = (port, enq, q)
    kmin = int(kw["kmin"])
    n_enq = min(ENGINE_ENQ, M)
    e_port = cu(np.concatenate([gen.integers(0, NP_, n_enq),
                                np.full(M - n_enq, NP_)]), i32)
    band = gen.random(NP_) < ENGINE_BAND / ENGINE_ENQ
    e_q = cu(70000 + np.where(band, gen.integers(kmin + 1, band_top(kw),
                                                 NP_),
                              gen.integers(-40, kmin // 2 + 1, NP_)), i32)
    port, enq, q = e_port, e_port < NP_, e_q
    out = {}
    fused = lambda: ops.tick_rank_red_ecn(port, enq, q_tail=q, t=t, rng=k,
                                          **kw)
    fused_two = lambda: ops.tick_rank_red_ecn(
        port, enq, ops.tick_draws(k, t, n_flows=0, n_cand=M)[1], q, t, **kw)
    sel = lambda: ops.spritz_select(w, None, front, count,
                                    explore_threshold=thr, rng=k, t=t)
    sel_two = lambda: ops.spritz_select(
        w, ops.tick_draws(k, t, n_flows=F, n_cand=0)[0][:, 0], front,
        count, explore_threshold=thr)
    wsm = lambda: ops.weighted_sample(ws, k, t)
    ws_two = lambda: weighted_sample_rows(
        ops.tick_draws(k, t, n_flows=F, n_cand=0)[0], ws)
    for name, one, two, plain, ins, outs in (
            ("tick_rank_red_ecn", fused, fused_two,
             lambda: rank_red_plain(port, enq, draws(k, t, 0, M)[1], q, t,
                                    NP_),
             (port, enq, q, k, t), fused()),
            ("spritz_select", sel, sel_two,
             lambda: ref.spritz_select_reference(
                 w, draws(k, t, F, 0)[0][:, 0], front, count,
                 explore_threshold=thr),
             (w, front, count, k, t), sel()),
            ("weighted_sample", wsm, ws_two,
             lambda: ref.weighted_sample_reference(ws, k, t),
             (ws, k, t), (wsm(),))):
        out[name] = dict(
            max_abs_err=err[name], ms=time_ms(one), plain_ms=time_ms(plain),
            library_ms=None, bytes=nbytes(*ins, *outs),
            device_us=device_us(one, torch, what=f"{name} drawn in place"),
            two_step_ms=time_ms(two),
            two_step_device_us=device_us(two, torch,
                                         what=f"{name} two-step"))
    port, enq, q = worst                    # every entry enqueued, in band
    out["tick_rank_red_ecn"].update(
        every_entry_device_us=device_us(fused, torch,
                                        what="tick_rank_red_ecn every entry"),
        every_entry_two_step_device_us=device_us(
            fused_two, torch, what="tick_rank_red_ecn every entry two-step"))
    return out


# the engine's fused launch at DF-1056 (tools/red_band_entries.py on
# spritz_spray_w's phase-4 run, CPU count): entries enqueued a step, and
# of them in the RED band, both means rounded
ENGINE_ENQ, ENGINE_BAND = 970, 13


def band_top(kw) -> int:
    """The first occupancy at or past kmax (exclusive bound of the band)."""
    return int(kw["kmax"]) + 1


def check_model_kernels(ops, ref, torch, np, rwkv_smem,
                        dev="cuda") -> dict:
    """Phase 5: flash attention and chunked RWKV-6 against their plain
    versions on the card, with the tolerances of tests/test_kernels.py
    (2e-5 f32 and 5e-2 bf16 attention, 1e-4 RWKV-6).  ``rwkv_smem(C)`` is
    the RWKV-6 kernel's dynamic shared memory at chunk C."""
    rng = np.random.default_rng(1)
    F = torch.nn.functional

    def rand(shape, dtype=torch.float32, scale=1.0):
        return torch.as_tensor(rng.normal(0, scale, shape), dtype=dtype,
                               device=dev)

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    def sdpa(q, k, v, kw):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        Sq, Sk = q.shape[1], k.shape[1]
        if not kw["causal"] and not kw["sliding_window"]:
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True).transpose(1, 2)
        if kw["q_offset"] == 0 and Sq == Sk and not kw["sliding_window"]:
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        qpos = kw["q_offset"] + torch.arange(Sq, device=dev)[:, None]
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = (kpos <= qpos if kw["causal"] else
                torch.ones((Sq, Sk), dtype=torch.bool, device=dev))
        if kw["sliding_window"]:
            mask &= kpos > qpos - kw["sliding_window"]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)

    def sdpa_visible(q, k, v, kw):
        """SDPA over only the keys a decode row sees, [0, q_offset + 1)
        (all of them when not causal), unmasked: the same work as the
        split path's."""
        kend = (min(k.shape[1], kw["q_offset"] + 1) if kw["causal"]
                else k.shape[1])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kend],
                                                  v[:, :kend]))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True).transpose(1, 2)

    def bf16_errors(label, got, lib_out, q, k, v, kw):
        """Max and mean error of the kernel and of SDPA against the f32
        reference on the same (bf16) inputs.  The 5e-2 gate is about the
        size of a late row's output (std ~ sqrt(e / keys) ~ 0.07), so the
        kernel must also be within 2x of SDPA's own error: a wrong
        rescale or a dropped tile on the late rows fails here."""
        want32 = ref.mha_reference(q.float(), k.float(), v.float(), **kw)
        ek = (got.float() - want32).abs()
        es = (lib_out.float() - want32).abs()
        e = dict(max=float(ek.max()), mean=float(ek.mean()),
                 sdpa_max=float(es.max()), sdpa_mean=float(es.mean()))
        if not (e["max"] <= 2 * e["sdpa_max"]
                and e["mean"] <= 2 * e["sdpa_mean"]):
            fail(f"flash_attention {label}: error against the f32 reference "
                 f"max {e['max']:.3g} mean {e['mean']:.3g} above 2x SDPA's "
                 f"(max {e['sdpa_max']:.3g}, mean {e['sdpa_mean']:.3g})")
        return e

    out = {}
    # ---- flash attention: the serving path's shapes, then ragged ones
    B, S, Hq, Hkv, D = 4, 1024, 40, 10, 128
    cases = [  # (label, Sq, Sk, B, Hq, Hkv, D, dtype, window, q_offset)
        # [, causal]: causal unless a case says otherwise
        ("prefill bf16", S, S, B, Hq, Hkv, D, torch.bfloat16, 0, 0),
        ("prefill bf16 D=64", S, S, B, Hq, Hkv, 64, torch.bfloat16, 0, 0),
        ("prefill f32", S, S, B, Hq, Hkv, D, torch.float32, 0, 0),
        ("decode bf16", 1, S, B, Hq, Hkv, D, torch.bfloat16, 0, 700),
        ("decode bf16 q_offset 63", 1, S, B, Hq, Hkv, D, torch.bfloat16, 0,
         63),
        ("decode f32", 1, S, B, Hq, Hkv, D, torch.float32, 0, 700),
        ("ragged Sk f32", 77, 333, 2, 8, 2, 64, torch.float32, 0, 256),
        ("Sq=1 Sk=1 f32", 1, 1, 3, 4, 4, 32, torch.float32, 0, 0),
        ("window 4096 f32", 8192, 8192, 1, 8, 2, 128, torch.float32, 4096,
         0),
        # phase 8's other serving shapes: LLaVA-NeXT-34B's 56 / 8 heads
        # (G = 7, so a 64-row tile splits a position's heads) over 576
        # patches + 1,024 tokens; DeepSeek-MoE-16B's 16 / 16 (G = 1);
        # Mixtral-8x7B's 32 / 8 with its 4,096 window cutting 1 x 4,608
        ("prefill bf16 56/8", 1600, 1600, 4, 56, 8, D, torch.bfloat16, 0,
         0),
        ("decode bf16 56/8", 1, S, B, 56, 8, D, torch.bfloat16, 0, 700),
        ("prefill bf16 16/16", S, S, B, 16, 16, D, torch.bfloat16, 0, 0),
        ("decode bf16 16/16", 1, S, B, 16, 16, D, torch.bfloat16, 0, 700),
        ("window 4096 bf16 32/8", 4608, 4608, 1, 32, 8, D, torch.bfloat16,
         4096, 0),
    ]
    # Jamba-1.5-Large's 64 / 8 heads; Whisper-small's 12 / 12 heads of 64:
    # its encoder over 1,500 frames and its cross-attention (prefill and
    # decode) to them, not causal, and its decoder's causal self-attention
    Te, St = WHISPER_FRAMES, WHISPER_TEXT
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        cases += [
            (f"prefill {name} 64/8", S, S, B, 64, 8, D, dt, 0, 0),
            (f"decode {name} 64/8", 1, S, B, 64, 8, D, dt, 0, 700),
            (f"whisper encoder {name}", Te, Te, B, 12, 12, 64, dt, 0, 0,
             False),
            (f"whisper decoder {name}", St, St, B, 12, 12, 64, dt, 0, 0),
            (f"whisper cross prefill {name}", St, Te, B, 12, 12, 64, dt, 0,
             0, False),
            (f"whisper cross decode {name}", 1, Te, B, 12, 12, 64, dt, 0, 0,
             False)]
    worst = 0.0
    for label, sq, sk, b, hq, hkv, d, dt, win, off, *nc in cases:
        causal = not nc or nc[0]
        q, k, v = rand((b, sq, hq, d), dt), rand((b, sk, hkv, d), dt), \
            rand((b, sk, hkv, d), dt)
        kw = dict(causal=causal, sliding_window=win, q_offset=off)
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, **kw)
        path = next(p for p, n in ops.FLASH_PATHS.items() if n)
        # the serving path's: split for a decode row, wgmma for bf16
        # prefill
        want_path = ("split" if sq == 1 else
                     "wgmma" if dt == torch.bfloat16 else path)
        if path != want_path:
            fail(f"flash_attention {label}: path {path}, want {want_path}")
        want = ref.mha_reference(q, k, v, **kw)
        if off == 0 and path != "split":
            # the forward a gradient is taken of: the same launch writing
            # the row log-sum-exp too must give the same o
            o2, lse = ops.flash_attention_lse(q, k, v, causal=causal,
                                              sliding_window=win)
            e_lse = err(lse, ref.mha_lse(q, k, causal=causal,
                                         sliding_window=win))
            if not torch.equal(o2, got) or e_lse > 1e-3:
                fail(f"flash_attention {label}: with the LSE pointer o "
                     f"equal {torch.equal(o2, got)}, LSE error {e_lse:.3g}")
            del o2, lse
        torch.cuda.synchronize()
        tol = 5e-2 if dt == torch.bfloat16 else 2e-5
        e = err(got, want)
        lib = sdpa(q, k, v, kw)
        lib_out = lib()
        e_lib = err(lib_out, want)
        if not (e <= tol and e_lib <= tol):
            fail(f"flash_attention {label}: max error {e:.3g} (SDPA "
                 f"{e_lib:.3g}) above {tol}")
        e32 = None
        if dt == torch.bfloat16:
            e32 = bf16_errors(label, got, lib_out, q, k, v, kw)
        del lib_out
        worst = max(worst, e)
        flops, nb = attention_work(q, k, causal=causal, window=win,
                                   q_offset=off)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        bms, by = bound_ms(flops, nb, kind)
        reps = 5 if sq >= 1024 else 50
        row = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                              reps=reps, warmup=2),
                   plain_ms=time_ms(lambda: ref.mha_reference(q, k, v, **kw),
                                    reps=reps, warmup=2),
                   library_ms=time_ms(lib, reps=reps, warmup=2),
                   flops=flops, bytes=nb, bound_ms=bms, bound_by=by,
                   max_abs_err=e, path=path)
        # device time alone: the wrapper times above are host-paced at
        # the decode shapes
        row["device_ms"] = device_us(
            lambda: ops.flash_attention(q, k, v, **kw), torch,
            max(reps, 20), what=f"flash_attention {label}") / 1e3
        row["library_device_ms"] = device_us(
            lib, torch, max(reps, 20),
            what=f"flash_attention {label} SDPA") / 1e3
        extra = ""
        if e32 is not None:
            row["f32_ref_err"] = e32
            extra += (f"; vs f32 reference: max {e32['max']:.3g} mean "
                      f"{e32['mean']:.3g}, SDPA max {e32['sdpa_max']:.3g} "
                      f"mean {e32['sdpa_mean']:.3g} (limit 2x SDPA)")
        if sq == 1 and not win:
            row["library_visible_device_ms"] = device_us(
                sdpa_visible(q, k, v, kw), torch, max(reps, 20),
                what=f"flash_attention {label} SDPA visible") / 1e3
            extra += (f"; SDPA on the visible keys alone, device "
                      f"{row['library_visible_device_ms']:.4f} ms")
        print(f"kernel flash_attention {label} {tuple(q.shape)} x "
              f"{tuple(k.shape)}{'' if causal else ' not causal'}: path "
              f"{path}; max err {e:.3g} (tol "
              f"{tol}), SDPA err "
              f"{e_lib:.3g}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms; "
              f"device: kernel {row['device_ms']:.4f} ms, SDPA "
              f"{row['library_device_ms']:.4f} ms; "
              f"{flops} FLOP, {nb} B, bound {bms:.4f} ms ({by}){extra}",
              flush=True)
        out[f"flash {label}"] = row
        del q, k, v, got, want
    out["flash_attention"] = dict(out["flash prefill bf16"],
                                  max_abs_err=worst)

    # ---- chunked RWKV-6: the prefill shape (chunk 16 and 64), strong decay
    def rwkv_inputs(b, s, h, lo, hi):
        r, k, v = (rand((b, s, h, 64), scale=0.5) for _ in range(3))
        w = torch.as_tensor(rng.uniform(lo, hi, (b, s, h, 64)),
                            dtype=torch.float32, device=dev)
        return r, k, v, w, rand((h, 64), scale=0.1), \
            rand((b, h, 64, 64), scale=0.1)

    worst = 0.0
    for label, (b, s, h, c, lo, hi) in (
            ("prefill chunk 16", (4, 1024, 64, 16, 0.7, 0.999)),
            ("prefill chunk 64", (4, 1024, 64, 64, 0.7, 0.999)),
            ("strong decay chunk 32", (1, 128, 1, 32, 0.3, 0.6))):
        ins = rwkv_inputs(b, s, h, lo, hi)
        y, sf = ops.rwkv6_chunked(*ins, chunk=c)
        y2, sf2 = ref.rwkv6_chunked_reference(*ins, chunk=c)
        torch.cuda.synchronize()
        e = max(err(y, y2), err(sf, sf2))
        if not (e <= 1e-4 and bool(torch.isfinite(y).all())):
            fail(f"rwkv6_chunked {label}: max error {e:.3g} above 1e-4")
        worst = max(worst, e)
        flops, nb = rwkv_flops(b, s, h, c), nbytes(*ins, y, sf)
        bms, by = bound_ms(flops, nb, "f32")
        row = dict(ms=time_ms(lambda: ops.rwkv6_chunked(*ins, chunk=c),
                              reps=20, warmup=2),
                   plain_ms=time_ms(lambda: ref.rwkv6_chunked_reference(
                       *ins, chunk=c), reps=5, warmup=1),
                   library_ms=None, flops=flops, bytes=nb, bound_ms=bms,
                   bound_by=by, max_abs_err=e, smem_bytes=rwkv_smem(c))
        row["device_ms"] = device_us(
            lambda: ops.rwkv6_chunked(*ins, chunk=c), torch, 20,
            what=f"rwkv6_chunked {label}") / 1e3
        print(f"kernel rwkv6_chunked {label} r {tuple(ins[0].shape)}: max "
              f"err {e:.3g} (tol 1e-4); kernel {row['ms']:.4f} ms, device "
              f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
              f"{flops} FLOP, {nb} B, bound {bms:.4f} ms ({by}); dynamic "
              f"shared memory {row['smem_bytes']} B a block", flush=True)
        out[f"rwkv {label}"] = row
    out["rwkv6_chunked"] = dict(out["rwkv prefill chunk 16"],
                                max_abs_err=worst)
    return out


TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "minicpm_2b", 8, 8, 2048
# phase 5b's cases whose backward must take the wgmma path
WGMMA_BWD_CASES = ("minicpm train bf16", "phi3 train bf16",
                   "whisper encoder bf16", "whisper cross bf16",
                   "whisper decoder bf16", "deepseek train bf16",
                   "jamba train bf16")


def check_attention_bwd(ops, ref, torch, np, ptxas: dict,
                        dev="cuda") -> dict:
    """Phase 5b (run after phase 8): attention's backward kernel
    (``ops.flash_attention_bwd``, two launches) against
    ``ref.mha_backward_reference`` on the card, on the forward kernel's
    own o and LSE: MiniCPM-2B's training shape as phase 9 trains it (8 x
    2,048, no microbatches, 36 / 36 heads of 64, causal) in bf16 and f32,
    Phi-3's 40 / 10 heads of 128 at 1 x 2,048, and small ragged,
    non-causal, windowed and Sq != Sk cases.  Each case's forward first:
    its LSE within 1e-3 of ``ref.mha_lse``, and its o equal to the
    serving launch's where both take the same path.  f32 within 1e-4 and
    bf16 within 5e-2 of the plain version, relative to each gradient's
    largest entry; bf16 also within 2x of SDPA's backward's max and mean
    error against the f32 plain backward.  Times: CUDA events and
    torch.profiler for the kernel, the plain version and SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention``, its forward outside the timing)."""
    rng = np.random.default_rng(8)
    F = torch.nn.functional

    def rand(shape, dtype):
        return torch.as_tensor(rng.normal(0, 1, shape), dtype=dtype,
                               device=dev)

    def rel(got, want):
        return max(float((g.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30)
                   for g, w in zip(got, want))

    def sdpa_bwd(q, k, v, do, causal, window):
        """A callable timing SDPA's backward alone, and its gradients."""
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        Sq, Sk = q.shape[1], k.shape[1]
        if window or (causal and Sq != Sk):
            qpos = torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(Sk, device=dev)[None, :]
            mask = (kpos <= qpos) if causal else torch.ones(
                (Sq, Sk), dtype=torch.bool, device=dev)
            if window:
                mask &= kpos > qpos - window
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
        dot = do.transpose(1, 2)

        def run():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        return run, tuple(g.transpose(1, 2) for g in run())

    ents = ptxas_entries(ptxas.get("flash_attention_bwd", ""))
    if not ents:
        fail("flash_attention_bwd: no ptxas report of its kernels")
    print("kernel flash_attention_bwd ptxas (registers / stack / spill "
          "bytes): " + ", ".join(
              f"{k} {v['registers']} / {v['stack_bytes']} / "
              f"{v['spill_bytes']}" for k, v in sorted(ents.items())),
          flush=True)
    wg = {k: v for k, v in ents.items() if "wgmma" in k}
    if len(wg) != 4 or any(v["spill_bytes"] or v["stack_bytes"]
                           for v in wg.values()):
        fail(f"flash_attention_bwd: the wgmma kernels (dQ and dK / dV at D "
             f"64 and 128) must neither spill nor keep a stack frame: {wg}")
    out = {}
    cases = [  # (label, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window)
        ("minicpm train bf16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 36, 36,
         64, torch.bfloat16, True, 0),
        ("minicpm train f32", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 36, 36, 64,
         torch.float32, True, 0),
        ("phi3 train bf16", 1, 2048, 2048, 40, 10, 128, torch.bfloat16,
         True, 0),
        ("ragged f32", 2, 77, 77, 8, 2, 64, torch.float32, True, 0),
        ("not causal Sq != Sk bf16", 2, 100, 300, 8, 2, 128,
         torch.bfloat16, False, 0),
        ("window 128 f32", 1, 512, 512, 8, 2, 64, torch.float32, True, 128),
        ("causal Sq < Sk f32", 1, 60, 200, 4, 4, 32, torch.float32, True,
         0),
        # the other families' training shapes (phase 9): Whisper-small's
        # encoder over 8 x 1,500 frames (ragged: 1,500 = 23 x 64 + 28) and
        # its cross-attention to them, not causal, and its causal decoder;
        # DeepSeek-MoE-16B's 16 / 16 heads of 128
        ("whisper encoder bf16", 8, WHISPER_FRAMES, WHISPER_FRAMES, 12, 12,
         64, torch.bfloat16, False, 0),
        ("whisper cross bf16", 8, WHISPER_TEXT, WHISPER_FRAMES, 12, 12, 64,
         torch.bfloat16, False, 0),
        ("whisper decoder bf16", 8, WHISPER_TEXT, WHISPER_TEXT, 12, 12, 64,
         torch.bfloat16, True, 0),
        ("deepseek train bf16", 4, 2048, 2048, 16, 16, 128, torch.bfloat16,
         True, 0),
        # Jamba-1.5-Large's 64 / 8 heads of 128 at phase 10c's batch
        ("jamba train bf16", HYBRID_PLAN["B"], HYBRID_PLAN["S"],
         HYBRID_PLAN["S"], 64, 8, 128, torch.bfloat16, True, 0),
    ]
    for label, b, sq, sk, hq, hkv, d, dt, causal, win in cases:
        q, k, v = rand((b, sq, hq, d), dt), rand((b, sk, hkv, d), dt), \
            rand((b, sk, hkv, d), dt)
        do = rand((b, sq, hq, d), dt)
        kw = dict(causal=causal, sliding_window=win)
        ops.reset_launches()
        o_serve = ops.flash_attention(q, k, v, **kw)
        serve_path = next(p for p, n in ops.FLASH_PATHS.items() if n)
        ops.reset_launches()
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
        lse_path = next(p for p, n in ops.FLASH_PATHS.items() if n)
        e_lse = float((lse - ref.mha_lse(q, k, **kw).float()).abs().max())
        same_o = serve_path != lse_path or torch.equal(o, o_serve)
        if not (e_lse <= 1e-3 and same_o):
            fail(f"flash_attention_lse {label}: LSE error {e_lse:.3g} (tol "
                 f"1e-3), o on the {lse_path} path equal to the serving "
                 f"launch's ({serve_path}) {same_o}")
        del o_serve
        ops.reset_launches()
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        bwd_path = next(p for p, n in ops.FLASH_BWD_PATHS.items() if n)
        if ops.LAUNCHES["flash_attention_bwd"] != 2 or \
                ops.FLASH_BWD_PATHS[bwd_path] != 2:
            fail(f"flash_attention_bwd {label}: launches {ops.LAUNCHES}, "
                 f"paths {ops.FLASH_BWD_PATHS}")
        if label in WGMMA_BWD_CASES and bwd_path != "wgmma":
            fail(f"flash_attention_bwd {label}: on the {bwd_path} path, "
                 f"not wgmma")
        if bwd_path != ops.flash_bwd_plan(b, sq, sk, hq, hkv, d, dt):
            fail(f"flash_attention_bwd {label}: on the {bwd_path} path, "
                 f"not flash_bwd_plan's")
        want = ref.mha_backward_reference(q, k, v, o, lse, do, **kw)
        e = rel(got, want)
        tol = 5e-2 if dt == torch.bfloat16 else 1e-4
        if not e <= tol or not all(bool(torch.isfinite(g).all())
                                   for g in got):
            fail(f"flash_attention_bwd {label}: relative error {e:.3g} "
                 f"above {tol}")
        lib_run, lib_got = sdpa_bwd(q, k, v, do, causal, win)
        extra = ""
        if dt == torch.bfloat16:
            qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
            o32 = ref.mha_reference(qf, kf, vf, **kw)
            want32 = ref.mha_backward_reference(
                qf, kf, vf, o32, ref.mha_lse(qf, kf, **kw), dof, **kw)
            ek = [(g.float() - w).abs() for g, w in zip(got, want32)]
            es = [(g.float() - w).abs() for g, w in zip(lib_got, want32)]
            for name, a, c in zip(("dq", "dk", "dv"), ek, es):
                if not (float(a.max()) <= 2 * float(c.max())
                        and float(a.mean()) <= 2 * float(c.mean())):
                    fail(f"flash_attention_bwd {label} {name}: error "
                         f"against the f32 backward max {float(a.max()):.3g}"
                         f" mean {float(a.mean()):.3g} above 2x SDPA's "
                         f"(max {float(c.max()):.3g}, mean "
                         f"{float(c.mean()):.3g})")
            extra = "; vs the f32 backward: " + ", ".join(
                f"{n} max {float(a.max()):.3g} (SDPA {float(c.max()):.3g}) "
                f"mean {float(a.mean()):.3g} (SDPA {float(c.mean()):.3g})"
                for n, a, c in zip(("dq", "dk", "dv"), ek, es))
            del o32, want32, ek, es
        flops, nb = attention_bwd_work(q, k, causal=causal, window=win)
        bms, by = bound_ms(flops, nb, "bf16" if dt == torch.bfloat16
                           else "f32")
        reps = 3 if sq * sk >= 500_000 else 20

        def kern():
            return ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        row = dict(ms=time_ms(kern, reps=reps, warmup=1),
                   plain_ms=time_ms(lambda: ref.mha_backward_reference(
                       q, k, v, o, lse, do, **kw), reps=reps, warmup=1),
                   library_ms=time_ms(lib_run, reps=reps, warmup=1),
                   flops=flops, bytes=nb, bound_ms=bms, bound_by=by,
                   max_abs_err=max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want)),
                   rel_err=e, path=bwd_path)
        row["device_ms"] = device_us(kern, torch, reps,
                                     what=f"flash_attention_bwd {label}") / 1e3
        row["library_device_ms"] = device_us(
            lib_run, torch, reps,
            what=f"flash_attention_bwd {label} SDPA") / 1e3
        print(f"kernel flash_attention_bwd {label} {tuple(q.shape)} x "
              f"{tuple(k.shape)}{'' if causal else ' not causal'}"
              f"{f' window {win}' if win else ''}: forward on the "
              f"{lse_path} path, LSE error {e_lse:.3g} (tol 1e-3), o "
              f"{'equal to' if serve_path == lse_path else 'not compared with'}"
              f" the serving launch's ({serve_path}); backward on the "
              f"{bwd_path} path, relative error {e:.3g} "
              f"(tol {tol}); kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, SDPA backward "
              f"{row['library_ms']:.4f} ms; device: kernel "
              f"{row['device_ms']:.4f} ms, SDPA backward "
              f"{row['library_device_ms']:.4f} ms; {flops} FLOP, {nb} B, "
              f"bound {bms:.4f} ms ({by}){extra}", flush=True)
        out[f"flash bwd {label}"] = row
        del q, k, v, do, o, lse, got, want, lib_run, lib_got
        gc.collect()
        torch.cuda.empty_cache()
    out["flash_attention_bwd"] = dict(
        out["flash bwd minicpm train bf16"],
        max_abs_err=max(r["max_abs_err"] for r in out.values()))
    return out


def check_rwkv_bwd(ops, ref, torch, np, ptxas: dict, smem, blocks,
                   dev="cuda") -> dict:
    """Phase 5b, RWKV-6: the chunked time mix's backward kernel
    (``ops.rwkv6_chunked_bwd``, one launch) against
    ``ref.rwkv6_chunked_backward_reference`` on the card, fed the forward
    kernel's own chunk-start states (``ops.rwkv6_chunked_states``, whose
    y must equal the serving launch's and whose states the plain ones
    within 1e-4): RWKV-6-7B's training shape as phase 9 trains it (4 x
    2,048, 64 heads of 64, f32, chunk 16, wkv0 zero), strong decay (w in
    [0.3, 0.6), chunk 32, as tests/test_torch_kernels.py builds it) and a
    non-zero wkv0 with a final state's gradient.  Every gradient within
    1e-4 of its largest entry, finite, and the same bits from a second
    launch.  Times: CUDA events and torch.profiler for the kernel and the
    plain version; no library call computes this function (the reference
    differentiates its plain chunked form with XLA).  ``smem(C)`` is the
    kernel's dynamic shared memory at chunk C, ``blocks(C)`` the blocks
    an SM holds (the occupancy calculator): the phase fails below 2 at
    chunk 16, or on a stack frame or spills at chunk 16 or 32."""
    rng = np.random.default_rng(27)
    ents = {}          # by the chunk its instantiation pads to, "CP16"
    for name, ent in ptxas_entries(ptxas.get("rwkv6_chunked_bwd",
                                             "")).items():
        m = re.search(r"rwkv6_chunked_bwd_kernelILi(\d+)E", name)
        if m:
            ents[f"CP{m.group(1)}"] = ent
    if not ents:
        fail("rwkv6_chunked_bwd: no ptxas report of its kernel")
    print("kernel rwkv6_chunked_bwd ptxas (registers / stack / spill "
          "bytes): " + ", ".join(
              f"{k} {v['registers']} / {v['stack_bytes']} / "
              f"{v['spill_bytes']}" for k, v in sorted(ents.items())),
          flush=True)
    if any(v["stack_bytes"] or v["spill_bytes"] for v in ents.values()):
        fail(f"rwkv6_chunked_bwd: a stack frame or spills: {ents}")
    resident = {cp: blocks(cp) for cp in (16, 32)}
    print("kernel rwkv6_chunked_bwd residency: " + ", ".join(
        f"CP{cp} {smem(cp)} B of dynamic shared memory a block, {nb} "
        f"blocks an SM" for cp, nb in resident.items()), flush=True)
    if resident[16] < 2:
        fail(f"rwkv6_chunked_bwd: {resident[16]} blocks an SM at chunk 16, "
             f"not 2")

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    out = {}
    for label, (b, s, h, c, lo, hi, s0, fin) in (
            ("rwkv6 train chunk 16", (4, 2048, 64, 16, 0.7, 0.999, 0.0,
                                      False)),
            ("strong decay chunk 32", (1, 128, 1, 32, 0.3, 0.6, 0.0, False)),
            ("wkv0 and d wkv_final chunk 16", (2, 256, 4, 16, 0.7, 0.999,
                                               0.1, True))):
        r, k, v = (t(rng.normal(0, 0.5, (b, s, h, 64))) for _ in range(3))
        w = t(rng.uniform(lo, hi, (b, s, h, 64)))
        u = t(rng.normal(0, 0.1, (h, 64)))
        wkv0 = t(rng.normal(0, s0, (b, h, 64, 64)))
        dy = t(rng.normal(0, 1, (b, s, h, 64)))
        dfin = t(rng.normal(0, 1, (b, h, 64, 64))) if fin else None
        y_serve, _ = ops.rwkv6_chunked(r, k, v, w, u, wkv0, chunk=c)
        y, _, states = ops.rwkv6_chunked_states(r, k, v, w, u, wkv0, chunk=c)
        _, _, want_states = ref.rwkv6_chunked_reference(
            r, k, v, w, u, wkv0, chunk=c, states=True)
        e_states = float((states - want_states).abs().max()) / max(
            float(want_states.abs().max()), 1e-30)
        if not (torch.equal(y, y_serve) and e_states <= 1e-4):
            fail(f"rwkv6_chunked {label}: with the states pointer y equal "
                 f"{torch.equal(y, y_serve)}, states error {e_states:.3g}")
        del y_serve, want_states
        ops.reset_launches()
        got = ops.rwkv6_chunked_bwd(r, k, v, w, u, states, dy, dfin, chunk=c)
        again = ops.rwkv6_chunked_bwd(r, k, v, w, u, states, dy, dfin,
                                      chunk=c)
        torch.cuda.synchronize()
        if ops.LAUNCHES["rwkv6_chunked_bwd"] != 2:
            fail(f"rwkv6_chunked_bwd {label}: launches {ops.LAUNCHES}")
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del again
        want = ref.rwkv6_chunked_backward_reference(r, k, v, w, u, states,
                                                    dy, dfin, chunk=c)
        names = ("dr", "dk", "dv", "dw", "du", "dwkv0")
        rels = {n: float((g - w_).abs().max())
                / max(float(w_.abs().max()), 1e-30)
                for n, g, w_ in zip(names, got, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (max(rels.values()) <= 1e-4 and finite and same):
            fail(f"rwkv6_chunked_bwd {label}: relative errors {rels}, "
                 f"finite {finite}, the same bits twice {same}")
        flops = rwkv_bwd_flops(b, s, h, c)
        ins = (r, k, v, w, u, states, dy) + (() if dfin is None else (dfin,))
        nb = nbytes(*ins, *got)
        bms, by = bound_ms(flops, nb, "f32")

        def kern():
            return ops.rwkv6_chunked_bwd(r, k, v, w, u, states, dy, dfin,
                                         chunk=c)
        reps = 5 if s >= 2048 else 20
        row = dict(ms=time_ms(kern, reps=reps, warmup=1),
                   plain_ms=time_ms(lambda: ref.rwkv6_chunked_backward_reference(
                       r, k, v, w, u, states, dy, dfin, chunk=c), reps=2,
                       warmup=1),
                   library_ms=None, flops=flops, bytes=nb, bound_ms=bms,
                   bound_by=by,
                   max_abs_err=max(float((g - w_).abs().max())
                                   for g, w_ in zip(got, want)),
                   rel_err=max(rels.values()), smem_bytes=smem(c),
                   blocks_per_sm=resident[16 if c <= 16 else 32])
        row["device_ms"] = device_us(kern, torch, reps,
                                     what=f"rwkv6_chunked_bwd {label}") / 1e3
        row["plain_device_ms"] = device_us(
            lambda: ref.rwkv6_chunked_backward_reference(
                r, k, v, w, u, states, dy, dfin, chunk=c), torch, 2,
            what=f"rwkv6_chunked_bwd {label} plain") / 1e3
        # the forward's cost of writing the states: its launch with the
        # pointer against the serving launch (null)
        fwd = ""
        if s >= 2048:
            for key, fn in (("fwd_device_ms", ops.rwkv6_chunked),
                            ("fwd_states_device_ms",
                             ops.rwkv6_chunked_states)):
                row[key] = device_us(
                    lambda fn=fn: fn(r, k, v, w, u, wkv0, chunk=c), torch,
                    reps, what=f"rwkv6_chunked {label} {key}") / 1e3
            fwd = (f"; the forward kernel on these inputs, device "
                   f"{row['fwd_device_ms']:.4f} ms, with its states "
                   f"{row['fwd_states_device_ms']:.4f} ms")
        print(f"kernel rwkv6_chunked_bwd {label} r {tuple(r.shape)}: "
              f"forward states error {e_states:.3g}, y equal to the serving "
              f"launch's; relative errors "
              + ", ".join(f"{n} {e:.3g}" for n, e in rels.items())
              + f" (tol 1e-4), the same bits twice; kernel {row['ms']:.4f} "
              f"ms, device {row['device_ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms, device "
              f"{row['plain_device_ms']:.4f} ms; library call none; "
              f"{flops} FLOP, {nb} B, bound {bms:.4f} ms ({by}); dynamic "
              f"shared memory {row['smem_bytes']} B a block, "
              f"{row['blocks_per_sm']} blocks an SM{fwd}", flush=True)
        out[f"rwkv bwd {label}"] = row
        del r, k, v, w, dy, states, got, want, ins
        gc.collect()
        torch.cuda.empty_cache()
    out["rwkv6_chunked_bwd"] = dict(
        out["rwkv bwd rwkv6 train chunk 16"],
        max_abs_err=max(r_["max_abs_err"] for r_ in out.values()),
        ptxas={k: (v["registers"], v["stack_bytes"], v["spill_bytes"])
               for k, v in ents.items()})
    return out


# phase 5b's Mamba scan cases at Jamba-1.5-Large's width (d_in 16,384,
# d_state 16): (label, B, S, E, h0 non-zero, the final state's gradient)
MAMBA_CASES = (("jamba train B1", 1, 2048, 16384, False, False),
               ("jamba train B2 h0 and dh_final", 2, 2048, 16384, True,
                True),
               ("ragged", 2, 77, 200, True, True),
               # the tiles' edges: S under one 16-token sub-tile, d_in 4
               # past a multiple of the blocks' 64 channels; B 3 with S not
               # a multiple of the sub-tile and d_in not a multiple of 4
               # (the 4-byte copies)
               ("short", 1, 5, 4100, True, True),
               ("B3 ragged", 3, 40, 130, True, False))
# the decays' largest ulp distance from exp of the rounded dt A (in f64)
# that phase 5b allows: expf's 2 ulp (the CUDA math library's bound)
MAMBA_DECAY_ULP = 2.0


def mamba_inputs(B, S, E, torch, np, rng, dev="cuda", h0=True,
                 dhT=True) -> tuple:
    """Phase 5b's scan inputs from ``rng``: (x, dt, A, Bm, Cm, h0, dy,
    dhT), dt a softplus and A -exp of log(1..16) with noise, as the
    model makes them; h0 zero and dhT None where not asked for."""
    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(0, scale, shape),
                               dtype=torch.float32, device=dev)
    x, Bm, Cm = rand(B, S, E), rand(B, S, 16), rand(B, S, 16)
    dt = torch.nn.functional.softplus(rand(B, S) - 1.0)
    A = -torch.exp(torch.log(torch.arange(
        1, 17, dtype=torch.float32, device=dev)).repeat(E, 1)
        + rand(E, 16, scale=0.2))
    h = rand(B, E, 16) if h0 else torch.zeros(B, E, 16, device=dev)
    dy = rand(B, S, E)
    return x, dt, A, Bm, Cm, h, dy, rand(B, E, 16) if dhT else None


def mamba_decay_ulps(ops, torch, np, dt, A) -> dict:
    """The forward kernel's decays exp(dt A) at S 1 (x 0, h0 1: the final
    state is the decay) for every dt of a case and A's first 256
    channels, against exp of the f32 product dt A taken in f64: the
    largest distance in ulp of the kernel's and of ``torch.exp`` on the
    card (outside ftz's range below 2**-126, which both flush or not)."""
    dev = dt.device
    d = dt.reshape(-1)
    a = A[:256].contiguous()
    R, E = d.numel(), a.shape[0]
    z = torch.zeros(R, 1, E, device=dev)
    zb = torch.zeros(R, 1, 16, device=dev)
    _, got = ops.mamba_scan(z, d.reshape(R, 1), a, zb, zb,
                            torch.ones(R, E, 16, device=dev))
    prod = d[:, None, None] * a[None]
    card = torch.exp(prod)
    want = np.exp(prod.double().cpu().numpy())
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    keep = want >= np.finfo(np.float32).tiny
    out = {}
    for name, t in (("kernel", got), ("torch.exp", card)):
        dist = np.abs(t.double().cpu().numpy() - want) / ulp
        out[name] = float(dist[keep].max())
    out["elements"] = int(keep.sum())
    return out


def check_mamba_scan(ops, ref, torch, np, ptxas: dict, blocks,
                     fwd_blocks, fwd_channels, dev="cuda") -> dict:
    """Phase 5b: the Mamba scan's kernels (``ops.mamba_scan_states``, the
    forward writing its checkpoint states, and ``ops.mamba_scan_bwd``)
    against ``ref.mamba_scan_reference`` and
    ``ref.mamba_scan_backward_reference`` on the card, f32, at Jamba's
    width (d_in 16,384, d_state 16) over 1 and 2 x 2,048 tokens, h0 zero
    and not, with and without a final state's gradient, and at a ragged
    size (S 77, d_in 200): y, the final state, the checkpoints and every
    gradient within 1e-4 of its largest entry; the same bits twice; the
    serving launch (no states) the same y; autograd through
    ``ops.mamba_scan`` one forward and one backward launch, the same
    gradients; the decays within ``MAMBA_DECAY_ULP`` of exp of the rounded
    dt A.  The kernels' ptxas registers, stack and spills (a stack frame or
    spills fail), the backward's blocks an SM (2 of 128 threads at least:
    its 64 KB of slots and its decays in registers), the forward's blocks
    an SM and its grid at B 1 resident in one wave, CUDA-event and
    profiler times of each kernel and plain version, and the bound
    (``work.mamba_scan_work``: exponentials at 16 a clock an SM)."""
    rng = np.random.default_rng(11)

    def rel(got, want):
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
    ents = ptxas_entries(ptxas.get("mamba_scan", ""))
    # the forward, the backward's scan and its sums: one instantiation each
    if len(ents) != 3:
        fail(f"mamba_scan: want 3 kernels in the ptxas report, got "
             f"{sorted(ents)}")
    if any(v["stack_bytes"] or v["spill_bytes"] for v in ents.values()):
        fail(f"mamba_scan: a stack frame or spills in the ptxas report: "
             f"{ents}")
    nblk, fblk, fch = blocks(), fwd_blocks(), fwd_channels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("kernel mamba_scan ptxas (registers / static shared memory / "
          "stack / spill bytes): " + ", ".join(
              f"{k} {v['registers']} / {v['smem_bytes']} / "
              f"{v['stack_bytes']} / {v['spill_bytes']}"
              for k, v in sorted(ents.items()))
          + f"; backward blocks an SM {nblk}; forward blocks an SM {fblk} "
          f"({fch} channels a block, {-(-16384 // fch)} blocks at B 1 on "
          f"{sms} SMs)", flush=True)
    if nblk < 2:
        fail(f"mamba_scan_bwd: {nblk} blocks an SM, want 2")
    if fblk < 1 or -(-16384 // fch) > fblk * sms:
        fail(f"mamba_scan: {fblk} forward blocks an SM of {fch} channels "
             f"do not hold Jamba's d_in 16,384 at B 1 in one wave")
    out = {}
    for label, B, S, E, h0z, fin in MAMBA_CASES:
        x, dt, A, Bm, Cm, h0, dy, dhT = mamba_inputs(
            B, S, E, torch, np, rng, dev, h0=h0z, dhT=fin)
        ins = (x, dt, A, Bm, Cm, h0)
        ops.reset_launches()
        y, hT, st = ops.mamba_scan_states(*ins)
        y2, hT2, st2 = ops.mamba_scan_states(*ins)
        y_serve, _ = ops.mamba_scan(*ins)
        got = ops.mamba_scan_bwd(*ins[:5], st, dy, dhT)
        again = ops.mamba_scan_bwd(*ins[:5], st, dy, dhT)
        torch.cuda.synchronize()
        if dict(ops.LAUNCHES, mamba_scan=0, mamba_scan_bwd=0) != \
                dict.fromkeys(ops.LAUNCHES, 0) or \
                (ops.LAUNCHES["mamba_scan"], ops.LAUNCHES["mamba_scan_bwd"]) \
                != (3, 2):
            fail(f"mamba_scan {label}: launches {ops.LAUNCHES}")
        same = (torch.equal(y, y2) and torch.equal(hT, hT2)
                and torch.equal(st, st2) and torch.equal(y, y_serve)
                and all(torch.equal(a, b) for a, b in zip(got, again)))
        with torch.no_grad():
            yr, hr, sr = ref.mamba_scan_reference(*ins, states=True)
            want = ref.mamba_scan_backward_reference(*ins, dy, dhT)
        errs = {"y": rel(y, yr), "hT": rel(hT, hr), "states": rel(st, sr)}
        errs.update({n: rel(g, w) for n, g, w in zip(
            ("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want)})
        abs_fwd = max(float((a - b).abs().max())
                      for a, b in ((y, yr), (hT, hr), (st, sr)))
        abs_bwd = max(float((a - b).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, hT, *got))
        # autograd through the wrapper: one launch each way
        leaves = [t.clone().requires_grad_(True) for t in ins]
        ops.reset_launches()
        ya, ha = ops.mamba_scan(*leaves)
        loss = (ya * dy).sum() + ((ha * dhT).sum() if fin else 0.0)
        auto = torch.autograd.grad(loss, leaves)
        auto_ok = (ops.LAUNCHES["mamba_scan"] == 1
                   and ops.LAUNCHES["mamba_scan_bwd"] == 1
                   and torch.equal(ya, y)
                   and all(torch.equal(a, b) for a, b in zip(auto, got)))
        worst = max(errs.values())
        if not (worst <= 1e-4 and same and finite and auto_ok):
            fail(f"mamba_scan {label}: relative errors {errs} (tol 1e-4), "
                 f"same bits twice {same}, finite {finite}, autograd one "
                 f"launch each way with the same gradients {auto_ok}")
        ulps = mamba_decay_ulps(ops, torch, np, dt, A)
        if ulps["kernel"] > MAMBA_DECAY_ULP:
            fail(f"mamba_scan {label}: decays {ulps['kernel']:.3g} ulp from "
                 f"exp of the rounded dt A (allowed {MAMBA_DECAY_ULP}; "
                 f"torch.exp on the card {ulps['torch.exp']:.3g})")
        del leaves, ya, ha, auto, loss, yr, hr, sr, want
        fwd_w = mamba_scan_work(B, S, E, 16)
        fst_w = mamba_scan_work(B, S, E, 16, states=True)
        bwd_w = mamba_scan_work(B, S, E, 16, backward=True)
        f_bound, f_by = mamba_scan_bound(*fwd_w)
        s_bound, _ = mamba_scan_bound(*fst_w)
        b_bound, b_by = mamba_scan_bound(*bwd_w)
        big = S >= 2048
        reps = 20 if big else 200
        t = {"fwd": time_ms(lambda: ops.mamba_scan(*ins), reps=reps),
             "fwd_states": time_ms(lambda: ops.mamba_scan_states(*ins),
                                   reps=reps),
             "bwd": time_ms(lambda: ops.mamba_scan_bwd(*ins[:5], st, dy,
                                                        dhT), reps=reps)}
        with torch.no_grad():      # warm: each ran once for the check
            t["plain_fwd"] = time_ms(
                lambda: ref.mamba_scan_reference(*ins), reps=1, warmup=0)
            t["plain_bwd"] = time_ms(
                lambda: ref.mamba_scan_backward_reference(*ins, dy, dhT),
                reps=1, warmup=0)
        dev_fwd = device_us(lambda: ops.mamba_scan(*ins), torch,
                            n=10 if big else 50,
                            what=f"mamba_scan {label}") / 1e3
        dev_bwd = device_us(lambda: ops.mamba_scan_bwd(*ins[:5], st, dy,
                                                        dhT), torch,
                            n=10 if big else 50,
                            what=f"mamba_scan_bwd {label}") / 1e3
        print(f"kernel mamba_scan {label} (B {B}, S {S}, d_in {E}, d_state "
              f"16, f32): y, final state, checkpoints and every gradient "
              f"within {worst:.3g} of the plain versions' largest entries "
              f"(tol 1e-4: {', '.join(f'{k} {v:.2g}' for k, v in errs.items())}"
              f"); the same bits twice; autograd one launch each way; "
              f"decays at most {ulps['kernel']:.3g} ulp from exp of the "
              f"rounded dt A in f64 (torch.exp on the card "
              f"{ulps['torch.exp']:.3g}; {ulps['elements']} decays). "
              f"Forward {t['fwd']:.4f} ms wrapper, {dev_fwd:.4f} device "
              f"({timed_by(f'mamba_scan {label}')}), with states "
              f"{t['fwd_states']:.4f}, plain {t['plain_fwd']:.2f}; bound "
              f"{f_bound:.4f} ms ({f_by}: {fwd_w[1]:.4g} exponentials, "
              f"{fwd_w[0]:.4g} FLOPs, {fwd_w[2]:.4g} B); backward "
              f"{t['bwd']:.4f} ms wrapper, {dev_bwd:.4f} device "
              f"({timed_by(f'mamba_scan_bwd {label}')}), plain "
              f"{t['plain_bwd']:.2f}; bound {b_bound:.4f} ms ({b_by}: "
              f"{bwd_w[1]:.4g} exponentials, {bwd_w[0]:.4g} FLOPs, "
              f"{bwd_w[2]:.4g} B)", flush=True)
        fwd_err = max(errs[k] for k in ("y", "hT", "states"))
        bwd_err = max(errs[k] for k in ("dx", "ddt", "dA", "dB", "dC",
                                        "dh0"))
        out[f"mamba {label}"] = dict(
            max_abs_err=abs_fwd, rel_err=fwd_err, ms=t["fwd"],
            decay_ulp=ulps["kernel"], torch_exp_ulp=ulps["torch.exp"],
            states_ms=t["fwd_states"], plain_ms=t["plain_fwd"],
            device_ms=dev_fwd, bound_ms=f_bound, states_bound_ms=s_bound,
            bound_by=f_by, library_ms=None)
        out[f"mamba bwd {label}"] = dict(
            max_abs_err=abs_bwd, rel_err=bwd_err, ms=t["bwd"],
            plain_ms=t["plain_bwd"], device_ms=dev_bwd, bound_ms=b_bound,
            bound_by=b_by, library_ms=None)
        del x, Bm, Cm, dt, A, h0, dy, dhT, ins, y, y2, hT, hT2, st, st2, \
            y_serve, got, again
        gc.collect()
        torch.cuda.empty_cache()
    main = out["mamba jamba train B1"]
    out["mamba_scan"] = dict(main)
    out["mamba_scan_bwd"] = dict(out["mamba bwd jamba train B1"])
    out["mamba_scan"]["ptxas"] = out["mamba_scan_bwd"]["ptxas"] = {
        k: {kk: v[kk] for kk in ("registers", "smem_bytes", "stack_bytes",
                                 "spill_bytes")} for k, v in ents.items()}
    out["mamba_scan_bwd"]["blocks_per_sm"] = nblk
    out["mamba_scan"]["blocks_per_sm"] = fblk
    return out


def moe_layers(model) -> list:
    return [blk.moe for blk in model.blocks
            if getattr(blk, "moe", None) is not None]


def prefix_of(cfg, B, torch, np, seed=4, device="cpu", Te=64) -> dict:
    """{} or, for the VLM, seeded patch embeddings [B, Np, d] under
    ``prefix_embed``; for the enc-dec family seeded frame embeddings
    [B, Te, d] under ``enc_frames``."""
    n = {"vlm": cfg.n_patches, "encdec": Te}.get(cfg.family)
    if n is None:
        return {}
    pe = np.random.default_rng(seed).normal(0, 1, (B, n, cfg.d_model))
    key = "prefix_embed" if cfg.family == "vlm" else "enc_frames"
    return {key: torch.as_tensor(pe, dtype=cfg.dtype, device=device)}


def frames_of(inputs: dict) -> dict:
    """The decode steps' share of ``prefix_of``'s inputs: the frames."""
    return {k: v for k, v in inputs.items() if k == "enc_frames"}


def moe_inputs(model) -> tuple[dict, list]:
    """Forward pre-hooks on the model's MoE layers: the dict holds, by
    layer, each one's input of its latest call.  Returns it and the hook
    handles (``remove`` them when done)."""
    seen, handles = {}, []
    for i, m in enumerate(moe_layers(model)):
        handles.append(m.register_forward_pre_hook(
            lambda mod, args, i=i: seen.__setitem__(i, args[0])))
    return seen, handles


def dispatch_of(m, x) -> dict:
    """MoE layer ``m``'s integer dispatch of input ``x`` [B, S, d], as its
    forward computes it: capacity, top-k experts, ``dst``, ``keep`` and
    the kept rows an expert."""
    from repro_torch.models import moe as MOE
    me = m.me
    xt = x.reshape(-1, x.shape[-1])
    cap = MOE.capacity(me.capacity_factor, me.top_k, xt.shape[0],
                       me.n_experts)
    _, dst, keep, _, counts, topi = MOE.local_dispatch(
        xt, MOE.route(xt, m.router), me.top_k, cap, me.n_experts)
    return dict(cap=cap, topi=topi, dst=dst, keep=keep, counts=counts)


def same_dispatch(cpu, gpu, seen, label, torch) -> int:
    """Each MoE layer's dispatch on the card of the input its ``cpu`` twin
    saw in the last call (``seen``, from ``moe_inputs``) must equal the
    CPU's.  Returns the number of (token, expert) assignments compared."""
    n = 0
    pairs = list(zip(moe_layers(cpu), moe_layers(gpu)))
    for i, x in seen.items():
        want = dispatch_of(pairs[i][0], x)
        got = dispatch_of(pairs[i][1], x.cuda())
        if got["cap"] != want["cap"]:
            fail(f"{label}: capacity {got['cap']} != {want['cap']}")
        for key in ("topi", "keep", "dst", "counts"):
            if not torch.equal(got[key].cpu(), want[key]):
                fail(f"{label}: MoE dispatch {key} on the card differs "
                     f"from the CPU's")
        n += want["keep"].numel()
    return n


def drop_stats(moes, seen, torch) -> dict:
    """The capacity drops of the MoE layers' latest call (inputs in
    ``seen``), and the per-expert demand behind them: the (token,
    expert) assignments each expert was asked for, against the
    capacity."""
    dropped = slots = over = 0
    ratios, worst = [], 0
    for i, x in seen.items():
        d = dispatch_of(moes[i], x)
        keep, E = d["keep"], moes[i].me.n_experts
        demand = torch.bincount(d["topi"].reshape(-1), minlength=E)
        dropped += int((~keep).sum())
        slots += keep.numel()
        over += int((demand > d["cap"]).sum())
        ratios.append(float(demand.max()) / float(demand.float().mean()))
        worst = max(worst, int(demand.max()))
        cap = d["cap"]
    ratios.sort()
    return dict(dropped=dropped, slots=slots, cap=cap, over=over,
                pairs=len(seen) * E, demand_mean=slots / len(seen) / E,
                demand_max=worst, ratio_median=ratios[len(ratios) // 2],
                ratio_max=ratios[-1])


def drop_text(st) -> str:
    return (f"capacity dropped {st['dropped']} of {st['slots']} (token, "
            f"expert) assignments ({100 * st['dropped'] / st['slots']:.3f} "
            f"%, capacity {st['cap']} an expert); per-expert demand mean "
            f"{st['demand_mean']:.1f}, max {st['demand_max']}, max/mean a "
            f"layer median {st['ratio_median']:.2f} max "
            f"{st['ratio_max']:.2f}; {st['over']} of {st['pairs']} (layer, "
            f"expert) pairs over capacity")


def card_vs_cpu(C, LM, step, torch, np) -> None:
    """Phase 6: the reduced configs in f32 on the card (kernels) and on
    the CPU (plain versions), same weights; prefill and 16 decode steps
    (the enc-dec family with seeded frames [2, 64, d] in each).
    Tolerance 1e-4: only summation orders differ (TF32 is off).  The MoE
    layers' dispatch must be equal on both for the same input."""
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(C.get_reduced(arch), dtype=torch.float32)
        cpu = LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
        gpu = copy.deepcopy(cpu).to("cuda")
        seen, hooks = moe_inputs(cpu)
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, 80)))
        prompt, gen = toks[:, :64], toks[:, 64:]
        pe = prefix_of(cfg, 2, torch, np)
        pe_gpu = {k: v.cuda() for k, v in pe.items()}
        errs = [float((step.make_prefill_step(gpu, 80)(
            {"tokens": prompt.cuda(), **pe_gpu}).cpu()
            - step.make_prefill_step(cpu, 80)({"tokens": prompt, **pe})
        ).abs().max())]
        lg, ag = gpu(prompt.cuda(), with_aux=True, **pe_gpu)
        lc, ac = cpu(prompt, with_aux=True, **pe)
        errs.append(float((lg.cpu() - lc).abs().max()))
        n_disp = same_dispatch(cpu, gpu, seen, f"{arch} reduced prefill",
                               torch)
        aux_err = abs(float(ag) - float(ac))
        cg, cc = gpu.init_cache(2, 80), cpu.init_cache(2, 80)
        sg, sc = step.make_serve_step(gpu), step.make_serve_step(cpu)
        fr, fr_gpu = frames_of(pe), frames_of(pe_gpu)
        for i in range(16):
            lg, cg = sg(cg, {"tokens": gen[:, i:i + 1].cuda(), **fr_gpu})
            lc, cc = sc(cc, {"tokens": gen[:, i:i + 1], **fr})
            errs.append(float((lg.cpu() - lc).abs().max()))
            n_disp += same_dispatch(cpu, gpu, seen,
                                    f"{arch} reduced decode {i}", torch)
        e = max(errs)
        if not (e <= 1e-4 and aux_err <= 1e-5 * max(abs(float(ac)), 1.0)):
            fail(f"{arch} reduced: card and CPU differ by {e:.3g} > 1e-4 "
                 f"(aux by {aux_err:.3g})")
        extra = (f"; MoE dispatch equal on {n_disp} (token, expert) "
                 f"assignments over {len(moe_layers(cpu))} layers, aux "
                 f"error {aux_err:.3g}" if moe_layers(cpu) else "")
        extra += "".join(f"; {k} {tuple(v.shape)}" for k, v in pe.items())
        print(f"card vs cpu {arch} reduced f32: prefill [2, 64] + 16 decode "
              f"steps, max logit error {e:.3g} (tol 1e-4){extra}",
              flush=True)
        for h in hooks:
            h.remove()
        del cpu, gpu, cg, cc


TRAIN_CARD_VS_CPU = ("minicpm_2b", "phi3_medium_14b", "llava_next_34b",
                     "deepseek_moe_16b", "whisper_small", "rwkv6_7b",
                     "jamba_1_5_large")


# phase 6b's CPU threads on every host (the one-card hosts' cores)
CPU_THREADS = 8


def train_card_vs_cpu(C, LM, step, optim, ops, torch, np) -> dict:
    """Phase 6b (run after phase 8): training, card against CPU.  Reduced
    MiniCPM, Phi-3, LLaVA, DeepSeek-MoE, Whisper (seeded frames [4, 64,
    d]), RWKV-6 and Jamba in f32 from the same weights: the loss and
    every gradient of ``make_loss_fn`` (attention's forward with its LSE
    and the backward kernel, the RWKV-6 time mix's forward with its
    chunk-start states and its backward kernel, the Mamba scan's forward
    with its checkpoints and its backward kernel, on the card; autograd
    through the plain versions on the CPU) within 1e-4, each gradient
    relative to its largest entry; every MoE layer's integer dispatch
    equal on both for the CPU layer's input; the reduced RWKV-6's
    launches: its forward kernel twice a layer (the forward and remat's
    recomputation) and its backward once, and the reduced Jamba's Mamba
    scan likewise a Mamba layer; then three train steps (the second with
    ``microbatch=2``), each from the CPU's state copied to the card:
    losses within 1e-4, and the parameters and ``m`` / ``v`` within 1e-4
    of each tensor's largest entry.  Before each step the gradient the
    step takes (with microbatches the mean of its shards') on the card
    equals the CPU's within 1e-4 of each tensor's largest entry, every
    element: that holds the kernels.  TF32 is off, so only summation
    orders differ; but Adam moves an element by about ``lr * g / (|g| +
    eps)``: where a step's gradient is within 1e-5 of zero (relative to
    its tensor's largest) and not 0 the two signs may differ, and where
    it is at most 100 x AdamW's ``eps`` a gap of ~1e-10 moves the step:
    such elements (from the CPU's gradient before each step; those of
    the second kind only where they are past the 1e-4 tolerance) are
    counted, at most 1 in 1,000 a step, and their parameters bounded by
    2 x the summed lr instead.  Such a flip moves a weight by ~lr, which
    would then reach every later gradient: hence each step's common
    start.  The reduced Jamba's ``dt_bias`` gradient is one sum over
    every token (of ``dt_bias.mean()``) whose terms cancel to ~1e-6, past
    f32's reach at 1e-4.  So for the hybrid each step is also taken by the
    port on the CPU in f64 (``yardstick.in_f64``, from the CPU's state and
    batch) and on the card through the plain versions
    (``yardstick.plain_versions``), and
    the ``dt_bias`` leaves are held against the f64 step: the kernel
    path's gradients within ``yardstick.dt_bias_tol`` of the plain versions' largest
    gradient gap to it so far, its parameters and moments (masked as
    above) within ``dt_bias_tol`` of the plain versions' largest state gap
    so far: the kernels may add no error of their own.  Both card paths
    repeat bit for bit (PORT.md), so the rule compares fixed numbers;
    the CPU runs ``CPU_THREADS`` threads on every host, so its steps, the
    card's starting points, are the same bits on every host too.  Every
    other tensor stays within 1e-4 of the CPU's f32 step.
    Returns the reduced Jamba's launches in its loss and gradient on the
    card."""
    from repro_torch.train import yardstick as Y

    rel = Y.rel_gap
    # the CPU's f32 sums split by thread, so its steps' bits (each step's
    # common start) follow the thread count: the same count on every host
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    # AdamW's eps (optim.adamw_update's default, as the step uses it)
    eps = inspect.signature(optim.adamw_update).parameters["eps"].default
    hybrid_counts = {}
    for arch in TRAIN_CARD_VS_CPU:
        cfg = dataclasses.replace(C.get_reduced(arch), dtype=torch.float32)
        cpu = LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
        gpu = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(6)

        def batch():
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 65)))
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if cfg.family == "vlm":
                b["prefix_embed"] = torch.as_tensor(rng.normal(
                    0, 0.02, (4, cfg.n_patches, cfg.d_model)),
                    dtype=torch.float32)
            if cfg.family == "encdec":
                b["enc_frames"] = torch.as_tensor(rng.normal(
                    0, 1, (4, 64, cfg.d_model)), dtype=torch.float32)
            return b, {k: v.cuda() for k, v in b.items()}
        loss_fn = step.make_loss_fn(cfg)
        bc, bg = batch()
        grads = []
        seen, hooks = moe_inputs(cpu)
        for model, b in ((cpu, bc), (gpu, bg)):
            model.requires_grad_(True)
            ops.reset_launches()
            loss, _ = loss_fn(model, b)
            named = dict(model.named_parameters())
            grads.append((float(loss.detach()), dict(zip(
                named, torch.autograd.grad(loss, list(named.values()))))))
        counts = {k: n for k, n in ops.LAUNCHES.items() if n}
        for h in hooks:
            h.remove()
        extra = ""
        if moe_layers(cpu):
            extra = (f"; MoE dispatch equal on "
                     f"{same_dispatch(cpu, gpu, seen, f'{arch} training', torch)}"
                     f" (token, expert) assignments over "
                     f"{len(moe_layers(cpu))} layers")
        if cfg.family == "rwkv":
            want = {"rwkv6_chunked": 2 * cfg.n_layers,
                    "rwkv6_chunked_bwd": cfg.n_layers}
            if counts != want:
                fail(f"{arch} reduced training: launches {counts}, want "
                     f"{want}")
            extra += f"; launches {counts}"
        if cfg.family == "hybrid":
            # the scan twice a Mamba layer (the forward and remat's
            # recomputation), its backward once
            n_m = sum(b.kind.startswith("mamba") for b in cpu.blocks)
            got = (counts.get("mamba_scan"), counts.get("mamba_scan_bwd"))
            if got != (2 * n_m, n_m):
                fail(f"{arch} reduced training: launches {counts}, want "
                     f"mamba_scan {2 * n_m} and mamba_scan_bwd {n_m}")
            extra += f"; launches {counts}"
            hybrid_counts = counts
        (lc, gc_), (lg, gg) = grads
        e_grad = max(rel(gg[n], g) for n, g in gc_.items())
        if not (abs(lg - lc) <= 1e-4 and e_grad <= 1e-4):
            fail(f"{arch} reduced training: loss {lg} vs {lc}, gradient "
                 f"error {e_grad:.3g} (tol 1e-4)")
        oc = optim.adamw_init(dict(cpu.named_parameters()))
        losses, lr_sum, e_state, n_near, near_gap = [], 0.0, 0.0, 0, 0.0
        n_moved, e_step_grad = 0, 0.0
        worst = worst_state = None
        g_ratio = s_ratio = 0.0     # worst error over its tolerance
        hybrid = cfg.family == "hybrid"
        # the plain versions' largest dt_bias gaps to the f64 step so far:
        # of the gradients, and of the parameters and moments
        plain_dt = {"grad": 0.0, "state": 0.0}
        kern_dt = dict(plain_dt)    # the kernel path's
        total = sum(p.numel() for p in cpu.parameters())
        for mb in (0, 2, 0):
            fn = step.make_train_step(cfg, warmup=1, total=3, microbatch=mb)
            bc, bg = batch()
            near, in_eps = {}, {}
            step_g = step.step_grads(loss_fn, cpu, bc, mb)
            for n, g in step_g.items():
                a = g.abs()
                near[n] = (a <= 1e-5 * a.max()) & (a > 0)
                in_eps[n] = (a <= 100 * eps) & (a > 0)
            # each step from one state: the card's model and AdamW state
            # copied from the CPU's (a near-zero gradient's flipped sign
            # moves a weight by ~lr, which would reach every later
            # gradient and moment)
            def on_card():
                return copy.deepcopy(cpu).to("cuda"), optim.AdamWState(
                    m={k: t.cuda() for k, t in oc.m.items()},
                    v={k: t.cuda() for k, t in oc.v.items()},
                    step=oc.step.cuda())
            if hybrid:
                m64, o64, b64 = Y.f64_copy(cpu, oc, bc)
                with Y.in_f64():
                    g64 = step.step_grads(loss_fn, m64, b64, mb)
                    o64 = fn.update(m64, o64, {n: g.clone() for n, g in
                                               g64.items()})[0]
                mp, op = on_card()
                with Y.plain_versions():
                    gp = step.step_grads(loss_fn, mp, bg, mb)
                plain_dt["grad"] = max(plain_dt["grad"],
                                       Y.dt_bias_gap(gp, g64))
                op = fn.update(mp, op, gp)[0]
            gpu, og = on_card()
            for n, g in step.step_grads(loss_fn, gpu, bg, mb).items():
                if hybrid and n.endswith(".dt_bias"):
                    e, tol = rel(g, g64[n]), Y.dt_bias_tol(plain_dt["grad"])
                    kern_dt["grad"] = max(kern_dt["grad"], e)
                else:
                    e, tol = rel(g, step_g[n]), 1e-4
                e_step_grad = max(e_step_grad, e)
                if e / tol > g_ratio:
                    g_ratio, worst = e / tol, (f"{n} before step "
                                               f"{len(losses) + 1}, {e:.3g} "
                                               f"against {tol:.3g}")
            cpu, oc, mc = fn(cpu, oc, bc)
            gpu, og, mg = fn(gpu, og, bg)
            losses.append(abs(float(mg["loss"]) - float(mc["loss"])))
            lr_sum += float(mc["lr"])
            own, mine = dict(gpu.named_parameters()), \
                dict(cpu.named_parameters())
            for n, p in cpu.named_parameters():
                # AdamW's eps regime joins the mask where it is past the
                # tolerance, so the bounds count only those
                past = torch.zeros_like(p, dtype=torch.bool)
                for g, w in ((own[n], p), (og.m[n], oc.m[n]),
                             (og.v[n], oc.v[n])):
                    past |= (g.detach().cpu() - w.detach()).abs() > \
                        1e-4 * w.detach().abs().max()
                near[n] = near[n] | (in_eps[n] & past)
            n_near = max(n_near, sum(int(m.sum()) for m in near.values()))

            def state_gap(params, st, exact, exact_st, n):
                return max(rel(params[n], exact[n], near[n]),
                           rel(st.m[n], exact_st.m[n], near[n]),
                           rel(st.v[n], exact_st.v[n], near[n]))
            if hybrid:
                p64, pp = dict(m64.named_parameters()), \
                    dict(mp.named_parameters())
                plain_dt["state"] = max(
                    [plain_dt["state"]] + [state_gap(pp, op, p64, o64, n)
                                           for n in pp
                                           if n.endswith(".dt_bias")])
            moved = 0
            for n, p in cpu.named_parameters():
                if near[n].any():
                    gap = (own[n].detach().cpu() - p.detach()).abs()
                    near_gap = max(near_gap, float(gap[near[n]].max()))
                    moved += int((gap[near[n]] > 1e-4 * float(mc["lr"]))
                                 .sum())
                if hybrid and n.endswith(".dt_bias"):
                    e = state_gap(own, og, p64, o64, n)
                    tol = Y.dt_bias_tol(plain_dt["state"])
                    kern_dt["state"] = max(kern_dt["state"], e)
                else:
                    e, tol = state_gap(own, og, mine, oc, n), 1e-4
                e_state = max(e_state, e)
                if e / tol > s_ratio:
                    s_ratio, worst_state = e / tol, (
                        f"{n} after step {len(losses)}, {e:.3g} against "
                        f"{tol:.3g}")
            n_moved = max(n_moved, moved)
        # the families of this slice hold about one near-zero gradient in
        # 1,000 at these widths (RWKV-6's reduced config on the CPU, tests/
        # test_torch_train_families.py): for them the 1 in 1,000 bounds
        # those of the elements that moved apart
        n_bound = n_near if arch in TRAIN_CARD_VS_CPU[:3] else n_moved
        if not (max(losses) <= 1e-4 and s_ratio <= 1 and g_ratio <= 1
                and n_bound <= total / 1000
                and near_gap <= 2 * lr_sum + 1e-4):
            fail(f"{arch} reduced training: 3 steps, loss gaps {losses}, "
                 f"each step's gradient {e_step_grad:.3g} (worst {worst}), "
                 f"relative parameter / moment error {e_state:.3g} (worst "
                 f"{worst_state}; tol 1e-4, the hybrid's dt_bias against "
                 f"the f64 step, twice the plain versions' gap where "
                 f"larger); up to {n_near} of "
                 f"{total} "
                 f"near-zero gradients a "
                 f"step moved up to {near_gap:.3g} (limit "
                 f"{2 * lr_sum + 1e-4:.3g})")
        hyb = ("" if not hybrid else
               f"; dt_bias against the f64 step: the kernels' gradients "
               f"{kern_dt['grad']:.6g}, parameters and m / v "
               f"{kern_dt['state']:.6g}, within twice the plain versions' "
               f"{plain_dt['grad']:.6g} and {plain_dt['state']:.6g}")
        print(f"card vs cpu {arch} reduced f32 training: loss {lg:.6f} "
              f"(CPU {lc:.6f}), relative gradient error {e_grad:.3g} over "
              f"{len(gc_)} tensors; 3 train steps (microbatch 0, 2, 0), "
              f"each from the CPU's state: gradients {e_step_grad:.3g} "
              f"unmasked, loss gaps {max(losses):.3g}, "
              f"parameters and m / v {e_state:.3g} of each tensor's largest "
              f"(tol 1e-4{hyb}; worst against its tolerance: {worst}, "
              f"{worst_state}); up to {n_near} of {total} elements a step with "
              f"a near-zero gradient, {n_moved} of them moved apart, by up "
              f"to {near_gap:.3g} "
              f"(limit {2 * lr_sum + 1e-4:.3g}){extra}", flush=True)
        del cpu, gpu, oc, og, grads, seen
    gc.collect()
    torch.cuda.empty_cache()
    torch.set_num_threads(threads)
    return hybrid_counts


# Prefill (flash at Sq = S, the chunked RWKV-6 kernel) against step-by-step
# decode (flash at Sq = 1 against the cache, the per-token recurrence):
# the same f32 arithmetic in another order (GEMMs of [B*S, d] against
# [B, d] rows, chunked against sequential RWKV sums), so the logits (up
# to ~8 at these widths) agree within a few 1e-5; a bf16 or TF32 product
# anywhere would move them by 1e-3 or more.
FULL_WIDTH_TOL = 2e-4


def prefill_vs_decode(C, LM, torch, np) -> None:
    """Phase 7: full published widths, depth cut to 2 layers (Whisper: 2
    decoder and 2 encoder layers over 1,500 seeded frames), f32.  The
    MoE archs run dropless (capacity factor = n_experts); LLaVA's patch
    embeddings go through the cache one row a step (``decode_embeds``)
    before the tokens."""
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(C.get_config(arch), n_layers=2,
                                  dtype=torch.float32)
        if cfg.n_enc_layers:
            cfg = dataclasses.replace(cfg, n_enc_layers=2)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        model = LM(cfg, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
        B, S = 2, 64
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (B, S)), device="cuda")
        pe = prefix_of(cfg, B, torch, np, device="cuda", Te=WHISPER_FRAMES)
        fr = frames_of(pe)
        full = model(toks, **pe)
        Np = cfg.n_patches if "prefix_embed" in pe else 0
        cache = model.init_cache(B, Np + S)
        e = 0.0
        for i in range(Np + S):
            if i < Np:
                lg, cache = model.decode_embeds(
                    pe["prefix_embed"][:, i:i + 1], cache)
            else:
                lg, cache = model.decode_step(toks[:, i - Np:i - Np + 1],
                                              cache, **fr)
            e = max(e, float((lg[:, 0] - full[:, i]).abs().max()))
        scale = float(full.abs().max())
        if not e <= FULL_WIDTH_TOL:
            fail(f"{arch} full width: prefill and decode differ by {e:.3g}")
        how = ((f", dropless (capacity factor {cfg.moe.capacity_factor})"
                if cfg.moe is not None else "")
               + (f", {Np} patch embeddings first" if Np else "")
               + "".join(f", {cfg.n_enc_layers} encoder layers over frames "
                         f"{tuple(v.shape)} in every step"
                         for v in fr.values()))
        print(f"prefill vs decode {arch} full width 2 layers f32: [{B}, {S}]"
              f"{how}, max logit error {e:.3g} (tol {FULL_WIDTH_TOL}; max "
              f"|logit| {scale:.3g})", flush=True)
        del model, full, cache
        gc.collect()
        torch.cuda.empty_cache()


def serve_path(arch, C, Server, step, ops, torch, np, card,
               profile=False, make_server=None, report=None) -> dict:
    """Phase 8: one published config in bf16 on the card (its depth cut
    only where ``SERVE_LAYERS`` says; ``make_server``, when given, builds
    the Server instead, phase 10a's padded model): prefill 4 x 1,024
    tokens (after 4 x Np patch embeddings for the VLM), then 8 requests
    through a 4-slot Server.  Launches are counted from just before the
    prefill to just after the last request.  ``profile`` then traces one
    prefill and 8 decode steps.  ``report``, when given, receives the
    decode ms/step, prefill tokens/s, peak GB and attention paths."""
    from repro_torch.launch.dryrun import placed_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cut = SERVE_LAYERS.get(arch)
    srv = (make_server() if make_server is not None else
           Server(arch, device="cuda", slots=4, max_len=1024,
                  reduced=False, seed=0, n_layers=cut))
    torch.cuda.synchronize()
    cfg = srv.cfg
    label = arch if cfg.head_maps is None else \
        f"{arch} (heads padded to {cfg.n_heads} / {cfg.n_kv})"
    n_params = sum(p.numel() for p in srv.model.parameters())
    depth = (f"{cfg.n_layers} of its {C.get_config(arch).n_layers} layers "
             f"(depth cut, widths published)" if cut else
             f"{cfg.n_layers} layers (whole)")
    print(f"serve {label}: {depth}, d_model {cfg.d_model}, "
          f"{n_params} parameters ({cfg.param_count():.4g} by "
          f"ModelCfg.param_count), {cfg.dtype}, initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1024)),
                              device="cuda")
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        gen_pe = torch.Generator(device="cuda").manual_seed(1)
        batch["prefix_embed"] = torch.randn(
            (4, cfg.n_patches, cfg.d_model), generator=gen_pe,
            dtype=cfg.dtype, device="cuda")
    positions = 4 * (1024 + cfg.n_patches)
    prefill = step.make_prefill_step(srv.model, 1024)
    kernel = SERVE_ARCHS[arch]
    moes = moe_layers(srv.model)

    torch.cuda.synchronize()
    ops.reset_launches()
    walls = []
    seen, hooks = moe_inputs(srv.model)
    for i in range(2):          # cold (its MoE inputs kept), then warm
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for h in hooks:
            h.remove()
        hooks = []
    if logits.shape != (4, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: prefill logits {tuple(logits.shape)} not finite")
    drops = ""
    if moes:
        drops = "; prefill " + drop_text(drop_stats(moes, seen, torch))
    seen.clear()
    prefill_paths = dict(ops.FLASH_PATHS)
    inner = srv.step

    def checked_step(cache, batch):
        lg, cache = inner(cache, batch)
        if not bool(torch.isfinite(lg).all()):
            fail(f"{arch}: decode logits not finite")
        return lg, cache
    srv.step = checked_step
    gen = 64
    want = {}
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
        srv.submit(rid, prompt, gen)
        want[rid] = gen + len(prompt)
    stats = srv.run()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    done = {r: len(t) for r, t in srv.done.items()}
    if stats["requests"] != 8 or done != want:
        fail(f"{arch}: requests not all answered: {done} != {want}")
    if counts[kernel] == 0:
        fail(f"{arch}: {kernel} never launched on the serving path: "
             f"{counts}")
    n_mamba = sum(b.kind.startswith("mamba") for b in srv.model.blocks)
    if counts["mamba_scan"] != 2 * n_mamba or counts["mamba_scan_bwd"]:
        fail(f"{arch}: mamba_scan launched {counts['mamba_scan']} times in "
             f"two prefills of {n_mamba} Mamba layers (want one a layer a "
             f"prefill), its backward {counts['mamba_scan_bwd']}")
    decode_paths = {p: n - prefill_paths[p]
                    for p, n in ops.FLASH_PATHS.items()}
    if kernel == "flash_attention" and not (
            prefill_paths["wgmma"] > 0 and decode_paths["split"] > 0 and
            sum(prefill_paths.values()) == prefill_paths["wgmma"] and
            sum(decode_paths.values()) == decode_paths["split"]):
        fail(f"{arch}: attention paths prefill {prefill_paths}, decode "
             f"{decode_paths}; want wgmma for the prefill and split for "
             f"the decode")
    tokens = sum(done.values())
    peak = torch.cuda.max_memory_allocated()
    prefix = (f" after 4 x {cfg.n_patches} patch embeddings"
              if cfg.n_patches else "")
    print(f"serve {label}: prefill 4 x 1024 tokens{prefix} in "
          f"{walls[0]:.3f} s cold, {walls[1]:.3f} s warm = "
          f"{4096 / walls[1]:.1f} tokens/s ({positions / walls[1]:.1f} "
          f"positions/s); decode {stats['steps']} steps, "
          f"{stats['ms_per_step']:.2f} ms/step, {tokens} tokens in "
          f"{stats['wall_s']:.3f} s = {tokens / stats['wall_s']:.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB; launches {counts}; "
          f"attention paths prefill {prefill_paths} decode {decode_paths}"
          f"{drops}; card {card}", flush=True)
    if report is not None:
        report.update(ms_per_step=stats["ms_per_step"], peak_gb=peak / 1e9,
                      prefill_tokens_s=4096 / walls[1],
                      prefill_paths=prefill_paths, decode_paths=decode_paths,
                      cfg=cfg, peak_bytes=peak,
                      static_bytes=placed_bytes(srv.model, cache=srv.cache)[
                          "placed_bytes"])
    if arch == "mixtral_8x7b":
        long_prefill(srv, prefill, cfg, ops, torch, np, card)
    if profile:
        profile_block(f"{label} prefill 4 x 1024", lambda: prefill(batch),
                      walls[1], torch, host_top=6)

        def decode8():
            for _ in range(8):
                lg, srv.cache = srv.step(srv.cache, {"tokens": srv.tokens})
                lg[:, -1, :cfg.vocab].argmax(-1).cpu()
        profile_block(f"{label} decode x 8", decode8,
                      8 * stats["ms_per_step"] / 1e3, torch, host_top=6)
        syncs = [host_syncs(lambda: prefill(batch), torch),
                 host_syncs(lambda: srv.step(
                     srv.cache, {"tokens": srv.tokens}), torch)]
        print(f"profile {label}: host syncs in one prefill {syncs[0]}; in "
              f"one decode step {syncs[1]}", flush=True)
    del srv, logits, prefill, inner, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_encdec(arch, C, Server, step, ops, torch, np, card,
                 profile=False, report=None) -> dict:
    """Phase 8 for the enc-dec family, which the ``Server`` refuses (the
    reference's passes no frames): the whole published config in bf16,
    4 x ``WHISPER_FRAMES`` seeded frame embeddings in place of the conv
    front end, a 4 x ``WHISPER_TEXT``-token prefill (cold, then warm),
    then 64 greedy decode steps of the serve step on 4 slots with the
    frames in every batch and a cache of ``WHISPER_TEXT``; the host reads
    each step's tokens, as the ``Server`` does.  Every decode step runs
    the encoder again (as the reference's does): its attention on the
    wgmma path, the decoder's self- and cross-attention on the split
    path."""
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.models.lm import LM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = C.get_config(arch)
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve {arch}: {cfg.n_layers} decoder and {cfg.n_enc_layers} "
          f"encoder layers (whole), d_model {cfg.d_model}, {n_params} "
          f"parameters ({cfg.param_count():.4g} by ModelCfg.param_count), "
          f"{cfg.dtype}, initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    Te, St, B = WHISPER_FRAMES, WHISPER_TEXT, 4
    frames = torch.randn((B, Te, cfg.d_model),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), dtype=cfg.dtype, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, St)), device="cuda")
    batch = {"tokens": prompts, "enc_frames": frames}
    prefill = step.make_prefill_step(model, St)
    torch.cuda.synchronize()
    ops.reset_launches()
    walls = []
    for _ in range(2):          # cold, then warm
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if logits.shape != (B, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: prefill logits {tuple(logits.shape)} not finite")
    prefill_paths = dict(ops.FLASH_PATHS)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    if prefill_paths != {"wgmma": 2 * n_attn, "split": 0, "simt": 0}:
        fail(f"{arch}: prefill attention paths {prefill_paths}; want "
             f"wgmma {2 * n_attn} (encoder, self- and cross-attention)")
    serve = step.make_serve_step(model)
    cache = model.init_cache(B, St)
    tok = prompts[:, :1]
    steps = 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = serve(cache, {"tokens": tok, "enc_frames": frames})
        if not bool(torch.isfinite(lg).all()):
            fail(f"{arch}: decode logits not finite")
        tok = lg[:, -1, :cfg.vocab].argmax(-1)[:, None]
        tok.cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    decode_paths = {p: n - prefill_paths[p]
                    for p, n in ops.FLASH_PATHS.items()}
    want = {"wgmma": steps * cfg.n_enc_layers,
            "split": steps * 2 * cfg.n_layers, "simt": 0}
    if decode_paths != want or cache["len"] != steps:
        fail(f"{arch}: decode attention paths {decode_paths} (want {want})"
             f", cache length {cache['len']}")
    peak = torch.cuda.max_memory_allocated()
    if report is not None:
        report.update(cfg=cfg, peak_bytes=peak,
                      static_bytes=placed_bytes(model, cache=cache)[
                          "placed_bytes"])
    ms = 1e3 * wall / steps
    print(f"serve {arch}: prefill {B} x {St} tokens over {B} x {Te} frames "
          f"in {walls[0]:.3f} s cold, {walls[1]:.3f} s warm = "
          f"{B * St / walls[1]:.1f} tokens/s ({B * (St + Te) / walls[1]:.1f}"
          f" positions/s); decode {steps} steps on {B} slots, the encoder "
          f"in each, {ms:.2f} ms/step, {B * steps} tokens in {wall:.3f} s = "
          f"{B * steps / wall:.1f} tokens/s; peak memory {peak / 1e9:.2f} "
          f"GB; launches {counts} ({sum(want.values()) // steps} attention "
          f"launches a decode step); attention paths prefill "
          f"{prefill_paths} decode {decode_paths}; card {card}", flush=True)
    if profile:
        profile_block(f"{arch} prefill {B} x {St}", lambda: prefill(batch),
                      walls[1], torch, host_top=6)

        def decode8():
            c = model.init_cache(B, St)
            t = prompts[:, :1]
            for _ in range(8):
                lg, c = serve(c, {"tokens": t, "enc_frames": frames})
                t = lg[:, -1, :cfg.vocab].argmax(-1)[:, None]
                t.cpu()
        profile_block(f"{arch} decode x 8", decode8, 8 * ms / 1e3, torch,
                      host_top=6)
    del model, cache, logits, lg, prefill, serve, batch, frames
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def by_kind(kern) -> dict:
    """Device ms of a profiled train step's kernels by kind: GEMMs, the
    port's attention and RWKV-6 kernels forward and backward, the
    backward of gathers (torch's ``indexing_backward_kernel``: the
    embedding's, the MoE's ``xt[slot_t]`` and ``flat[dst]``), the MoE
    dispatch's index and sort kernels, the rest."""
    cats = dict.fromkeys(("GEMM", "attention forward", "attention backward",
                          "rwkv6 forward", "rwkv6 backward",
                          "gather backward", "MoE dispatch", "other"), 0.0)
    for e in kern:
        key = e.key.lower()
        cat = ("attention backward" if "flash_bwd" in key else
               "attention forward" if "flash_" in key else
               "rwkv6 backward" if "rwkv6_chunked_bwd" in key else
               "rwkv6 forward" if "rwkv6_chunked" in key else
               "GEMM" if any(w in key for w in ("gemm", "xmma", "cutlass",
                                                "nvjet", "sm90_")) else
               "gather backward" if "indexing_backward" in key else
               "MoE dispatch" if any(w in key for w in (
                   "indexfunc", "index_add", "scatter", "sort", "radix",
                   "cummax", "scan")) else
               "other")
        cats[cat] += e.self_device_time_total / 1e3
    return {k: v for k, v in cats.items() if v or k in ("GEMM", "other")}


def train_path(C, TRAIN, STEP, OPT, ops, torch, np, card,
               profile=False) -> dict:
    """Phase 9: MiniCPM-2B whole (40 layers, bf16 weights, f32 moments)
    trained 8 steps of 8 x 2,048 tokens through
    ``repro_torch.launch.train.train`` on the card (WSD, remat, random
    weights from a seeded generator): every loss finite, the last below
    the first; per step attention's forward launches 2 x 40 times (the
    forward, then each block's recomputation), all on the wgmma path, and
    its backward 2 x 40 times (dQ, then dK / dV); nothing else of the
    port's kernels.  Then the restart check on the reduced MiniCPM: 6
    straight steps against 3 steps, a checkpoint and a resume to 6, the
    losses within 2e-4.  Launches are counted from just before the
    ``train`` call to just after it."""
    from repro_torch.launch.dryrun import placed_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = C.get_config(TRAIN_ARCH)
    L = cfg.n_layers
    stamps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    model, opt, losses = TRAIN.train(
        TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=1,
        device="cuda", on_step=lambda s, l: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = dict(ops.LAUNCHES), dict(ops.FLASH_PATHS)
    bwd_paths = dict(ops.FLASH_BWD_PATHS)
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    static = placed_bytes(model, opt)["placed_bytes"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"train {TRAIN_ARCH}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train {TRAIN_ARCH}: loss did not fall: {losses}")
    per = TRAIN_STEPS * 2 * L
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=per, flash_attention_bwd=per)
    if counts != want or paths != {"wgmma": per, "split": 0, "simt": 0} \
            or bwd_paths != {"wgmma": per, "simt": 0}:
        fail(f"train {TRAIN_ARCH}: launches {counts}, attention paths "
             f"{paths}, backward paths {bwd_paths}; want {want} on the "
             f"wgmma path")
    step_s = np.diff(stamps)[1:]           # steps 2.., warm
    warm = float(step_s.mean())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    q = torch.empty((TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.d_head),
                    device="meta")
    k = torch.empty((TRAIN_BATCH, TRAIN_SEQ, cfg.n_kv, cfg.d_head),
                    device="meta")
    attn_fwd, _ = attention_work(q, k, causal=True, window=0, q_offset=0)
    # model FLOPs: 6 N D over the weights that enter a product (not the
    # embedding table, a gather whose backward is a scatter-add; the
    # output head is a product and stays in), plus attention's forward
    # and its backward (2.5x the forward, as phase 5b's bound counts it);
    # remat's recomputed forward is not counted
    n_gemm = n_params - model.embed.numel()
    flops = 6 * n_gemm * tokens + 3.5 * attn_fwd * L
    print(f"train {TRAIN_ARCH}: {L} layers (whole), {n_params} parameters "
          f"bf16 (AdamW m / v f32), {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, WSD; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; first step "
          f"{stamps[0] - t0:.2f} s with the initialisation, steps "
          f"{', '.join(f'{x:.3f}' for x in np.diff(stamps))} s; warm "
          f"{warm * 1e3:.1f} ms/step = {tokens / warm:.1f} tokens/s, "
          f"{flops:.4g} model FLOP a step ({n_gemm} parameters in "
          f"products) = {flops / warm / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / warm / PEAK_FLOPS['bf16']:.1f} % of 989 TFLOP/s; "
          f"peak memory {peak / 1e9:.2f} GB; wall {wall:.1f} s; launches "
          f"{counts}; attention paths {paths}, backward paths {bwd_paths}; "
          f"card {card}", flush=True)
    if profile:
        data_b = {k2: torch.as_tensor(v, device="cuda") for k2, v in
                  TRAIN.TokenStream(TRAIN.DataCfg(
                      vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=7)).batch(0).items()}
        fn = STEP.make_train_step(cfg, schedule="wsd", total=TRAIN_STEPS,
                                  warmup=1)
        kern, n_launch, _ = profile_block(
            f"train {TRAIN_ARCH} step", lambda: fn(model, opt, data_b), warm,
            torch, top=10, host_top=6)
        cats = by_kind(kern)
        busy = sum(cats.values())
        print(f"profile train {TRAIN_ARCH} step by kind (device ms): "
              + ", ".join(f"{c} {v:.1f}" for c, v in cats.items())
              + f"; busy {busy:.1f} of {warm * 1e3:.1f} ms of unprofiled wall",
              flush=True)
        # the loss and the optimizer apart, on this run's tensors
        params = dict(model.named_parameters())
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        lr = torch.tensor(1e-5, device="cuda")
        t_opt = time_ms(lambda: OPT.adamw_update(params, dict(grads), opt, lr),
                        reps=2, warmup=1)
        logits = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_padded),
                             dtype=cfg.dtype, device="cuda",
                             requires_grad=True)

        def xent():
            loss = STEP.xent_loss(logits, data_b["labels"], cfg.vocab)
            return torch.autograd.grad(loss, logits)
        t_loss = time_ms(xent, reps=3, warmup=1)
        print(f"profile train {TRAIN_ARCH}: AdamW update {t_opt:.1f} ms, "
              f"loss forward + backward on the [{TRAIN_BATCH}, {TRAIN_SEQ}, "
              f"{cfg.vocab_padded}] logits {t_loss:.1f} ms (CUDA events)",
              flush=True)
        del grads, logits, params
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    import tempfile
    kw = dict(global_batch=4, seq_len=64, log_every=0, device="cuda")
    full = TRAIN.train(TRAIN_ARCH, steps=6, **kw)[2]
    with tempfile.TemporaryDirectory() as tmp:
        TRAIN.train(TRAIN_ARCH, steps=3, ckpt_dir=tmp, ckpt_every=3, **kw)
        resumed = TRAIN.train(TRAIN_ARCH, steps=6, ckpt_dir=tmp,
                              ckpt_every=100, **kw)[2]
    gaps = [abs(a - b) for a, b in zip(full[3:], resumed)]
    if len(resumed) != 3 or any(g > 2e-4 + 2e-4 * abs(b)
                                for g, b in zip(gaps, full[3:])):
        fail(f"train {TRAIN_ARCH} reduced restart: straight {full[3:]}, "
             f"resumed {resumed}")
    print(f"train {TRAIN_ARCH} reduced restart: 6 steps straight against 3 "
          f"+ a resume to 6: losses {', '.join(f'{x:.6f}' for x in full[3:])}"
          f" / {', '.join(f'{x:.6f}' for x in resumed)}, largest gap "
          f"{max(gaps):.3g} (tol 2e-4), bit-equal {full[3:] == resumed}",
          flush=True)
    return dict(counts=counts, bwd_paths=bwd_paths, warm_ms=warm * 1e3,
                tokens_s=tokens / warm,
                model_flops_share=flops / warm / PEAK_FLOPS["bf16"],
                peak_gb=peak / 1e9, losses=losses, peak_bytes=peak,
                static_bytes=static)


# phase 9's other families, at their published widths: arch -> (layers on
# the card, batch, sequence, frames).  Training holds 12 B a parameter
# (bf16 weights and gradients, f32 AdamW moments).  DeepSeek-MoE-16B's 28
# layers are 16.9 B parameters, ~203 GB; its first 4 (2.77 B, ~33 GB)
# fit the card.  RWKV-6-7B's 32 layers are 7.0 B, ~84 GB with no room for
# activations; its first 8 (~2.15 B, ~26 GB) fit.  Whisper-small
# (0.33 B) trains whole over its 1,500-frame window.
TRAIN_FAMILIES = {"whisper_small": (None, 8, WHISPER_TEXT, WHISPER_FRAMES),
                  "deepseek_moe_16b": (4, 4, 2048, 0),
                  "rwkv6_7b": (8, 4, 2048, 0)}


def train_family(arch, C, LM, STEP, OPT, TRAIN, ops, torch, np, card,
                 profile=False) -> dict:
    """Phase 9, the other families: ``arch`` at its published width and
    ``TRAIN_FAMILIES``' depth trained 8 steps on the card through
    ``make_train_step`` and AdamW as ``launch.train.train`` composes them
    (cosine, remat, warmup ``max(1, steps // 20)``, random weights from a
    seeded generator, batches from the data pipeline with seeded frames
    for the enc-dec family): every loss finite, the last below the first;
    exactly the port's kernels of the family's path launch, counted from
    the first step to the last: attention's forward twice an attention
    call a step (the forward, then remat's recomputation; the path
    ``flash_plan(grad=True)`` gives) and its backward twice (dQ, then
    dK / dV; ``flash_bwd_plan``'s path), or RWKV-6's forward twice a
    layer and its backward once.  ``profile`` adds one more step's device
    time by kind (``by_kind``)."""
    layers, B, S, Te = TRAIN_FAMILIES[arch]
    cfg = C.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = TRAIN.TokenStream(TRAIN.DataCfg(
        vocab=cfg.vocab, seq_len=S, global_batch=B, enc_frames=Te,
        d_model=cfg.d_model, seed=7))
    model = LM(cfg, device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(0))
    opt = OPT.adamw_init(dict(model.named_parameters()))
    fn = STEP.make_train_step(cfg, schedule="cosine", total=TRAIN_STEPS,
                              warmup=max(1, TRAIN_STEPS // 20))
    losses, stamps, host_s = [], [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t_b = time.perf_counter()
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(i).items()}
        host_s.append(time.perf_counter() - t_b)
        model, opt, m = fn(model, opt, batch)
        losses.append(float(m["loss"]))
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in ops.LAUNCHES.items() if n}
    paths = {k: n for k, n in ops.FLASH_PATHS.items() if n}
    bwd_paths = {k: n for k, n in ops.FLASH_BWD_PATHS.items() if n}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train {arch}: losses {losses}")
    # the attention calls of a step: (Sq, Sk, causal) each
    calls = ([(Te, Te, False)] * cfg.n_enc_layers
             + [(S, S, True), (S, Te, False)] * cfg.n_layers
             if cfg.family == "encdec" else
             [] if cfg.family == "rwkv" else [(S, S, True)] * cfg.n_layers)
    want, want_paths, want_bwd = {}, {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for sq, sk, causal in calls:
        fp = ops.flash_plan(B, sq, sk, cfg.n_heads, cfg.n_kv, cfg.d_head,
                            cfg.dtype, num_sms=sms, causal=causal,
                            grad=True)[0]
        bp = ops.flash_bwd_plan(B, sq, sk, cfg.n_heads, cfg.n_kv,
                                cfg.d_head, cfg.dtype)
        for d_, key in ((want, "flash_attention"),
                        (want, "flash_attention_bwd"), (want_paths, fp),
                        (want_bwd, bp)):
            d_[key] = d_.get(key, 0) + 2 * TRAIN_STEPS
    if cfg.family == "rwkv":
        want = {"rwkv6_chunked": 2 * cfg.n_layers * TRAIN_STEPS,
                "rwkv6_chunked_bwd": cfg.n_layers * TRAIN_STEPS}
    if counts != want or paths != want_paths or bwd_paths != want_bwd:
        fail(f"train {arch}: launches {counts}, attention paths {paths}, "
             f"backward paths {bwd_paths}; want {want}, {want_paths}, "
             f"{want_bwd}")
    warm = float(np.diff(stamps)[1:].mean())
    flops, n_gemm = family_flops(model, cfg, B, S, Te)
    depth = (f"{cfg.n_layers} + {cfg.n_enc_layers} layers (whole)"
             if cfg.family == "encdec" else
             f"{cfg.n_layers} of {C.get_config(arch).n_layers} layers")
    frames = f" over {B} x {Te} frames" if Te else ""
    print(f"train {arch}: {depth}, {n_params} parameters "
          f"{str(cfg.dtype).replace('torch.', '')} "
          f"(AdamW m / v f32), {TRAIN_STEPS} steps of {B} x {S} tokens"
          f"{frames}, cosine; losses {', '.join(f'{x:.4f}' for x in losses)}"
          f"; first step {stamps[0] - t0:.2f} s, steps "
          f"{', '.join(f'{x:.3f}' for x in np.diff(stamps))} s; warm "
          f"{warm * 1e3:.1f} ms/step = {B * S / warm:.1f} tokens/s (the "
          f"batch's draw and copy to the card "
          f"{1e3 * float(np.mean(host_s[1:])):.1f} ms of it), "
          f"{flops:.4g} model FLOP a step ({n_gemm} parameters in products, "
          f"MoE experts at their active share) = "
          f"{flops / warm / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / warm / PEAK_FLOPS['bf16']:.1f} % of 989 TFLOP/s; "
          f"peak memory {peak / 1e9:.2f} GB; wall {wall:.1f} s; launches "
          f"{counts}; attention paths {paths}, backward paths {bwd_paths}; "
          f"card {card}", flush=True)
    if profile:
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(0).items()}
        kern, _, _ = profile_block(f"train {arch} step",
                                   lambda: fn(model, opt, batch), warm,
                                   torch, top=8, host_top=4)
        cats = by_kind(kern)
        print(f"profile train {arch} step by kind (device ms): "
              + ", ".join(f"{c} {v:.1f}" for c, v in cats.items())
              + f"; busy {sum(cats.values()):.1f} of {warm * 1e3:.1f} ms of "
              f"unprofiled wall", flush=True)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, bwd_paths=bwd_paths, warm_ms=warm * 1e3,
                tokens_s=B * S / warm,
                model_flops_share=flops / warm / PEAK_FLOPS["bf16"],
                peak_gb=peak / 1e9, losses=losses)


def host_syncs(fn, torch) -> dict:
    """The synchronizing CUDA calls ``fn`` makes, by the line of the port
    that made them (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings
    torch.cuda.synchronize()
    where = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        key = f"{Path(w.filename).name}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return where


def long_prefill(srv, prefill, cfg, ops, torch, np, card) -> None:
    """One 1 x 4,608-token prefill, so that the sliding window (4,096 for
    Mixtral) cuts at full width; prints the attention path it took."""
    S = 4608
    if not 0 < cfg.sliding_window < S:
        fail(f"{cfg.name}: window {cfg.sliding_window} does not cut at {S}")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, S)), device="cuda")
    before = dict(ops.FLASH_PATHS)
    seen, hooks = moe_inputs(srv.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill({"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    paths = {p: n - before[p] for p, n in ops.FLASH_PATHS.items()}
    drops = drop_text(drop_stats(moe_layers(srv.model), seen, torch))
    seen.clear()
    if logits.shape != (1, 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name}: 1 x {S} prefill logits not finite")
    if paths["wgmma"] != cfg.n_layers or sum(paths.values()) != cfg.n_layers:
        fail(f"{cfg.name}: 1 x {S} prefill attention paths {paths}")
    print(f"serve {cfg.name}: prefill 1 x {S} tokens past the "
          f"{cfg.sliding_window}-token window in {wall:.3f} s (cold) = "
          f"{S / wall:.1f} tokens/s; attention paths {paths}; {drops}; "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}",
          flush=True)
    del logits


# Phase 10a: TP head alignment at Phi-3-medium-14B's published widths
# (40 / 10 heads padded for tp 16 to 64 / 16, 24 dead query heads)
ALIGN_ARCH, ALIGN_TP = "phi3_medium_14b", 16


def padded_server(C, LM, TA, Server, step, torch):
    """Phase 8's 4-slot ``Server`` holding ``ALIGN_ARCH`` whole with its
    heads padded for ``ALIGN_TP``: the Server is built at one layer, then
    its model, cache and serve step are replaced by the padded ``LM``
    drawn from the same seed on the card (``tp_align`` expands the exact
    model's draws)."""
    srv = Server(ALIGN_ARCH, device="cuda", slots=4, max_len=1024,
                 reduced=False, seed=0, n_layers=1)
    del srv.model, srv.cache, srv.step
    gc.collect()
    torch.cuda.empty_cache()
    srv.cfg = TA.aligned(C.get_config(ALIGN_ARCH), ALIGN_TP)
    srv.model = LM(srv.cfg, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    srv.cache = srv.model.init_cache(srv.slots, srv.max_len)
    srv.step = step.make_serve_step(srv.model)
    return srv


def tp_align_path(C, LM, TA, Server, step, ops, torch, np, card,
                  exact: dict | None, profile=False,
                  report: dict | None = None) -> dict:
    """Phase 10a, one card: the padded Phi-3 at 2 layers in f32 against
    the exact one from the same seed (prefill logits and 8 decode steps
    within phase 7's ``FULL_WIDTH_TOL``), then whole in bf16 through
    phase 8's serving path, its numbers beside phase 8's exact model's
    (``exact``; None when phase 8 did not run).  Returns the launches of
    the padded model's serving path; ``report``, when given, receives
    serve_path's report of the padded model."""
    base = dataclasses.replace(C.get_config(ALIGN_ARCH), n_layers=2,
                               dtype=torch.float32)
    pad = TA.aligned(base, ALIGN_TP)
    dead = sum(s < 0 for s in pad.head_maps[0])
    if (pad.n_heads, pad.n_kv, dead) != (64, 16, 24):
        fail(f"tp_align: {ALIGN_ARCH} at tp {ALIGN_TP} gave {pad.n_heads} / "
             f"{pad.n_kv} heads, {dead} dead; want 64 / 16, 24")
    models = [LM(c, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(0))
              for c in (base, pad)]
    B, S, steps = 2, 64, 8
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, base.vocab, (B, S)), device="cuda")
    with torch.no_grad():
        full = [m(toks) for m in models]
        caches = [m.init_cache(B, steps) for m in models]
        e_dec = 0.0
        for i in range(steps):
            lg = [m.decode_step(toks[:, i:i + 1], c)[0]
                  for m, c in zip(models, caches)]
            e_dec = max(e_dec, float((lg[1] - lg[0]).abs().max()))
    e_pre = float((full[1] - full[0]).abs().max())
    if not (e_pre <= FULL_WIDTH_TOL and e_dec <= FULL_WIDTH_TOL):
        fail(f"tp_align: padded {ALIGN_ARCH} differs from the exact model: "
             f"prefill {e_pre:.3g}, decode {e_dec:.3g}")
    print(f"tp_align {ALIGN_ARCH} 2 layers f32: {base.n_heads} / "
          f"{base.n_kv} heads padded for tp {ALIGN_TP} to {pad.n_heads} / "
          f"{pad.n_kv} ({dead} dead query heads); prefill [{B}, {S}] max "
          f"logit error {e_pre:.3g}, {steps} decode steps {e_dec:.3g} "
          f"against the exact model from the same seed (tol "
          f"{FULL_WIDTH_TOL}; max |logit| {float(full[0].abs().max()):.3g})",
          flush=True)
    del models, full, caches, lg
    gc.collect()
    torch.cuda.empty_cache()
    stats = {} if report is None else report
    counts = serve_path(ALIGN_ARCH, C, Server, step, ops, torch, np, card,
                        profile, report=stats, make_server=lambda:
                        padded_server(C, LM, TA, Server, step, torch))
    if exact:
        print(f"tp_align {ALIGN_ARCH} whole bf16, padded against exact "
              f"(phase 8, same call): decode {stats['ms_per_step']:.2f} "
              f"against {exact['ms_per_step']:.2f} ms/step, prefill "
              f"{stats['prefill_tokens_s']:.1f} against "
              f"{exact['prefill_tokens_s']:.1f} tokens/s, peak memory "
              f"{stats['peak_gb']:.2f} against {exact['peak_gb']:.2f} GB; "
              f"attention at {ALIGN_TP * 4} / {ALIGN_TP} heads: prefill "
              f"{stats['prefill_paths']}, decode {stats['decode_paths']}; "
              f"card {card}", flush=True)
    return counts


# Phase 10b: expert parallelism over NCCL, one rank a card, on up to four
# cards.  Each check's sizes, at the published widths; every rank holds
# one mesh and compares it with the one-card module it builds on its own
# card.
EP_PLAN = {
    # 1. the all-to-all path: DeepSeek-MoE-16B's layer (64 experts, d
    # 2,048, f 1,408, top 6, 2 shared), f32; ``skew`` adds a direction
    # every token shares, so that the config's capacity drops tokens
    "a2a": {"arch": "deepseek_moe_16b", "B": 2, "S": 256, "skew": 1.0},
    # 2. the f-split path at Mixtral's d 4,096 and f 14,336, with an
    # expert count the ranks do not divide (6 over 4, 3 over 2), f32
    "fshard": {"arch": "mixtral_8x7b", "B": 2, "S": 128, "skew": 1.0},
    # 3. Mixtral-8x7B at 4 of its 32 layers, bf16, on the mesh against
    # one card: the dropless prefill's logits and 8 decode steps
    "cut": {"arch": "mixtral_8x7b", "layers": 4, "B": 4, "S": 1024,
            "decode": 8},
    # 4. Mixtral-8x7B whole through phase 8's serving path
    "serve": {"arch": "mixtral_8x7b", "slots": 4, "max_len": 1024,
              "prompt": 1024, "requests": 8, "gen": 64},
}
EP_TOL_F32, EP_TOL_BF16 = 1e-5, 5e-2
EP_TIMEOUT_S = 600


def with_capacity(model, factor: float) -> None:
    """Every MoE layer of ``model`` at capacity factor ``factor``."""
    for m in moe_layers(model):
        m.me = dataclasses.replace(m.me, capacity_factor=factor)


def combine_in_f32(model, on: bool) -> None:
    """Every MoE layer of the one-card ``model`` combines its expert rows
    in f32, as the EP paths do (the reference's ``_apply_moe_ep*``), or,
    ``on`` false, casts its gates to the rows' dtype, as the dense path
    does.  In bf16 the two differ by an ulp in some outputs, and over
    layers that flips routing choices, so the mesh's prefill is held
    against the one-card model with its own rule."""
    for m in moe_layers(model):
        if on:
            m._dense = functools.partial(type(m)._dense, m, f32=True)
        else:
            m.__dict__.pop("_dense", None)


def ep_layer(cfg, p, mesh, dev, M, torch, say, sync) -> dict:
    """Checks 1 and 2: one MoE layer on the mesh against the same seed's
    one-card layer, dropless, and at the config's capacity factor against
    the plain per-rank oracle (``moe.ep_oracle`` on one card: output and
    aux): within ``EP_TOL_F32`` of the output's largest entry, and with
    whole experts dropless also absolutely."""
    me, W = cfg.moe, mesh.shape["model"]
    out = {"split": None}
    for label, cf in (("dropless", float(me.n_experts)),
                      ("own", me.capacity_factor)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            me, capacity_factor=cf))
        g = [torch.Generator(device=dev).manual_seed(s) for s in (0, 0, 1)]
        part = M.MoE(c, device=dev, generator=g[0], mesh=mesh)
        one = M.MoE(c, device=dev, generator=g[1])
        x = torch.randn((p["B"], p["S"], c.d_model), generator=g[2],
                        device=dev)
        x += p["skew"] * torch.randn(c.d_model, generator=g[2], device=dev)
        y, aux = part(x, with_aux=True)
        if label == "dropless":
            want, _ = one(x)
        else:
            want, want_aux = M.ep_oracle(one, x, 1, W)
            if me.n_shared:
                want = want + one.shared(x)
            out["aux_err"] = abs(float(aux) - float(want_aux))
        err = float((y - want).abs().max())
        scale = float(want.abs().max())
        xt = M.rank_tokens(x, mesh)
        cap = M.capacity(cf, me.top_k, xt.shape[0], me.n_experts)
        keep = M.local_dispatch(xt, M.route(xt, part.router), me.top_k,
                                cap, me.n_experts)[2]
        drops = torch.tensor([int((~keep).sum())], device=dev)
        torch.distributed.all_reduce(drops)
        times = []
        for fn in (lambda: part(x), lambda: one(x)):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            sync()
            times.append((time.perf_counter() - t0) / 3 * 1e3)
        out[label] = {"err": err, "scale": scale, "drops": int(drops),
                      "cap": cap, "mesh_ms": times[0], "one_ms": times[1]}
        out["split"], out["rows"] = part.split, list(part.w_gate.shape)
        # f32 GEMMs over other row sets (the oracle's blocks, the f
        # slices' partial sums) round apart by a few ulp of the largest
        # entry; dropless with whole experts each expert's GEMM has the
        # one card's rows, so the absolute bound holds there too
        exact = label == "dropless" and part.split == "experts"
        if err > EP_TOL_F32 * scale or (exact and err > EP_TOL_F32):
            raise RuntimeError(
                f"EP layer {cfg.name} {label} ({part.split}): max error "
                f"{err:.6g} from the one-card "
                f"{'layer' if label == 'dropless' else 'oracle'}, largest "
                f"entry {scale:.6g} (tol {EP_TOL_F32} of it"
                f"{', and absolute' if exact else ''})")
        del part, one, x, y, want
    if out["own"]["drops"] == 0:
        raise RuntimeError(f"EP layer {cfg.name}: the config's capacity "
                           f"dropped nothing; the check needs drops")
    if out["aux_err"] > 1e-6:
        raise RuntimeError(f"EP layer {cfg.name}: aux {out['aux_err']:.3g} "
                           f"from the oracle's")
    say(f"EP layer {cfg.name} ({cfg.moe.n_experts} experts, d "
        f"{cfg.d_model}, f {cfg.moe.d_ff_expert}, top {cfg.moe.top_k}) f32 "
        f"[{p['B']}, {p['S']}] on {W} ranks, experts split by "
        f"{out['split']} (rank block {out['rows']}): dropless max error "
        f"{out['dropless']['err']:.3g} against the one-card layer (largest "
        f"entry {out['dropless']['scale']:.3g}); capacity factor "
        f"{cfg.moe.capacity_factor} (cap {out['own']['cap']} a rank) "
        f"{out['own']['drops']} (token, expert) slots dropped over the "
        f"ranks, max error {out['own']['err']:.3g} (largest entry "
        f"{out['own']['scale']:.3g}) and aux error "
        f"{out['aux_err']:.3g} against the per-rank oracle; a layer "
        f"{out['own']['mesh_ms']:.3f} ms on the mesh, "
        f"{out['own']['one_ms']:.3f} ms on one card")
    return out


def ep_cut(p, get, mesh, dev, LM, torch, np, say) -> dict:
    """Check 3: the config at ``p["layers"]`` layers on the mesh against
    the same seed's one-card model on this rank's card.  Prefill
    (dropless): each MoE layer of the mesh against the one-card layer
    fed the mesh layer's own input (combining in f32 as the EP paths do,
    :func:`combine_in_f32`), within ``EP_TOL_BF16``.  The whole model's
    logits are printed beside it but not held: the router's f32 GEMM
    over 1/W of the rows rounds a few gates apart, the f32 combine keeps
    that as a bf16 ulp in a few outputs, and with random routers such an
    ulp flips near-tied top-2 choices in the layers after it, so the
    logits move by O(1).  Decode, at the config's capacity factor (every
    rank the global dispatch): logits within ``EP_TOL_BF16``."""
    cfg = dataclasses.replace(get(p["arch"]), n_layers=p["layers"])
    world = mesh.shape["model"]
    models = [LM(cfg, mesh=mesh,
                 generator=torch.Generator(device=dev).manual_seed(0)),
              LM(cfg, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(0))]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (p["B"], p["S"])), device=dev)
    for model in models:
        with_capacity(model, float(cfg.moe.n_experts))
    combine_in_f32(models[1], True)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0], out[0])))
        for m in moe_layers(models[0])]
    full = [model(toks) for model in models]
    for h in hooks:
        h.remove()
    e_layer = max(float((y - one(x)[0]).float().abs().max())
                  for (x, y), one in zip(seen, moe_layers(models[1])))
    combine_in_f32(models[1], False)
    e_pre = float((full[0].float() - full[1].float()).abs().max())
    scale = float(full[1].float().abs().max())
    del full, seen
    caches = []
    for model in models:
        with_capacity(model, cfg.moe.capacity_factor)
        caches.append(model.init_cache(p["B"], p["decode"]))
    e_dec = 0.0
    for i in range(p["decode"]):
        lg = [model.decode_step(toks[:, i:i + 1], c)[0]
              for model, c in zip(models, caches)]
        e_dec = max(e_dec, float((lg[0].float() - lg[1].float())
                                 .abs().max()))
    if not (e_layer <= EP_TOL_BF16 and e_dec <= EP_TOL_BF16):
        raise RuntimeError(f"{cfg.name} at {p['layers']} layers on the mesh "
                           f"against one card: an MoE layer on the same "
                           f"input {e_layer:.3g}, decode {e_dec:.3g}")
    say(f"{cfg.name} {p['layers']} of {get(p['arch']).n_layers} layers "
        f"{cfg.dtype} on {world} ranks against one card, same seed: "
        f"dropless prefill [{p['B']}, {p['S']}], each MoE layer against "
        f"the one-card layer on its input, max error {e_layer:.3g} (the "
        f"whole model's logits {e_pre:.3g} apart, largest {scale:.3g}, not "
        f"held); {p['decode']} decode steps at capacity "
        f"factor {cfg.moe.capacity_factor} {e_dec:.3g} (tol {EP_TOL_BF16})")
    return {"prefill_err": e_pre, "layer_err": e_layer,
            "decode_err": e_dec, "scale": scale}


def ep_rank(rank, world, init, out_dir, profile, plan, backend="nccl"):
    """One rank of phase 10b (spawned; rank 0 prints).  Its results go to
    ``out_dir/rank<r>.json``; any failure raises, so the rank exits
    non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models import moe as M
    from repro_torch.models.lm import LM
    from repro_torch.train import step as STEP

    on_card = backend == "nccl"
    kw = {}
    if on_card:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    mesh = make_mesh((1, world), ("data", "model"), backend=backend)
    dev = mesh.device
    get = C.get_reduced if plan.get("reduced") else C.get_config

    def say(msg):
        if rank == 0:
            print(f"phase 10b: {msg}", flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    res = {}
    with torch.no_grad():
        # 1-2. one layer, each EP path
        p = plan["a2a"]
        cfg = dataclasses.replace(get(p["arch"]), dtype=torch.float32)
        res["a2a"] = ep_layer(cfg, p, mesh, dev, M, torch, say, sync)
        p = plan["fshard"]
        cfg = get(p["arch"])
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  moe=dataclasses.replace(
                                      cfg.moe, n_experts=3 * world // 2))
        res["fshard"] = ep_layer(cfg, p, mesh, dev, M, torch, say, sync)
        if (res["a2a"]["split"], res["fshard"]["split"]) != ("experts", "f"):
            raise RuntimeError(f"EP paths taken: {res['a2a']['split']}, "
                               f"{res['fshard']['split']}")
        # 3. Mixtral at cut depth on the mesh against one card
        res["cut"] = ep_cut(plan["cut"], get, mesh, dev, LM, torch, np, say)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # 4. the whole model served over the mesh
        p = plan["serve"]
        t0 = time.perf_counter()
        srv = Server(p["arch"], slots=p["slots"], max_len=p["max_len"],
                     reduced=bool(plan.get("reduced")), seed=0, mesh=mesh)
        sync()
        cfg = srv.cfg
        n_local = sum(t.numel() for t in srv.model.parameters())
        static = placed_bytes(srv.model, cache=srv.cache)["placed_bytes"]
        init_s, init_gb = time.perf_counter() - t0, peak_gb()
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, (p["slots"], p["prompt"])), device=dev)}
        prefill = STEP.make_prefill_step(srv.model, p["max_len"])
        sync()
        ops.reset_launches()
        walls = []
        for _ in range(2):          # cold, then warm
            t0 = time.perf_counter()
            logits = prefill(batch)
            sync()
            walls.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("whole-model prefill logits not finite")
        want = {}
        for rid in range(p["requests"]):
            prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
            srv.submit(rid, prompt, p["gen"])
            want[rid] = p["gen"] + len(prompt)
        stats = srv.run()
        sync()
        counts = dict(ops.LAUNCHES)
        done = {r: len(t) for r, t in srv.done.items()}
        if done != want:
            raise RuntimeError(f"requests not all answered: {done}")
        n_tok = sum(done.values())
        res["serve"] = {
            "arch": cfg.name, "layers": cfg.n_layers, "world": world,
            "params_local": n_local, "init_s": init_s, "init_gb": init_gb,
            "prefill_s": walls, "prefill_tokens_s":
                p["slots"] * p["prompt"] / walls[1],
            "steps": stats["steps"], "ms_per_step": stats["ms_per_step"],
            "tokens_s": n_tok / stats["wall_s"], "peak_gb": peak_gb(),
            "peak_bytes": (torch.cuda.max_memory_allocated() if on_card
                           else 0), "static_bytes": static,
            "launches": counts, "flash_paths": dict(ops.FLASH_PATHS),
            "tokens": {str(r): t for r, t in srv.done.items()}}
        if profile and on_card:
            res["serve"]["collective_us"] = ep_collectives(
                prefill, batch, srv, torch)
        say(f"{cfg.name} whole ({cfg.n_layers} layers, {n_local} "
            f"parameters on this rank) served on {world} cards: prefill "
            f"{p['slots']} x {p['prompt']} in {walls[0]:.3f} s cold, "
            f"{walls[1]:.3f} s warm = {res['serve']['prefill_tokens_s']:.1f} "
            f"tokens/s; decode {stats['steps']} steps, "
            f"{stats['ms_per_step']:.2f} ms/step, "
            f"{res['serve']['tokens_s']:.1f} tokens/s; peak memory "
            f"{res['serve']['peak_gb']:.2f} GB on rank 0 (initialised in "
            f"{init_s:.1f} s, {init_gb:.2f} GB); launches {counts}")
        del srv, logits, prefill
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def ep_collectives(prefill, batch, srv, torch) -> dict:
    """The collectives of ``srv``'s model on its mesh, in us: (1) each
    collective of a layer alone at the step's shapes, through the MoE
    module's own helpers, every rank lined up by a barrier, 20
    back-to-back calls timed with CUDA events, and
    its count a step; then (2) the NCCL kernels' device time in one warm
    prefill and in 8 decode steps (a step's share), from torch.profiler
    on this rank: an NCCL kernel runs from its launch until every rank
    has joined, so this includes the waits on the other ranks."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import moe as M
    mesh, cfg = srv.model.mesh, srv.cfg
    moe = next(b.moe for b in srv.model.blocks if hasattr(b, "moe"))
    me, d, W = cfg.moe, cfg.d_model, mesh.shape["model"]
    group, layers = mesh.groups["model"], len(srv.model.blocks)
    B, S = batch["tokens"].shape
    cap_l = M.capacity(me.capacity_factor, me.top_k, B * S // W,
                       me.n_experts)
    cap_d = M.capacity(me.capacity_factor, me.top_k, srv.slots,
                       me.n_experts)

    def empty(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=mesh.device)
    buf, blk = empty(me.n_experts, cap_l, d), empty(B, S // W, d)
    if moe.split != "experts":
        raise RuntimeError(f"collective timings: experts split by "
                           f"{moe.split}; the served model splits them whole")
    dec = empty(moe.w_gate.shape[0], cap_d, d)
    calls = [("prefill all_to_all [E, cap, d]", 2,
              lambda: M._all_to_all(buf, group)),
             ("prefill all_gather of the output block", 1,
              lambda: M._all_gather(blk, dist.group.WORLD)),
             ("decode all_gather [E/W, cap, d]", 1,
              lambda: M._all_gather(dec, group))]
    out = {"alone": {}}
    for name, per_layer, fn in calls:
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        us = a.elapsed_time(b) / 20 * 1e3
        out["alone"][name] = {"us": us, "a_step": per_layer * layers}

    def decode8():
        for _ in range(8):
            lg, srv.cache = srv.step(srv.cache, {"tokens": srv.tokens})
            lg[:, -1, :srv.cfg.vocab].argmax(-1).cpu()
    for label, fn, n in (("prefill", lambda: prefill(batch), 1),
                         ("decode", decode8, 8)):
        if srv.cache["len"] + 8 >= srv.max_len:
            srv.cache = srv.model.init_cache(srv.slots, srv.max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        nccl = [e for e in kern if "nccl" in e.key.lower()]
        out[label] = {
            "nccl_us_a_step": sum(e.self_device_time_total
                                  for e in nccl) / n,
            "all_us_a_step": sum(e.self_device_time_total
                                 for e in kern) / n,
            "nccl_calls_a_step": sum(e.count for e in nccl) / n}
    return out


def ep_path(profile, card, torch, plan=EP_PLAN, backend="nccl",
            world=None) -> dict | None:
    """Phase 10b: spawn one rank a card (``ep_rank``) and wait for all of
    them, within ``EP_TIMEOUT_S``; a rank that exits non-zero, or a
    spawn past its time, fails the phase.  Every rank must give the same
    tokens.  Returns rank 0's results, or None with fewer than two
    cards."""
    import socket
    import tempfile
    if world is None:
        n = torch.cuda.device_count()
        world = 4 if n >= 4 else 2 if n >= 2 else 0
        if world == 0:
            print(f"phase 10b (expert parallelism over NCCL) did not run: "
                  f"{n} card{'s' if n != 1 else ''} visible, and NCCL needs "
                  f"one card a rank, so two or more", flush=True)
            return None
        gc.collect()
        torch.cuda.empty_cache()
    held = (f"; this process holds {torch.cuda.memory_reserved(0) / 1e9:.2f}"
            f" GB reserved on card 0 beside rank 0" if backend == "nccl"
            else "")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=ep_rank, args=(
            r, world, f"tcp://localhost:{port}", out_dir, profile, plan,
            backend)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + EP_TIMEOUT_S
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    fail(f"phase 10b: rank {bad[0]} exited with "
                         f"{procs[bad[0]].exitcode}")
                if time.monotonic() > deadline:
                    fail(f"phase 10b: ranks still running after "
                         f"{EP_TIMEOUT_S} s")
                time.sleep(0.5)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                fail(f"phase 10b: rank {bad[0]} exited with "
                     f"{procs[bad[0]].exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    toks = [r["serve"]["tokens"] for r in ranks]
    if any(t != toks[0] for t in toks):
        fail("phase 10b: the ranks served different tokens")
    flash = [r["serve"]["launches"].get("flash_attention", 0)
             for r in ranks]
    if backend == "nccl" and min(flash) == 0:
        fail(f"phase 10b: flash_attention launches by rank {flash}")
    s0 = ranks[0]["serve"]
    s0["by_rank"] = [{k: r["serve"][k] for k in ("static_bytes", "peak_bytes")}
                     for r in ranks]
    print(f"phase 10b: {world} ranks over {backend}, {wall:.1f} s wall; "
          f"{s0['arch']} whole on {world} cards, every rank the same "
          f"{sum(len(t) for t in toks[0].values())} tokens; peak memory by "
          f"rank {[round(r['serve']['peak_gb'], 2) for r in ranks]} GB; "
          f"flash_attention launches by rank {flash}{held}; card {card}",
          flush=True)
    for r, res in enumerate(ranks):
        if "collective_us" in res["serve"]:
            c = res["serve"]["collective_us"]
            print(f"phase 10b profile rank {r}: NCCL kernels' device time, "
                  f"waits on the other ranks included: "
                  f"{c['prefill']['nccl_us_a_step']:.1f} us of "
                  f"{c['prefill']['all_us_a_step']:.1f} us in a prefill "
                  f"({c['prefill']['nccl_calls_a_step']:.0f} NCCL kernels), "
                  f"{c['decode']['nccl_us_a_step']:.1f} us of "
                  f"{c['decode']['all_us_a_step']:.1f} us a decode step "
                  f"({c['decode']['nccl_calls_a_step']:.0f} NCCL kernels); "
                  f"alone (CUDA events, ranks lined up): "
                  + "; ".join(f"{k} {v['us']:.1f} us x {v['a_step']} = "
                              f"{v['us'] * v['a_step'] / 1e3:.3f} ms a step"
                              for k, v in c["alone"].items()), flush=True)
    return ranks[0]


# Phase 10c: hybrid training over NCCL, one rank a card, four cards.
# Jamba-1.5-Large at its published widths, cut to its first 3 of 72
# layers (attention, Mamba + MoE, Mamba: every block kind of its unit);
# its 16 experts split over 'model' (4 a rank).  A rank's state (bf16
# weights and gradients, f32 AdamW moments) is 67.87 GB
# (tools/hybrid_train_state.py); the dry run's step on the 4-rank mesh
# estimates 69.2 GB with its temp at 2 x 2,048 tokens (phase 11 prints it
# beside the peak).
HYBRID_PLAN = {"arch": "jamba_1_5_large", "layers": 3, "B": 2, "S": 2048,
               "steps": 8, "world": 4}
HYBRID_TIMEOUT_S = 600


def hybrid_rank(rank, world, init, out_dir, profile, plan, backend="nccl"):
    """One rank of phase 10c (spawned; rank 0 prints): the cut Jamba built
    on the mesh from a seeded generator, trained ``plan["steps"]`` steps
    through ``make_train_step`` and AdamW as ``launch.train`` composes
    them (cosine, remat), batches from the data pipeline.  Its results go
    to ``out_dir/rank<r>.json``; any failure raises, so the rank exits
    non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.data.pipeline import DataCfg, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import placed_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.train import optim as OPT
    from repro_torch.train import step as STEP

    on_card = backend == "nccl"
    kw = {}
    if on_card:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    mesh = make_mesh((1, world), ("data", "model"), backend=backend)
    dev = mesh.device
    get = C.get_reduced if plan.get("reduced") else C.get_config
    cfg = dataclasses.replace(get(plan["arch"]), n_layers=plan["layers"])
    B, S, steps = plan["B"], plan["S"], plan["steps"]

    def sync():
        if on_card:
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LM(cfg, mesh=mesh,
               generator=torch.Generator(device=dev).manual_seed(0))
    opt = OPT.adamw_init(dict(model.named_parameters()))
    step_fn = STEP.make_train_step(cfg, schedule="cosine", total=steps,
                                   warmup=max(1, steps // 20))
    data = TokenStream(DataCfg(vocab=cfg.vocab, seq_len=S, global_batch=B,
                               seed=7))
    static = placed_bytes(model, opt)["placed_bytes"]
    n_local = sum(p.numel() for p in model.parameters())
    sync()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kinds = [b.kind for b in model.blocks]
    n_attn = sum(k.startswith("attn") for k in kinds)
    n_mamba = sum(k.startswith("mamba") for k in kinds)
    # a step's exact launches: attention's forward twice a layer (the
    # forward and remat's recomputation) and its backward's two (dQ, then
    # dK / dV); the Mamba scan twice a layer and its backward once
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if on_card:
        want.update(flash_attention=2 * n_attn,
                    flash_attention_bwd=2 * n_attn,
                    mamba_scan=2 * n_mamba, mamba_scan_bwd=n_mamba)
    losses, walls, launches = [], [], []
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(i).items()}
        sync()
        ops.reset_launches()
        t1 = time.perf_counter()
        model, opt, met = step_fn(model, opt, batch)
        loss = float(met["loss"])
        sync()
        walls.append(time.perf_counter() - t1)
        launches.append(dict(ops.LAUNCHES))
        losses.append(loss)
        if launches[-1] != want:
            raise RuntimeError(f"step {i}: launches {launches[-1]}, want "
                               f"{want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"losses {losses}: want finite, the last below "
                           f"the first")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # every replicated parameter the same bits as rank 0's
    sharded = model.sharded_params()
    differ = []
    for name, p in model.named_parameters():
        if name in sharded:
            continue
        theirs = p.detach().clone()
        dist.broadcast(theirs, 0)
        if not torch.equal(theirs, p.detach()):
            differ.append(name)
        del theirs
    if differ:
        raise RuntimeError(f"replicated parameters differ from rank 0's: "
                           f"{differ[:8]}")
    nccl = None
    if profile and on_card:
        nccl = hybrid_nccl(step_fn, model, opt, data, steps, dev, torch)
    warm = float(np.mean(walls[1:])) if len(walls) > 1 else walls[0]
    res = {"arch": cfg.name, "layers": cfg.n_layers, "kinds": kinds,
           "world": world, "B": B, "S": S, "params_local": n_local,
           "static_bytes": static, "peak_bytes": peak, "init_s": init_s,
           "init_gb": init_gb, "losses": losses, "walls": walls,
           "warm_ms": warm * 1e3, "tokens_s": B * S / warm,
           "launches": launches[-1], "n_replicated": sum(
               1 for n, _ in model.named_parameters() if n not in sharded),
           "nccl": nccl}
    if rank == 0:
        print(f"phase 10c: {cfg.name} at {cfg.n_layers} of its "
              f"{get(plan['arch']).n_layers} layers ({', '.join(kinds)}), "
              f"{n_local} parameters on rank 0, initialised in {init_s:.1f}"
              f" s ({init_gb:.2f} GB)", flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def hybrid_nccl(step_fn, model, opt, data, steps, dev, torch) -> dict:
    """One more train step under torch.profiler: the device time of the
    NCCL kernels (waits on the other ranks included), of every kernel,
    and the eight kernels with the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(steps).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(model, opt, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    nccl = [e for e in kern if "nccl" in e.key.lower()]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"nccl_us": sum(e.self_device_time_total for e in nccl),
            "nccl_calls": sum(e.count for e in nccl),
            "all_us": sum(e.self_device_time_total for e in kern),
            "top": [(e.key[:60], e.self_device_time_total, e.count)
                    for e in top]}


def hybrid_path(profile, card, torch, plan=HYBRID_PLAN, backend="nccl",
                world=None) -> dict | None:
    """Phase 10c: spawn one rank a card (``hybrid_rank``) and wait for
    all of them, within ``HYBRID_TIMEOUT_S``; a rank that exits non-zero,
    or a spawn past its time, fails the phase.  Every rank must give the
    same losses.  Returns rank 0's results with every rank's static
    bytes and peak, or None with fewer than ``plan["world"]`` cards."""
    import socket
    import tempfile
    if world is None:
        n = torch.cuda.device_count()
        world = plan["world"]
        if n < world:
            print(f"phase 10c (hybrid training over NCCL) did not run: {n} "
                  f"card{'s' if n != 1 else ''} visible, and Jamba's cut "
                  f"train step needs {world}, one a rank", flush=True)
            return None
        gc.collect()
        torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=hybrid_rank, args=(
            r, world, f"tcp://localhost:{port}", out_dir, profile, plan,
            backend)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + HYBRID_TIMEOUT_S
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    fail(f"phase 10c: rank {bad[0]} exited with "
                         f"{procs[bad[0]].exitcode}")
                if time.monotonic() > deadline:
                    fail(f"phase 10c: ranks still running after "
                         f"{HYBRID_TIMEOUT_S} s")
                time.sleep(0.5)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                fail(f"phase 10c: rank {bad[0]} exited with "
                     f"{procs[bad[0]].exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        fail(f"phase 10c: the ranks' losses differ: "
             f"{[r['losses'] for r in ranks]}")
    r0 = ranks[0]
    r0["by_rank"] = [{k: r[k] for k in ("static_bytes", "peak_bytes")}
                     for r in ranks]
    nccl = ""
    if r0["nccl"]:
        c = r0["nccl"]
        nccl = (f"; NCCL kernels {c['nccl_us'] / 1e3:.2f} ms of "
                f"{c['all_us'] / 1e3:.2f} ms of device time in one step "
                f"({c['nccl_calls']} kernels, waits on the other ranks "
                f"included; torch.profiler, rank 0)")
    for key, us, n in (r0["nccl"] or {}).get("top", []):
        print(f"phase 10c profile rank 0, one step: {key:<60} "
              f"{us / 1e3:9.3f} ms {n:6d} calls", flush=True)
    print(f"phase 10c: {r0['arch']} at {r0['layers']} layers, {world} ranks "
          f"over {backend} on a (data 1, model {world}) mesh, "
          f"{len(r0['losses'])} steps of {r0['B']} x {r0['S']} tokens "
          f"(cosine, remat), {wall:.1f} s wall: losses "
          f"{[round(x, 4) for x in r0['losses']]}, every rank the same; "
          f"{r0['n_replicated']} replicated parameters the same bits on "
          f"every rank; warm {r0['warm_ms']:.1f} ms/step, "
          f"{r0['tokens_s']:.1f} tokens/s; peak memory by rank "
          f"{[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB; launches "
          f"a step {({k: n for k, n in r0['launches'].items() if n})}"
          f"{nccl}; card {card}", flush=True)
    return r0


def rehearse_hybrid(world: int = 4) -> dict:
    """Phase 10c's ranks over gloo on the CPU at the reduced config and a
    small batch: the check of its orchestration before a call to several
    cards (``python3 -c "import chip_smoke;
    chip_smoke.rehearse_hybrid()"`` from the repo root, ``src`` on the
    path).  Not part of the smoke run."""
    import torch
    plan = {**HYBRID_PLAN, "reduced": True, "B": 2, "S": 32}
    return hybrid_path(False, "cpu", torch, plan=plan, backend="gloo",
                       world=world)


def dryrun_serve(DR, cfg, slots, max_len, prompt, mesh=None,
                 cache_in_prefill=True) -> dict:
    """The dry run of phase 8's serving of ``cfg`` on ``meta``: a rank's
    static bytes (the parameters, its expert rows on ``mesh``, and the
    cache of ``slots`` x ``max_len``) and the larger temp of the prefill
    of ``slots`` x ``prompt`` tokens and of a decode step at a full
    cache; with ``cache_in_prefill`` (the ``Server``, whose cache exists
    before the prefill) the total is static + that temp, else (phase 8's
    enc-dec path, which makes its cache after the prefill) the parameters
    + the larger of the prefill's temp and the cache + the decode's."""
    model, _, cache = DR.build(cfg, "decode", slots, max_len, mesh)
    placed = DR.placed_bytes(model, cache=cache)
    world = 1 if mesh is None else mesh.size
    pre = DR.step_cost(cfg, model, "prefill", DR.input_specs(
        cfg, ("serve", prompt, slots, "prefill")), seq=prompt, world=world)
    dec = DR.step_cost(cfg, model, "decode", DR.input_specs(
        cfg, ("serve", max_len, slots, "decode")), cache=cache, world=world)
    if cache_in_prefill:
        total = placed["placed_bytes"] + max(pre["peak_bytes"],
                                             dec["peak_bytes"])
    else:
        total = placed["param_bytes"] + max(
            pre["peak_bytes"], placed["cache_bytes"] + dec["peak_bytes"])
    return dict(static=placed["placed_bytes"], total=total,
                flops=pre["flops_corrected"], params=placed["params"])


def dryrun_line(card, label, est, static, peak, extra="") -> None:
    """One line of phase 11: the estimate's static bytes must equal the
    card's live ones; its static + temp is printed against the peak."""
    if est["static"] != static:
        fail(f"dry run {label}: static {est['static']} B estimated, "
             f"{static} B live on the card")
    print(f"dry run {label}: static {est['static']} B estimated == "
          f"{static} B live on the card; estimate static + temp "
          f"{est['total'] / 1e9:.2f} GB against peak {peak / 1e9:.2f} GB"
          f" (ratio {est['total'] / peak:.3f}){extra}; card {card}",
          flush=True)


def dryrun_hybrid(C, DR, hybrid, card) -> None:
    """Phase 11 for phase 10c: the cut Jamba's train step on a rank of the
    mesh, estimated on ``meta`` (its parameters and AdamW's state, the
    rank's expert rows; the step's temp), against each rank's live
    tensors and peak."""
    from repro_torch.launch.mesh import Mesh
    p = HYBRID_PLAN
    cfg = dataclasses.replace(C.get_config(p["arch"]), n_layers=p["layers"])
    mesh = Mesh({"data": 1, "model": hybrid["world"]})
    model, opt, _ = DR.build(cfg, "train", p["B"], p["S"], mesh)
    placed = DR.placed_bytes(model, opt)
    cost = DR.step_cost(cfg, model, "train", DR.input_specs(
        cfg, ("train", p["S"], p["B"], "train")), opt=opt, world=mesh.size)
    if placed["params"] != hybrid["params_local"]:
        fail(f"dry run {p['arch']} train on {mesh.size} ranks: "
             f"{placed['params']} parameters a rank estimated, "
             f"{hybrid['params_local']} on the card")
    est = dict(static=placed["placed_bytes"],
               total=placed["placed_bytes"] + cost["peak_bytes"])
    for r, got in enumerate(hybrid["by_rank"]):
        dryrun_line(card, f"train {p['arch']} {p['layers']} layers "
                    f"{p['B']} x {p['S']} on {mesh.size} cards, rank {r} "
                    f"({placed['params']} parameters a rank)", est,
                    got["static_bytes"], got["peak_bytes"],
                    f"; {cost['flops_corrected']:.4g} FLOPs a step on a "
                    f"rank, collectives {cost['collective_counts']}")


def dryrun_vs_card(C, DR, card, trained, served, padded, ep,
                   hybrid=None) -> None:
    """Phase 11: each step that phases 8-10 measured, estimated by the dry
    run (``repro_torch.launch.dryrun``) on the ``meta`` device for the
    same config, shapes and dtype, beside the card's own figures from
    those phases' runs (no model runs here): the estimate's static bytes
    (parameters, AdamW's state, cache; on the mesh the rank's share)
    must equal the summed ``nbytes`` of the live tensors on the card, to
    the byte; the estimate's total (static + the step's temp) against
    ``torch.cuda.max_memory_allocated`` and, for the train step, its
    FLOPs against ``work.family_flops`` are printed, not held."""
    t0 = time.perf_counter()

    def line(label, est, static, peak, extra=""):
        dryrun_line(card, label, est, static, peak, extra)
    # 9. MiniCPM-2B's train step, 8 x 2,048
    cfg = C.get_config(TRAIN_ARCH)
    model, opt, _ = DR.build(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    placed = DR.placed_bytes(model, opt)
    cost = DR.step_cost(cfg, model, "train", DR.input_specs(
        cfg, ("train", TRAIN_SEQ, TRAIN_BATCH, "train")), opt=opt)
    rule, _ = family_flops(model, cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    line(f"train {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ}",
         dict(static=placed["placed_bytes"],
              total=placed["placed_bytes"] + cost["peak_bytes"]),
         trained["static_bytes"], trained["peak_bytes"],
         f"; {cost['flops_corrected']:.4g} FLOPs a step ("
         f"{cost['flops_dots']:.4g} in products, remat's recomputation "
         f"included) against {rule:.4g} by work.family_flops (ratio "
         f"{cost['flops_corrected'] / rule:.3f})")
    del model, opt
    # 8. the served models (4 x 1,024 prefill, 4 slots); 10a. the padded
    # Phi-3
    for arch, rep in list(served.items()) + [(f"{ALIGN_ARCH} padded",
                                              padded)]:
        if not rep:
            continue
        cfg = rep["cfg"]
        if cfg.family == "encdec":
            est = dryrun_serve(DR, cfg, 4, WHISPER_TEXT, WHISPER_TEXT,
                               cache_in_prefill=False)
            shape = f"{4} x {WHISPER_TEXT} over 4 x {WHISPER_FRAMES} frames"
        else:
            est = dryrun_serve(DR, cfg, 4, 1024, 1024)
            shape = "4 x 1024, 4 slots"
        line(f"serve {arch} ({cfg.n_layers} layers) {shape}", est,
             rep["static_bytes"], rep["peak_bytes"],
             f"; prefill {est['flops']:.4g} FLOPs")
    # 10b. whole Mixtral on each rank of the mesh
    if ep is not None:
        s0, p = ep["serve"], EP_PLAN["serve"]
        from repro_torch.launch.mesh import Mesh
        mesh = Mesh({"data": 1, "model": s0["world"]})
        est = dryrun_serve(DR, C.get_config(p["arch"]), p["slots"],
                           p["max_len"], p["prompt"], mesh)
        if est["params"] != s0["params_local"]:
            fail(f"dry run {p['arch']} on {s0['world']} ranks: "
                 f"{est['params']} parameters a rank estimated, "
                 f"{s0['params_local']} on the card")
        for r, got in enumerate(s0["by_rank"]):
            line(f"serve {p['arch']} whole on {s0['world']} cards, rank {r}"
                 f" ({est['params']} parameters a rank)", est,
                 got["static_bytes"], got["peak_bytes"])
    # 10c. the cut Jamba's train step on each rank of the mesh
    if hybrid is not None:
        dryrun_hybrid(C, DR, hybrid, card)
    wall = time.perf_counter() - t0
    print(f"dry run: phase 11 in {wall:.1f} s on the host", flush=True)


def rehearse_ep(world: int = 4) -> dict:
    """Phase 10b's ranks over gloo on the CPU, at the reduced configs and
    small shapes: the check of its orchestration before a call to
    several cards (``python3 -c "import chip_smoke;
    chip_smoke.rehearse_ep()"`` from the repo root, ``src`` on the
    path).  Not part of the smoke run."""
    import torch
    plan = {"reduced": True,
            "a2a": {**EP_PLAN["a2a"], "B": 2, "S": 16},
            "fshard": {**EP_PLAN["fshard"], "B": 2, "S": 16},
            "cut": {**EP_PLAN["cut"], "layers": 2, "B": 2, "S": 16,
                    "decode": 3},
            "serve": {**EP_PLAN["serve"], "max_len": 64, "prompt": 16,
                      "requests": 4, "gen": 4}}
    return ep_path(False, "cpu", torch, plan=plan, backend="gloo",
                   world=world)

def main() -> None:
    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from repro_torch import configs as C
        from repro_torch import data as GOLD
        from repro_torch.launch import dryrun as DR
        from repro_torch.launch import train as TRAIN
        from repro_torch.launch.serve import Server
        from repro_torch.train import optim as OPT
        from repro_torch.models.lm import LM
        from repro_torch.models import tp_align as TA
        from repro_torch.train import step as STEP
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import ref as KREF
        from repro_torch.net.sim import build as B
        from repro_torch.net.sim import engine as E
        from repro_torch.net.sim import failures as FF
        from repro_torch.net.sim.types import enqueue_bound
        from repro_torch.net.topology.dragonfly import make_dragonfly
        from repro_torch.net.workloads.synthetic import permutation
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout): {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        fail("the port imported jax or the reference package")
    # plain versions use f32 products of small integers: keep them exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    print(card_line(), flush=True)
    print(host_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    for name in KERNELS:
        _build.library(name)
    print(f"build: {time.perf_counter() - t0:.1f} s wall, nvcc "
          f"{_build.BUILD_INFO['seconds']:.1f} s, "
          f"{_build.BUILD_INFO['dir']}", flush=True)
    for name, log in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        for line in log.splitlines():      # entry function, then its use
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # host-side spec of the main path (numpy, the port's own build_spec)
    cfg = GOLD.CONFIG
    t0 = time.perf_counter()
    topo = make_dragonfly(8, 4, 4)
    flows = permutation(topo, size_pkts=32, seed=1)
    base = B.build_spec(topo, flows, cfg["base_scheme"],
                        n_ticks=cfg["n_ticks"])
    n_eps = int(base.src_ep.max()) + 1
    shapes = dict(N=base.n_pkt, F=base.n_flows, n_ports=base.n_ports,
                  M=enqueue_bound(base.n_pkt, base.n_ports, n_eps),
                  P=base.weights.shape[1], qsize=base.qsize,
                  kmin=base.kmin, kmax=base.kmax,
                  explore_threshold=base.explore_threshold)
    print(f"spec: {base.name} built in {time.perf_counter() - t0:.1f} s; "
          f"shapes {shapes}", flush=True)

    # 3. tick kernel checks
    nums = check_kernels(ops, KREF, E.sorted_rank, torch, np, shapes)
    for name, v in nums.items():
        print(f"kernel {name}: equal to plain; kernel {v['ms'] * 1e3:.2f} us,"
              f" plain {v['plain_ms'] * 1e3:.2f} us"
              + (f", library {v['library_ms'] * 1e3:.2f} us"
                 if v["library_ms"] is not None else "")
              + f", {v['bytes']} B", flush=True)
    print(f"kernel flow_agg (K=2): {nums['flow_agg']['ms_k2'] * 1e3:.2f} us",
          flush=True)
    agg = nums["flow_agg"]
    print(f"kernel flow_agg device time ({timed_by('flow_agg')}, zero fill "
          f"included): K 6 bool rows {agg['device_us']:.2f} us a call, "
          f"K 2 int32 "
          f"{agg['k2_device_us']:.2f} us; index_add_ (K 6 int32, its zero "
          f"fill included) {agg['library_device_us']:.2f} us a call",
          flush=True)
    for name in ("red_ecn", "tick_draws"):
        print(f"kernel {name} device time ({timed_by(name)}): "
              f"{nums[name]['device_us']:.2f} us a call", flush=True)
    for name in ("tick_rank_red_ecn", "spritz_select", "weighted_sample"):
        v = nums[name]
        print(f"kernel {name} drawing in place: equal to tick_draws' then "
              f"its plain version (DF-1056 and ragged sizes, ticks 0 and "
              f"2**31 - 1, 3 seeds, a graph at 3 ticks); device time "
              f"({timed_by(name + ' drawn in place')}) {v['device_us']:.2f}"
              f" us a call against {v['two_step_device_us']:.2f} us for "
              f"tick_draws then the "
              + ("torch sample" if name == "weighted_sample" else
                 "launch on the drawn uniforms")
              + f" ({timed_by(name + ' two-step')}); wrapper "
              f"{v['ms'] * 1e3:.2f} us against {v['two_step_ms'] * 1e3:.2f}",
              flush=True)
    tick_ptx = {}
    for name, lib, pattern in (
            ("spritz_select", "spritz_select", "spritz_select_kernel"),
            ("weighted_sample", "weighted_sample", "weighted_sample_kernel"),
            ("flow_agg", "flow_agg", "flow_agg_kernel"),
            ("tick_rank", "tick_rank", "tick_rank_")):
        ents = ptxas_entries(_build.BUILD_INFO.get("ptxas", {})
                             .get(lib, ""))
        tick_ptx[name] = {k: v for k, v in ents.items() if pattern in k}
        if not tick_ptx[name]:
            fail(f"{name}: no ptxas report of its kernel")
        print(f"kernel {name} ptxas (registers / static shared memory / "
              "stack / spill bytes): "
              + ", ".join(f"{k} {v['registers']} / {v['smem_bytes']} / "
                          f"{v['stack_bytes']} / {v['spill_bytes']}"
                          for k, v in sorted(tick_ptx[name].items())),
              flush=True)
    for name in ("spritz_select", "weighted_sample"):
        if any(v["stack_bytes"] or v["spill_bytes"]
               for v in tick_ptx[name].values()):
            fail(f"{name}: a stack frame or spills in the ptxas report")
    tr = nums["tick_rank"]
    print(f"kernel tick_rank at M {shapes['M']}, n_ports {shapes['n_ports']}"
          f": path {tr['path']}, {tr['segs']} segments, {tr['smem_bytes']} B"
          f" of shared memory; device time ({timed_by('tick_rank')}) "
          f"{tr['device_us']:.2f} us a call; the engine's torch form "
          f"(argsort + cummax + scatter) {tr['torch_form_device_us']:.2f} us"
          f" a call on the device, {tr['torch_form_ms'] * 1e3:.2f} us "
          f"wrapper", flush=True)
    fu = nums["tick_rank_red_ecn"]
    # the fused smem entry drawing unif in place (kRed, kDraw), the
    # engine's, of the tick_rank library
    fu_ptx = next((v for k, v in tick_ptx["tick_rank"].items()
                   if "tick_rank_smem_kernelILb1ELb1E" in k), None)
    if fu_ptx is None:
        fail("tick_rank_red_ecn: no ptxas report of its smem kernel")
    fu.update(registers=fu_ptx["registers"],
              stack_bytes=fu_ptx["stack_bytes"],
              spill_bytes=fu_ptx["spill_bytes"],
              static_smem_bytes=fu_ptx["smem_bytes"])
    print(f"kernel tick_rank_red_ecn at M {shapes['M']}, n_ports "
          f"{shapes['n_ports']}: path {fu['path']}, {fu['segs']} segments; "
          f"device time ({timed_by('tick_rank_red_ecn drawn in place')}) "
          f"{fu['device_us']:.2f} us a call drawing unif at the engine's "
          f"{ENGINE_ENQ} enqueues ({ENGINE_BAND} in the RED band), "
          f"{fu['every_entry_device_us']:.2f} us with every entry enqueued "
          f"and drawing (tick_draws then the given-unif launch "
          f"{fu['every_entry_two_step_device_us']:.2f} us; given unif "
          f"alone {fu['given_device_us']:.2f} us) against tick_rank alone "
          f"{tr['device_us']:.2f} + red_ecn alone "
          f"{nums['red_ecn']['device_us']:.2f} = "
          f"{tr['device_us'] + nums['red_ecn']['device_us']:.2f} us; "
          f"wrapper {fu['ms'] * 1e3:.2f} us; ptxas {fu['registers']} "
          f"registers, {fu['stack_bytes']} B stack, {fu['spill_bytes']} B "
          f"spills, shared memory {fu['static_smem_bytes']} B static + "
          f"{fu['dynamic_smem_bytes']} B dynamic", flush=True)

    # 4. engine path: each run through the captured graph loop
    golden = GOLD.load()["schemes"]
    launches = dict.fromkeys(KERNELS, 0)
    specs = {s: B.respec_scheme(base, s) for s in GOLD.SCHEMES}
    for s, spec in specs.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = E.run(spec, seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        rank_paths = dict(ops.TICK_RANK_PATHS)
        for k in launches:
            launches[k] += counts[k]
        check_golden(f"main {s}", res, golden[s], GOLD, np)
        per = check_replays(f"main {s}", res, counts, rank_paths, E, s,
                            "tick_rank_red_ecn")
        print(f"main {s}: equal to golden; ticks {res.ticks_simulated} "
              f"steps {res.steps_executed}, replays {res.replays}; wall "
              f"{wall:.3f} s ({res.steps_executed / wall:.1f} steps/s, first "
              f"run, the capture included); launches {counts}; a replay: "
              f"{per}; tick_rank paths {rank_paths}", flush=True)
    # warm repeat, timed only (launches not counted)
    for s, spec in specs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = E.run(spec, seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"main {s} warm: wall {wall:.3f} s, "
              f"{res.steps_executed / wall:.1f} steps/s, "
              f"{res.ticks_simulated / wall:.1f} ticks/s", flush=True)
    if profile:
        run_profile(E, specs["spritz_spray_w"], cfg["seed"], torch, wall,
                    "main spritz_spray_w")
    # 4c. the four schemes as one run_batch call (the golden record came
    # from the reference's run_batch)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    batch = E.run_batch(base, schemes=list(GOLD.SCHEMES), seeds=[cfg["seed"]],
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    rank_paths = dict(ops.TICK_RANK_PATHS)
    replays = {"all": 0, "spritz": 0, "sampler": 0}
    for s, res in zip(GOLD.SCHEMES, batch):
        check_golden(f"batch {s}", res, golden[s], GOLD, np)
        if not 0 <= res.replays - res.steps_executed < E.STEPS_PER_READ:
            fail(f"batch {s}: {res.replays} replays for "
                 f"{res.steps_executed} steps")
        replays["all"] += res.replays
        if s.startswith("spritz"):
            replays["spritz"] += res.replays
        if s in SAMPLERS:
            replays["sampler"] += res.replays
    want = dict.fromkeys(KERNELS, 0)
    want.update(flow_agg=2 * replays["all"],
                tick_rank_red_ecn=replays["all"],
                spritz_select=replays["spritz"],
                weighted_sample=replays["sampler"])
    if counts != want or rank_paths != {"smem": replays["all"],
                                        "pairwise": 0}:
        fail(f"batch: launches {counts}, tick_rank paths {rank_paths}; want "
             f"{want} on the smem path")
    for k in launches:
        launches[k] += counts[k]
    print(f"batch {'/'.join(GOLD.SCHEMES)}: one run_batch call, every lane "
          f"equal to golden; steps "
          f"{[r.steps_executed for r in batch]}, replays "
          f"{[r.replays for r in batch]}; wall {wall:.3f} s "
          f"({sum(r.steps_executed for r in batch) / wall:.1f} steps/s, "
          f"graphs warm); launches {counts}", flush=True)
    # 4d. the graph loop against the eager loop (the same gated step, its
    # wrappers called each step, the stop flag read after each)
    graph_vs_eager(E, GOLD, specs["spritz_spray_w"], cfg["seed"],
                   "main spritz_spray_w", torch)
    # 4b. failover path
    failover = failover_path(GOLD, B, E, FF, ops, topo, flows, torch, np,
                             profile)
    card = card_line()
    # 4e. the experiment matrix's packet-engine smoke cells, through the
    # port's runner
    cells = matrix_path(GOLD, E, ops, torch, card)
    launches_by_path = {k: {"permutation": launches[k],
                            "failover": failover[k], "matrix": cells[k]}
                        for k in TICK_KERNELS}
    for k in TICK_KERNELS:
        launches[k] += failover[k] + cells[k]
    # 4f. the smoke tier's flow-level cells, through the port's runner
    fabric_path(GOLD, ops, torch, card, profile)

    # 5. model kernel checks
    rwkv_lib = ctypes.CDLL(str(_build.build()["rwkv6_chunked"]))
    nums.update(check_model_kernels(ops, KREF, torch, np,
                                    rwkv_lib.rwkv6_chunked_smem_bytes))
    ptx = rwkv_ptxas(_build.BUILD_INFO.get("ptxas", {})
                     .get("rwkv6_chunked", ""))
    print("kernel rwkv6_chunked ptxas (registers, spill bytes): "
          + ", ".join(f"{k} {r} / {sp}" for k, (r, sp) in sorted(ptx.items())),
          flush=True)
    for name in TICK_KERNELS:
        nums[name].update(bound_ms=nums[name]["bytes"] / HBM_BYTES_PER_S
                          * 1e3, bound_by="bytes")
    # 6. card against CPU, reduced configs, serving
    card_vs_cpu(C, LM, STEP, torch, np)
    # 7. prefill against decode, full width
    prefill_vs_decode(C, LM, torch, np)
    # 8. serving path, full published configs
    serve_launches, serve_stats, mamba_by_path = {}, {}, {}
    for arch, kernel in SERVE_ARCHS.items():
        if C.get_config(arch).family == "encdec":
            counts = serve_encdec(arch, C, Server, STEP, ops, torch, np,
                                  card, profile,
                                  report=serve_stats.setdefault(arch, {}))
        else:
            counts = serve_path(arch, C, Server, STEP, ops, torch, np, card,
                                profile,
                                report=serve_stats.setdefault(arch, {}))
        serve_launches[arch] = counts[kernel]
        launches[kernel] += serve_launches[arch]
        launches["mamba_scan"] += counts["mamba_scan"]
        if counts["mamba_scan"]:
            mamba_by_path[f"serve {arch}, 2 prefills"] = counts["mamba_scan"]
    # the training phases come after serving's, so that what a backward
    # leaves behind (autograd's device thread keeps a cuBLAS workspace of
    # its own) stays out of phase 8's peak memory: 5b. attention's
    # backward kernel; 6b. training card against CPU, reduced configs
    nums.update(check_attention_bwd(ops, KREF, torch, np,
                                    _build.BUILD_INFO.get("ptxas", {})))
    rwkv_bwd_lib = ctypes.CDLL(str(_build.build()["rwkv6_chunked_bwd"]))
    nums.update(check_rwkv_bwd(ops, KREF, torch, np,
                               _build.BUILD_INFO.get("ptxas", {}),
                               rwkv_bwd_lib.rwkv6_chunked_bwd_smem_bytes,
                               rwkv_bwd_lib.rwkv6_chunked_bwd_blocks_per_sm))
    mamba_lib = ctypes.CDLL(str(_build.build()["mamba_scan"]))
    nums.update(check_mamba_scan(ops, KREF, torch, np,
                                 _build.BUILD_INFO.get("ptxas", {}),
                                 mamba_lib.mamba_scan_bwd_blocks_per_sm,
                                 mamba_lib.mamba_scan_fwd_blocks_per_sm,
                                 mamba_lib.mamba_scan_fwd_channels))
    reduced_hybrid = train_card_vs_cpu(C, LM, STEP, OPT, ops, torch, np)
    for k in ("mamba_scan", "mamba_scan_bwd"):
        launches[k] += reduced_hybrid[k]
    mamba_bwd_by_path = {"train jamba_1_5_large reduced, card against CPU":
                         reduced_hybrid["mamba_scan_bwd"]}
    mamba_by_path["train jamba_1_5_large reduced, card against CPU"] = \
        reduced_hybrid["mamba_scan"]
    # 9. training: MiniCPM-2B whole, then the other families
    trained = train_path(C, TRAIN, STEP, OPT, ops, torch, np, card, profile)
    for k in ("flash_attention", "flash_attention_bwd"):
        launches[k] += trained["counts"][k]
    families = {arch: train_family(arch, C, LM, STEP, OPT, TRAIN, ops, torch,
                                   np, card, profile)
                for arch in TRAIN_FAMILIES}
    for fam in families.values():
        for k, n in fam["counts"].items():
            launches[k] += n
    # 10a. TP head alignment, one card; 10b. expert parallelism over NCCL,
    # two cards or more
    padded = {}
    aligned_launches = tp_align_path(C, LM, TA, Server, STEP, ops, torch,
                                     np, card, serve_stats.get(ALIGN_ARCH),
                                     profile, report=padded)[
                                         "flash_attention"]
    launches["flash_attention"] += aligned_launches
    ep = ep_path(profile, card, torch)
    if ep is not None:
        launches["flash_attention"] += ep["serve"]["launches"][
            "flash_attention"]
    # 10c. hybrid training over NCCL, four cards
    hybrid = hybrid_path(profile, card, torch)
    if hybrid is not None:
        n_steps = len(hybrid["losses"])
        for k in ("flash_attention", "flash_attention_bwd", "mamba_scan",
                  "mamba_scan_bwd"):
            launches[k] += hybrid["launches"][k] * n_steps
        label = (f"train {HYBRID_PLAN['arch']} {hybrid['layers']} layers on "
                 f"{hybrid['world']} cards, rank 0, {n_steps} steps")
        mamba_by_path[label] = hybrid["launches"]["mamba_scan"] * n_steps
        mamba_bwd_by_path[label] = \
            hybrid["launches"]["mamba_scan_bwd"] * n_steps
    # 11. the dry run's estimates of those steps against the card
    dryrun_vs_card(C, DR, card, trained, serve_stats, padded, ep, hybrid)

    # 12. result lines
    rows = []
    for name, (src, replaces) in KERNELS.items():
        v = nums[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"]})
    flash = next(r for r in rows if r["name"] == "flash_attention")
    flash["path"] = nums["flash prefill bf16"]["path"]
    for key in ("device_ms", "library_device_ms"):
        flash[key] = nums["flash prefill bf16"][key]
    for label in ("decode bf16", "window 4096 f32", "whisper encoder bf16",
                  "whisper cross prefill bf16", "whisper cross decode bf16"):
        key = label.replace(" ", "_")
        flash[f"{key}_ms"] = nums[f"flash {label}"]["ms"]
        flash[f"{key}_library_ms"] = nums[f"flash {label}"]["library_ms"]
        flash[f"{key}_device_ms"] = nums[f"flash {label}"]["device_ms"]
        flash[f"{key}_library_device_ms"] = \
            nums[f"flash {label}"]["library_device_ms"]
        flash[f"{key}_bound_ms"] = nums[f"flash {label}"]["bound_ms"]
        flash[f"{key}_path"] = nums[f"flash {label}"]["path"]
    rwkv = next(r for r in rows if r["name"] == "rwkv6_chunked")
    for key in ("device_ms", "smem_bytes"):
        rwkv[key] = nums["rwkv prefill chunk 16"][key]
    rwkv["registers"] = ptx.get("f32 CP16", (None, None))[0]
    for label in ("prefill chunk 64", "strong decay chunk 32"):
        key = label.replace(" ", "_")
        for k2 in ("ms", "device_ms", "bound_ms"):
            rwkv[f"{key}_{k2}"] = nums[f"rwkv {label}"][k2]
    agg = next(r for r in rows if r["name"] == "flow_agg")
    for key in ("device_us", "k2_device_us", "library_device_us"):
        agg[key] = nums["flow_agg"][key]
    # the instantiation of the main path: P 64 (two registers a lane);
    # 1-byte rows (phase A). All launch with no dynamic shared memory, so ptxas's
    # static figure is all the block holds.
    for row, key in ((next(r for r in rows if r["name"] == "spritz_select"),
                      "spritz_select_kernelILi2ELb1E"),
                     (next(r for r in rows
                           if r["name"] == "weighted_sample"),
                      "weighted_sample_kernelILi2EE"),
                     (agg, "flow_agg_kernelIhE")):
        ent = next(v for k, v in tick_ptx[row["name"]].items() if key in k)
        row.update(registers=ent["registers"],
                   stack_bytes=ent["stack_bytes"],
                   smem_bytes=ent["smem_bytes"])
    for name in ("spritz_select", "red_ecn", "tick_draws",
                 "weighted_sample"):
        next(r for r in rows if r["name"] == name)["device_us"] = \
            nums[name]["device_us"]
    for name in ("tick_rank_red_ecn", "spritz_select", "weighted_sample"):
        next(r for r in rows if r["name"] == name).update(
            {k: nums[name][k] for k in (
                "two_step_device_us", "two_step_ms", "given_ms",
                "given_device_us", "every_entry_device_us",
                "every_entry_two_step_device_us")
                if k in nums[name]})
    next(r for r in rows if r["name"] == "tick_rank_red_ecn").update(
        {k: nums["tick_rank_red_ecn"][k] for k in (
            "device_us", "path", "segs", "registers", "stack_bytes",
            "spill_bytes", "static_smem_bytes", "dynamic_smem_bytes")})
    for row in rows:
        if row["name"] in launches_by_path:
            row["launches_by_path"] = launches_by_path[row["name"]]
    flash["launches_by_path"] = {
        a: n for a, n in serve_launches.items()
        if SERVE_ARCHS[a] == "flash_attention"}
    flash["launches_by_path"][f"train {TRAIN_ARCH}"] = \
        trained["counts"]["flash_attention"]
    flash["launches_by_path"][f"{ALIGN_ARCH} heads padded for tp "
                              f"{ALIGN_TP}"] = aligned_launches
    if ep is not None:
        s0 = ep["serve"]
        flash["launches_by_path"][
            f"{s0['arch']} whole on {s0['world']} cards, rank 0"] = \
            s0["launches"]["flash_attention"]
    bwd = next(r for r in rows if r["name"] == "flash_attention_bwd")
    for key in ("device_ms", "library_device_ms", "rel_err", "path"):
        bwd[key] = nums["flash bwd minicpm train bf16"][key]
    for label in ("minicpm train f32", "phi3 train bf16"):
        key = label.replace(" ", "_")
        for k2 in ("ms", "device_ms", "library_ms", "library_device_ms",
                   "plain_ms", "bound_ms", "path"):
            bwd[f"{key}_{k2}"] = nums[f"flash bwd {label}"][k2]
    bwd["launches_by_path"] = {f"train {TRAIN_ARCH} {p}": n
                               for p, n in trained["bwd_paths"].items()}
    for arch, fam in families.items():
        if "flash_attention" in fam["counts"]:
            flash["launches_by_path"][f"train {arch}"] = \
                fam["counts"]["flash_attention"]
            bwd["launches_by_path"].update(
                {f"train {arch} {p}": n for p, n in fam["bwd_paths"].items()})
        for key in ("warm_ms", "tokens_s", "model_flops_share", "peak_gb"):
            bwd.setdefault("train_families", {}).setdefault(arch, {})[key] = \
                fam[key]
    for label in ("whisper encoder bf16", "whisper cross bf16",
                  "whisper decoder bf16", "deepseek train bf16"):
        key = label.replace(" ", "_")
        for k2 in ("ms", "device_ms", "library_device_ms", "bound_ms",
                   "path"):
            bwd[f"{key}_{k2}"] = nums[f"flash bwd {label}"][k2]
    rbwd = next(r for r in rows if r["name"] == "rwkv6_chunked_bwd")
    for key in ("device_ms", "plain_device_ms", "smem_bytes",
                "blocks_per_sm", "ptxas", "rel_err", "fwd_device_ms",
                "fwd_states_device_ms"):
        rbwd[key] = nums["rwkv6_chunked_bwd"][key]
    for label in ("strong decay chunk 32", "wkv0 and d wkv_final chunk 16"):
        key = label.replace(" ", "_")
        for k2 in ("ms", "device_ms", "bound_ms", "rel_err"):
            rbwd[f"{key}_{k2}"] = nums[f"rwkv bwd {label}"][k2]
    rbwd["launches_by_path"] = {
        "train rwkv6_7b": families["rwkv6_7b"]["counts"]["rwkv6_chunked_bwd"]}
    rwkv["launches_by_path"] = {
        "serve rwkv6_7b": serve_launches["rwkv6_7b"],
        "train rwkv6_7b": families["rwkv6_7b"]["counts"]["rwkv6_chunked"]}
    bwd["train_step"] = {k: trained[k] for k in (
        "warm_ms", "tokens_s", "model_flops_share", "peak_gb")}
    for k2 in ("ms", "device_ms", "library_device_ms", "bound_ms", "path"):
        bwd[f"jamba_train_bf16_{k2}"] = nums["flash bwd jamba train bf16"][k2]
    if hybrid is not None:
        flash["launches_by_path"][label] = \
            hybrid["launches"]["flash_attention"] * n_steps
        bwd["launches_by_path"][label] = \
            hybrid["launches"]["flash_attention_bwd"] * n_steps
        bwd["train_hybrid"] = {k: hybrid[k] for k in (
            "warm_ms", "tokens_s", "peak_bytes", "losses", "world", "nccl")}
    for row, key in ((next(r for r in rows if r["name"] == "mamba_scan"),
                      "mamba"),
                     (next(r for r in rows if r["name"] == "mamba_scan_bwd"),
                      "mamba bwd")):
        v = nums[row["name"]]
        row.update({k2: v[k2] for k2 in ("device_ms", "rel_err", "ptxas")})
        for case in MAMBA_CASES[1:]:
            k1 = case[0].replace(" ", "_")
            for k2 in ("ms", "device_ms", "bound_ms", "rel_err", "plain_ms"):
                row[f"{k1}_{k2}"] = nums[f"{key} {case[0]}"][k2]
    mrow = next(r for r in rows if r["name"] == "mamba_scan")
    mrow.update(states_ms=nums["mamba_scan"]["states_ms"],
                states_bound_ms=nums["mamba_scan"]["states_bound_ms"],
                launches_by_path=mamba_by_path)
    mbwd = next(r for r in rows if r["name"] == "mamba_scan_bwd")
    mbwd.update(blocks_per_sm=nums["mamba_scan_bwd"]["blocks_per_sm"],
                launches_by_path=mamba_bwd_by_path)
    rank_row = next(r for r in rows if r["name"] == "tick_rank")
    for key in ("device_us", "path", "segs", "smem_bytes",
                "torch_form_device_us", "torch_form_ms"):
        rank_row[key] = nums["tick_rank"][key]
    for row in rows:
        if any("device" in key for key in row):
            late = [w for w in EVENT_TIMED if w.split()[0] == row["name"]]
            row["device_time_by"] = ("CUDA events for " + "; ".join(late)
                                     if late else "torch.profiler")
    if EVENT_TIMED:
        print("device times by CUDA events, torch.profiler having recorded "
              f"no CUDA kernel: {'; '.join(EVENT_TIMED)}", flush=True)
    else:
        print("device times: all from torch.profiler", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all, "
          f"the build included", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def check_golden(label, res, want, GOLD, np) -> None:
    """A run equals its golden record, every flow done, no violation."""
    got = GOLD.summarize(res)
    if got != want:
        fail(f"{label}: result differs from the record in "
             f"{[k for k in got if got[k] != want[k]]}")
    if res.down_violations or res.rate_violations or \
            not bool(np.all(res.done)):
        fail(f"{label}: down_violations {res.down_violations}, "
             f"rate_violations {res.rate_violations}, done "
             f"{int(np.sum(res.done))}/{len(res.done)}")


def check_replays(label, res, counts, paths, E, scheme: str,
                  rank: str) -> str:
    """The run replayed its captured step ``res.replays`` times, fewer
    than one read's batch past its last step, and each replay launched
    flow_agg twice and ``rank`` once, on its shared-memory path; the
    sampler once (spritz_select for Spritz, weighted_sample for
    ``SAMPLERS``), both drawing the path uniforms in place; tick_draws
    once only with the standalone rank (a capacity plan, whose torch
    RED math reads unif), as the fused launch draws its own; nothing
    else.  Returns the launches a replay, as text."""
    n, r = res.steps_executed, res.replays
    if not 0 <= r - n < E.STEPS_PER_READ:
        fail(f"{label}: {r} replays for {n} steps (reads every "
             f"{E.STEPS_PER_READ})")
    want = dict.fromkeys(counts, 0)
    want.update({"flow_agg": 2 * r, rank: r,
                 "tick_draws": r if rank == "tick_rank" else 0})
    if scheme.startswith("spritz"):
        want["spritz_select"] = r
    if scheme in SAMPLERS:
        want["weighted_sample"] = r
    if counts != want or paths != {"smem": r, "pairwise": 0}:
        fail(f"{label}: launches {counts}, tick_rank paths {paths}; want "
             f"{want} on the smem path ({r} replays)")
    return ", ".join(f"{k} {v // r}" for k, v in counts.items() if v)


def graph_vs_eager(E, GOLD, spec, seed, label, torch) -> None:
    """``engine.run`` (the captured step, replayed) against the private
    eager loop on one spec: equal results and final carry; then the
    warm steps/s of both in turns (eager, graph, graph, eager)."""
    g, g_st = E.run(spec, seed=seed, device="cuda", return_carry=True)
    e, e_st = E._eager_run(spec, seed, device="cuda", return_carry=True)
    bad = same_state(g_st, e_st)
    if GOLD.summarize(g) != GOLD.summarize(e) or bad:
        fail(f"{label}: the graph loop differs from the eager loop (carry "
             f"leaves {bad})")
    runs = {"eager": lambda: E._eager_run(spec, seed, device="cuda"),
            "graph": lambda: E.run(spec, seed=seed, device="cuda")}
    rates = []
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        rates.append((name, res.steps_executed / (time.perf_counter() - t0)))
    print(f"{label}: graph loop equal to the eager loop, final carry "
          f"included ({g.steps_executed} steps, {g.replays} replays); warm "
          f"steps/s " + ", ".join(f"{n} {r:.1f}" for n, r in rates),
          flush=True)


def same_state(a: dict, b: dict, path: str = "") -> list:
    """Keys of two nested-NumPy carry states whose arrays differ."""
    import numpy as np
    bad = []
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) and isinstance(y, dict):
            bad += same_state(x, y, f"{path}{k}.")
        elif x is None or y is None or x.dtype != y.dtype or \
                not np.array_equal(x, y):
            bad.append(path + k)
    return bad


def failover_path(GOLD, B, E, FF, ops, topo, flows, torch, np,
                  profile=False) -> dict:
    """Phase 4b: the DF-1056 permutation under the failover record's two
    plans, every listed scheme on the card, kernels on.  Launches are
    counted per run from just before it to just after; returns their
    sums by kernel."""
    record = GOLD.load(GOLD.FAILOVER_GOLDEN)
    if record["config"] != GOLD.FAILOVER_CONFIG:
        fail("failover record: config differs from data.FAILOVER_CONFIG")
    cfg = GOLD.FAILOVER_CONFIG
    totals = dict.fromkeys(KERNELS, 0)
    specs, walls = {}, {}
    for plan in GOLD.FAILOVER_PLANS:
        want = record["plans"][plan]
        compiled = GOLD.failover_schedule(FF, topo, plan).compile()
        if compiled.n_events != want["n_events"]:
            fail(f"failover {plan}: {compiled.n_events} events, record "
                 f"{want['n_events']}")
        rate = compiled.has_rate_events
        if rate != (plan == "degraded"):
            fail(f"failover {plan}: has_rate_events {rate}")
        base = B.build_spec(topo, flows, cfg["base_scheme"],
                            n_ticks=cfg["n_ticks"], failure_plan=compiled,
                            block_ticks=cfg["block_ticks"])
        for s in GOLD.FAILOVER_SCHEMES[plan]:
            spec = specs[plan, s] = B.respec_scheme(base, s)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = E.run(spec, seed=cfg["seed"], device="cuda")
            torch.cuda.synchronize()
            wall = walls[plan, s] = time.perf_counter() - t0
            counts = dict(ops.LAUNCHES)
            paths = dict(ops.TICK_RANK_PATHS)
            for k in totals:
                totals[k] += counts[k]
            check_golden(f"failover {plan} {s}", res, want["schemes"][s],
                         GOLD, np)
            per = check_replays(f"failover {plan} {s}", res, counts, paths,
                                E, s,
                                "tick_rank" if rate else "tick_rank_red_ecn")
            n = res.steps_executed
            print(f"failover {plan} {s}: equal to the record; ticks "
                  f"{res.ticks_simulated} steps {n}, replays {res.replays}; "
                  f"violations down 0 rate 0; wall {wall:.3f} s "
                  f"({n / wall:.1f} steps/s, first run, the capture "
                  f"included); launches {counts}; a replay: {per}; "
                  f"tick_rank paths {paths}", flush=True)

    # segments: spritz_spray_w on midrun cut at the end of the outage
    spec = specs["midrun", "spritz_spray_w"]
    full, full_state = E.run(spec, seed=cfg["seed"], device="cuda",
                             return_carry=True)
    bound = GOLD.FAILOVER_WINDOW[1]
    res, st = E.run(spec, seed=cfg["seed"], device="cuda", until_tick=bound,
                    return_carry=True)
    if not bound <= res.ticks_simulated < full.ticks_simulated:
        fail(f"failover resume: the first segment stopped at "
             f"{res.ticks_simulated}, want [{bound}, "
             f"{full.ticks_simulated})")
    res2, st2 = E.run(spec, device="cuda", resume=E.checkpoint(res, st),
                      return_carry=True)
    bad = same_state(st2, full_state)
    if GOLD.summarize(res2) != GOLD.summarize(full) or bad:
        fail(f"failover resume: segmented run differs from the unsegmented "
             f"one (carry leaves {bad})")
    print(f"failover resume midrun spritz_spray_w: segments [0, "
          f"{res.ticks_simulated}] ({res.steps_executed} steps) and on to "
          f"{res2.ticks_simulated} ({res2.steps_executed} steps in all) equal"
          f" the unsegmented run, final carry included", flush=True)

    # warm repeats, timed only (launches not counted)
    for key in [("midrun", s) for s in ("ugal_l", "ops_u", "reps",
                                        "spritz_spray_w")] + \
            [("degraded", "spritz_spray_w")]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = E.run(specs[key], seed=cfg["seed"], device="cuda")
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        print(f"failover {key[0]} {key[1]} warm: wall {walls[key]:.3f} s, "
              f"{res.steps_executed / walls[key]:.1f} steps/s, "
              f"{res.ticks_simulated / walls[key]:.1f} ticks/s", flush=True)
    graph_vs_eager(E, GOLD, specs["midrun", "spritz_spray_w"], cfg["seed"],
                   "failover midrun spritz_spray_w", torch)
    if profile:
        for plan in GOLD.FAILOVER_PLANS:
            run_profile(E, specs[plan, "spritz_spray_w"], cfg["seed"], torch,
                        walls[plan, "spritz_spray_w"],
                        f"failover {plan} spritz_spray_w")
    return totals


def matrix_path(GOLD, E, ops, torch, card: str) -> dict:
    """Phase 4e: every registered smoke cell that runs the packet engine
    (``data.SMOKE_CELLS``), at its registered size, through the port's
    runner (``run_cell``, ``force=True``, a temporary directory) on the
    card.  Every guard must pass and every row must equal the
    reference's record (``smoke_cells_golden.json``), wall-time fields
    excluded.  Launches are counted per cell from just before it to just
    after; ``run_batch`` and the loop's capture are wrapped to count the
    steps, replays and graph captures each cell made.  Returns the
    launches' sums by kernel."""
    import tempfile

    from repro_torch.exp import matrix, runner
    record = GOLD.load(GOLD.SMOKE_GOLDEN)["cells"]
    if tuple(record) != GOLD.SMOKE_CELLS:
        fail(f"smoke record: cells {list(record)}, want "
             f"{list(GOLD.SMOKE_CELLS)}")
    tally = dict.fromkeys(("steps", "replays", "calls", "captures"), 0)
    inner_batch, inner_capture = E.run_batch, E._Loop._capture

    def run_batch(*a, **kw):
        out = inner_batch(*a, **kw)
        results = out[0] if kw.get("return_carry") else out
        resume = kw.get("resume") or [None] * len(results)
        for res, ck in zip(results, resume):
            # a resumed lane's steps count on from its checkpoint's
            tally["steps"] += res.steps_executed - (
                0 if ck is None else int(ck.steps))
            tally["replays"] += res.replays
        tally["calls"] += 1
        return out

    def capture(loop):
        tally["captures"] += 1
        return inner_capture(loop)

    totals = dict.fromkeys(KERNELS, 0)
    t_phase = time.perf_counter()
    E.run_batch, E._Loop._capture = run_batch, capture
    try:
        with tempfile.TemporaryDirectory() as out:
            for cid in GOLD.SMOKE_CELLS:
                cell, want = matrix.CELLS[cid], record[cid]
                if want["spec"] != json.loads(json.dumps(cell.to_json())):
                    fail(f"{cid}: the record's spec differs from the "
                         f"matrix's")
                tally.update(dict.fromkeys(tally, 0))
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = runner.run_cell(cell, out=Path(out), force=True,
                                      verbose=False, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(ops.LAUNCHES)
                for k in totals:
                    totals[k] += counts[k]
                bad = [g["desc"] for g in res.guards if not g["ok"]]
                if bad:
                    fail(f"{cid}: guards breached: {bad}")
                rows = GOLD.comparable(res.rows)
                if len(rows) != len(want["rows"]):
                    fail(f"{cid}: {len(rows)} rows, record "
                         f"{len(want['rows'])}")
                for i, (got, ref) in enumerate(zip(rows, want["rows"])):
                    diff = sorted(k for k in set(got) | set(ref)
                                  if got.get(k) != ref.get(k))
                    if diff:
                        fail(f"{cid}: row {i} ({got.get('scheme')}) differs"
                             f" from the record in {diff}")
                r = tally["replays"]
                spritz = any(s.startswith("spritz") for s in cell.schemes)
                sampler = any(s in SAMPLERS for s in cell.schemes)
                # tick_draws only beside the standalone rank (a capacity
                # plan); the fused launch and the samplers draw in place
                if counts["tick_draws"] != counts["tick_rank"] \
                        or counts["flow_agg"] != 2 * r \
                        or counts["tick_rank"] + \
                        counts["tick_rank_red_ecn"] != r \
                        or counts["red_ecn"] or not r \
                        or bool(counts["spritz_select"]) != spritz \
                        or counts["spritz_select"] > r \
                        or bool(counts["weighted_sample"]) != sampler \
                        or counts["weighted_sample"] > r:
                    fail(f"{cid}: launches {counts} for {r} replays")
                n = tally["steps"]
                print(f"matrix {cid}: {len(rows)} rows equal to the record;"
                      f" guards {len(res.guards)} passed; steps {n}, "
                      f"replays {r} in {tally['calls']} run_batch calls, "
                      f"{tally['captures']} graph captures; wall "
                      f"{wall:.3f} s ({n / wall:.1f} steps/s, captures "
                      f"included); launches {counts}; {card}", flush=True)
    finally:
        E.run_batch, E._Loop._capture = inner_batch, inner_capture
    print(f"matrix: {len(GOLD.SMOKE_CELLS)} cells in "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return totals


def fabric_path(GOLD, ops, torch, card: str, profile: bool = False) -> None:
    """Phase 4f: every registered smoke cell of the flow-level engine
    (``data.FABRIC_CELLS``), at its registered size, through the port's
    runner on the card.  Every guard must pass, every row must equal the
    reference's record (``fabric_cells_golden.json``), wall-time fields
    excluded, each lane's ``fct`` bytes must have the record's sha256,
    and each lane's state must have lived on the card.
    ``flowsim.simulate_batch`` is wrapped to collect each lane's
    ``FlowResult`` and time each call (the table build is apart: the
    executor builds the table first)."""
    import tempfile

    from repro_torch.exp import matrix, runner
    from repro_torch.fabric import flowsim as FS
    record = GOLD.load(GOLD.FABRIC_GOLDEN)["cells"]
    if tuple(record) != GOLD.FABRIC_CELLS:
        fail(f"fabric record: cells {list(record)}, want "
             f"{list(GOLD.FABRIC_CELLS)}")
    lanes = []          # (scheme, FlowResult, wall s) of each call's lanes
    inner = FS.simulate_batch

    def simulate_batch(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, results in out.items():
            for res in results:
                lanes.append((name, res, wall / len(results)))
        return out

    t_phase = time.perf_counter()
    totals = dict.fromkeys(("epochs", "levels", "reads"), 0)
    lane_wall = 0.0
    FS.simulate_batch = simulate_batch
    try:
        with tempfile.TemporaryDirectory() as out:
            for cid in GOLD.FABRIC_CELLS:
                cell, want = matrix.CELLS[cid], record[cid]
                if want["spec"] != json.loads(json.dumps(cell.to_json())):
                    fail(f"{cid}: the record's spec differs from the "
                         f"matrix's")
                lanes.clear()
                ops.reset_launches()
                t0 = time.perf_counter()
                res = runner.run_cell(cell, out=Path(out), force=True,
                                      verbose=False, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if any(ops.LAUNCHES.values()):
                    fail(f"{cid}: the flow engine launched kernels "
                         f"{dict(ops.LAUNCHES)}")
                bad = [g["desc"] for g in res.guards if not g["ok"]]
                if bad:
                    fail(f"{cid}: guards breached: {bad}")
                rows = GOLD.comparable(res.rows)
                if len(rows) != len(want["rows"]):
                    fail(f"{cid}: {len(rows)} rows, record "
                         f"{len(want['rows'])}")
                for i, (got, ref) in enumerate(zip(rows, want["rows"])):
                    diff = sorted(k for k in set(got) | set(ref)
                                  if got.get(k) != ref.get(k))
                    if diff:
                        fail(f"{cid}: row {i} ({got.get('scheme')}) differs"
                             f" from the record in {diff}")
                if len(lanes) != len(rows):
                    fail(f"{cid}: {len(lanes)} lanes for {len(rows)} rows")
                digests = [GOLD.fct_digest(fres.fct) for _, fres, _ in lanes]
                bad = [name for (name, _, _), got, ref in zip(
                    lanes, digests, want["fct_sha256"]) if got != ref]
                if bad or len(digests) != len(want["fct_sha256"]):
                    fail(f"{cid}: the fct bytes of {bad or 'the lanes'} "
                         f"differ from the record's")
                for (name, fres, lwall), row in zip(lanes, res.rows):
                    st = fres.stats
                    if st is None or st.device != "cuda/cuda":
                        fail(f"{cid} {name}: the flow engine's state was on "
                             f"{None if st is None else st.device}, not "
                             f"cuda")
                    totals["epochs"] += st.epochs
                    totals["levels"] += st.levels
                    totals["reads"] += st.host_reads
                    lane_wall += lwall
                    print(f"fabric {cid} {name}: epochs {st.epochs}, "
                          f"water-fill levels {st.levels}, host reads "
                          f"{st.host_reads} ({st.reads_level} in the fill, "
                          f"{st.reads_epoch} outside it); wall "
                          f"{lwall:.3f} s ({lwall / max(st.levels, 1) * 1e6:.1f}"
                          f" us a level), table {row['table_wall_s']} s; "
                          f"{card}", flush=True)
                print(f"fabric {cid}: {len(rows)} rows and every lane's "
                      f"fct bytes equal to the record; "
                      f"guards {len(res.guards)} passed; state on cuda; "
                      f"wall {wall:.3f} s; {card}", flush=True)
    finally:
        FS.simulate_batch = inner
    print(f"fabric: {len(GOLD.FABRIC_CELLS)} cells in "
          f"{time.perf_counter() - t_phase:.1f} s; {totals['epochs']} epochs,"
          f" {totals['levels']} levels, {totals['reads']} host reads, "
          f"{lane_wall:.3f} s in the lanes "
          f"({lane_wall / max(totals['levels'], 1) * 1e6:.1f} us a level); "
          f"{card}", flush=True)
    if profile:
        fabric_profile(torch)


def fabric_profile(torch) -> None:
    """Where one flow-engine lane spends its time: spritz_spray_w on the
    DF-1056 train smoke cell, warm, then under torch.profiler: the
    device's busy share of the warm wall, kernel launches and device time
    a water-fill level, and the host ops with the most self CPU time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.exp import flow as XF
    from repro_torch.exp import matrix
    from repro_torch.exp.workloads import make_topology
    from repro_torch.fabric import flowsim as FS
    cell = matrix.CELLS["fabric.dragonfly1056.train.smoke"]
    topo = make_topology(cell.topology, cell.scale)
    flows, table, _ = XF._flow_set(cell, topo)

    def lane():
        return FS.simulate(topo, flows, "spritz_spray_w", table=table,
                           max_paths=XF.MAX_PATHS, device="cuda")

    lane()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lane()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    kern, n_launch, _ = profile_block("flow spritz_spray_w", lane, warm,
                                      torch, top=6)
    busy_us = sum(e.self_device_time_total for e in kern)
    st = res.stats
    print(f"profile flow spritz_spray_w: {st.epochs} epochs, {st.levels} "
          f"levels, {st.host_reads} host reads; warm {warm * 1e6 / st.levels:.1f}"
          f" us a level; {n_launch / st.levels:.1f} launches and "
          f"{busy_us / st.levels:.2f} us of device time a level (epoch work "
          f"included)", flush=True)
    with trace(activities=[ProfilerActivity.CPU]) as prof:
        lane()
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"profile flow host: {e.key[:40]:40s} "
              f"{e.self_cpu_time_total / 1e3:9.3f} ms self CPU "
              f"{e.count:7d} calls", flush=True)


def profile_block(label, fn, warm_wall: float, torch, top: int = 8,
                  host_top: int = 0):
    """Device time of the CUDA kernels that ``fn`` launches
    (torch.profiler), against ``warm_wall``, the unprofiled wall time in
    seconds of the same work; prints the kernels with the most device
    time (and the ``host_top`` host ops with the most self CPU time) and
    returns (kernel events, launches, ``fn``'s result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kern:
        print(f"chip_smoke: torch.profiler recorded no CUDA kernel for "
              f"profile {label}; its breakdown is empty", file=sys.stderr,
              flush=True)
    busy_us = sum(e.self_device_time_total for e in kern)
    n_launch = sum(e.count for e in kern)
    print(f"profile {label}: device kernel time {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e4 / warm_wall:.1f} % of the unprofiled wall "
          f"{warm_wall * 1e3:.3f} ms; {n_launch} kernel launches",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile {label}: {e.key[:60]:60s} "
              f"{e.self_device_time_total / 1e3:8.3f} ms {e.count:6d} calls",
              flush=True)
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
        print(f"profile {label}: host {e.key[:55]:55s} "
              f"{e.self_cpu_time_total / 1e3:8.3f} ms {e.count:6d} calls",
              flush=True)
    return kern, n_launch, out


def run_profile(E, spec, seed, torch, warm_wall: float, label: str) -> None:
    """Where one warm engine run spends the card's time: the busy share
    against the unprofiled warm wall time, the kernels launched per step,
    and the device time per call of the tick kernels."""
    kern, n_launch, res = profile_block(
        label, lambda: E.run(spec, seed=seed, device="cuda"), warm_wall,
        torch, top=12)
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"profile {label}: {res.steps_executed} steps, {res.replays} "
          f"replays of the captured step; "
          f"{n_launch / res.replays:.1f} launches per replay, "
          f"{busy_us / 1e3 / res.replays:.4f} ms of device time a "
          f"replay", flush=True)
    tick = re.compile(r"(?:void )?((?:flow_agg|tick_rank_smem|"
                      r"tick_rank_pairwise|red_ecn|tick_draws|"
                      r"spritz_select)_kernel"
                      r"(?:<[^>]*>)?)\(")
    for e in kern:
        m = tick.match(e.key)
        if m:
            print(f"profile {label}: {m.group(1)} device "
                  f"{e.self_device_time_total / e.count:.2f} us per call, "
                  f"{e.count} calls", flush=True)


if __name__ == "__main__":
    main()
