"""Multi-pod dry run on the ``meta`` device: the port of
``repro.launch.dryrun``.  For every (architecture x input shape x mesh)
cell at published width it records what a rank holds, how much work the
step does and what it sends, with no card and nothing allocated: the
model, its state and the step's inputs are built on ``meta`` and the
step runs there under the cost analysis (``launch/cost_analysis.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_32b \\
      --shape train_4k --mesh single --out results/dryrun_torch

Each cell's record goes to ``results/dryrun_torch/<cell>.json``
(resumable: a cell with a record is read back unless ``--force``).  A
record holds:

- ``argument_size_in_bytes`` / ``output_size_in_bytes``: a rank's share
  under the reference's sharding specs (``launch/shardings.py``, with
  ``--fsdp`` and ``--tp-align``): each leaf's elements over the product
  of its sharded extents, times its element size.  Arguments are the
  parameters, for train AdamW's ``m`` / ``v`` / ``step``, the batch and
  for decode the cache; outputs are, for train, the parameters, AdamW's
  state and three f32 metrics, else the last position's logits (split as
  the batch is: the reference leaves their sharding to XLA) and for
  decode the cache;
- ``placed_bytes``: a rank's static state as the port places it at run
  time (``models/moe.py``: only the expert rows split over 'model', by
  ``expert_dim``, everything else whole on every rank): the parameters,
  for train AdamW's state, for decode the cache; with the rank's
  parameter count and whether the state fits an 80 GB card;
- ``flops``, ``bytes_accessed`` and ``temp_size_in_bytes`` (the cost
  analysis's ``peak_bytes``) of the whole step on one device.  The
  reference's are per device after SPMD partitioning: the two agree only
  on one device.  A decode step is costed at a full cache (length
  ``max_len - 1``), as the reference's traced length costs it;
- ``collectives`` (the reference's ``hlo_collective_bytes`` layout, per
  rank): the MoE layers' ``torch.distributed`` calls on the mesh (for
  train their backward's and AdamW's too), counted from their call
  shapes in the step on the placed model, with that run's
  ``peak_bytes`` as ``rank_temp_size_in_bytes``.  The port runs every
  other layer whole on every rank, so the other archs send nothing.
"""
from __future__ import annotations

import argparse
import functools
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs as C
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import tp_align as TA
from repro_torch.models.convert import ref_layout
from repro_torch.models.lm import LM, scan_unit
from repro_torch.train import optim
from repro_torch.train import step as STEP

ENC_FRAMES = 1500  # whisper 30 s stub frontend
CARD_BYTES = 80 * 10 ** 9   # the H100's 80 GB
META = torch.device("meta")


def mesh_of(shape: dict) -> Mesh:
    """Rank 0's view of a mesh of ``shape`` (name -> size) with no
    process group: every coordinate 0, each axis a group that holds only
    its size, tensors on ``meta``."""
    return Mesh(dict(shape), {a: 0 for a in shape},
                {a: CA.ShapeGroup(n) if n > 1 else None
                 for a, n in shape.items()}, META)


def input_specs(cfg, shape) -> dict:
    """The step's inputs for this cell, empty on ``meta``."""
    _, seq, gbs, kind = shape

    def empty(*s, dtype=torch.int32):
        return torch.empty(s, dtype=dtype, device=META)
    if kind == "train":
        batch = {"tokens": empty(gbs, seq), "labels": empty(gbs, seq)}
    elif kind == "prefill":
        batch = {"tokens": empty(gbs, seq)}
    else:  # decode
        batch = {"tokens": empty(gbs, 1)}
    if cfg.family == "vlm" and kind != "decode":
        batch["prefix_embed"] = empty(gbs, cfg.n_patches, cfg.d_model,
                                      dtype=cfg.dtype)
    if cfg.family == "encdec":
        batch["enc_frames"] = empty(gbs, ENC_FRAMES, cfg.d_model,
                                    dtype=cfg.dtype)
    return batch


def leaf_bytes(shape, elem: int, spec, mesh) -> int:
    """A rank's bytes of one leaf: each dimension over its extent,
    rounded up (XLA pads an uneven split)."""
    n = elem
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n *= d if ax is None else -(-d // SH._extent(mesh, ax))
    return n


def _param_bytes(cfg, params: dict, mesh, fsdp: bool, elem=None) -> int:
    """Parameters (``elem`` bytes each when given: AdamW's f32 moments)
    under ``shardings.param_specs``, walked in the reference's layout."""
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    specs = SH.param_specs(cfg, shapes, mesh, fsdp=fsdp)

    def walk(node, spec):
        if isinstance(node, dict):
            return sum(walk(node[k], spec[k]) for k in node)
        if isinstance(node, list):
            return sum(walk(a, b) for a, b in zip(node, spec))
        stacked = isinstance(node, tuple)
        first = node[0] if stacked else node
        shape = ((len(node), *shapes[first]) if stacked else shapes[first])
        return leaf_bytes(shape, elem or params[first].element_size(),
                          spec, mesh)
    return walk(ref_layout(cfg, shapes), specs)


def _cache_paths(cfg, cache: dict):
    """(reference path, stacked shape, tensor) of each cache tensor: layer
    l is position ``l % u`` of the reference's unit, stacked over the
    units."""
    n_units, u = scan_unit(cfg)
    for l, layer in enumerate(cache["layers"]):
        for k, t in layer.items():
            group = {"k": "kv", "v": "kv", "conv": "mamba", "ssm": "mamba",
                     "shift": "rwkv", "wkv": "rwkv", "cshift": None}[k]
            path = f"layers/{l % u}/" + (f"{group}/{k}" if group else k)
            yield path, (n_units, *t.shape), t


def reference_bytes(cfg, model: LM, shape, mesh, *, fsdp: bool = False,
                    cache=None) -> dict:
    """A rank's argument and output bytes under the reference's specs:
    parameters, AdamW's state (train), batch, cache (decode)."""
    _, seq, gbs, kind = shape
    params = dict(model.named_parameters())
    out = {"params": _param_bytes(cfg, params, mesh, fsdp)}
    if kind == "train":
        # m and v share the parameters' specs; step is one int32
        out["opt"] = 2 * _param_bytes(cfg, params, mesh, fsdp, elem=4) + 4
    batch = input_specs(cfg, shape)
    bspecs = SH.batch_specs(cfg, mesh, batch=gbs, kind=kind)
    out["batch"] = sum(leaf_bytes(t.shape, t.element_size(),
                                  bspecs.get(k, ()), mesh)
                       for k, t in batch.items())
    b_ax = bspecs["tokens"][0]
    logits = leaf_bytes((gbs, 1, cfg.vocab_padded), cfg.dtype.itemsize,
                        (b_ax,), mesh)
    if kind == "decode":
        spec_for = SH.cache_specs(cfg, mesh, batch=gbs, max_len=seq)
        out["cache"] = 4 + sum(                 # + the int32 length
            leaf_bytes(t.shape, t.element_size(), spec_for(p, s)[1:], mesh)
            for p, s, t in _cache_paths(cfg, cache))
    if kind == "train":
        out["argument_size_in_bytes"] = \
            out["params"] + out["opt"] + out["batch"]
        out["output_size_in_bytes"] = out["params"] + out["opt"] + 12
    elif kind == "prefill":
        out["argument_size_in_bytes"] = out["params"] + out["batch"]
        out["output_size_in_bytes"] = logits
    else:
        out["argument_size_in_bytes"] = \
            out["params"] + out["cache"] + out["batch"]
        out["output_size_in_bytes"] = logits + out["cache"]
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def placed_bytes(model: LM, opt=None, cache=None) -> dict:
    """A rank's static state as the port holds it: the parameters of
    ``model`` (built on the rank's mesh, its expert rows only), AdamW's
    ``opt`` and the decode ``cache`` when given."""
    params = list(model.parameters())
    out = {"params": sum(p.numel() for p in params),
           "param_bytes": _nbytes(params), "opt_bytes": 0, "cache_bytes": 0}
    if opt is not None:
        out["opt_bytes"] = _nbytes([*opt.m.values(), *opt.v.values(),
                                    opt.step, *(opt.err or {}).values()])
    if cache is not None:
        out["cache_bytes"] = _nbytes(t for layer in cache["layers"]
                                     for t in layer.values())
    out["placed_bytes"] = (out["param_bytes"] + out["opt_bytes"]
                           + out["cache_bytes"])
    out["fits_80gb"] = out["placed_bytes"] <= CARD_BYTES
    return out


def build(cfg, kind: str, batch: int, seq: int, mesh=None):
    """The model on ``meta`` (on ``mesh``'s rank 0 when given) and its
    static state: AdamW's (train) or the cache at ``seq - 1`` (decode)."""
    model = LM(cfg, device=META, mesh=None if mesh is None
               else mesh_of(mesh.shape))
    opt = cache = None
    if kind == "train":
        opt = optim.adamw_init(dict(model.named_parameters()))
    elif kind == "decode":
        cache = model.init_cache(batch, seq)
        cache["len"] = seq - 1
    return model, opt, cache


def step_cost(cfg, model: LM, kind: str, batch: dict, *, opt=None,
              cache=None, seq: int = 0, microbatch: int = 0,
              world: int = 1) -> dict:
    """The cost analysis of the port's step for ``kind`` on ``model``:
    ``make_train_step``, ``make_prefill_step`` or ``make_serve_step``."""
    if kind == "train":
        step = STEP.make_train_step(cfg, microbatch=microbatch)
        return CA.analyze(step, model, opt, batch, world=world, model=model)
    if kind == "prefill":
        return CA.analyze(STEP.make_prefill_step(model, seq), batch,
                          world=world, model=model)
    return CA.analyze(STEP.make_serve_step(model), cache, batch,
                      world=world, model=model)


def collectives_record(cost: dict) -> dict:
    return {k: {"bytes": cost["collective_bytes"][k],
                "count": cost["collective_counts"][k]}
            for k in CA.COLLECTIVE_OPS}


@functools.lru_cache(maxsize=1)
def _whole_step(cfg, shape, microbatch: int) -> dict:
    """The whole-step figures on one device, once for both meshes of a
    cell (the grid visits them one after the other)."""
    _, seq, gbs, kind = shape
    model, opt, cache = build(cfg, kind, gbs, seq)
    cost = step_cost(cfg, model, kind, input_specs(cfg, shape), opt=opt,
                     cache=cache, seq=seq, microbatch=microbatch)
    return {"flops": cost["flops_corrected"], "flops_dots": cost["flops_dots"],
            "bytes_accessed": cost["bytes_corrected"],
            "temp_size_in_bytes": cost["peak_bytes"],
            "credited": cost["credited"], "host_bytes": cost["host_bytes"],
            "top_dots": CA.attribute_dots(cost),
            "top_bytes": CA.attribute_bytes(cost)}


def config_of(arch: str, tp_align: bool = False):
    """The arch's published config, its heads padded for tp 16 with
    ``tp_align``, as the reference's ``lower_cell`` pads them."""
    cfg = C.get_config(arch)
    return TA.aligned(cfg, tp=16) if tp_align else cfg


def estimate(cfg, shape, mesh, *, microbatch: int = 0,
             fsdp: bool = False) -> dict:
    """The record's figures for ``cfg`` at ``shape`` = (name, seq, batch,
    kind) on ``mesh`` (any :class:`Mesh` shape), without the cell's
    bookkeeping."""
    _, seq, gbs, kind = shape
    rec = {}
    model, opt, cache = build(cfg, kind, gbs, seq)
    rec["reference_bytes"] = reference_bytes(cfg, model, shape, mesh,
                                             fsdp=fsdp, cache=cache)
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        rec[k] = rec["reference_bytes"].pop(k)
    on_mesh = cfg.moe is not None and mesh.shape.get("model", 1) > 1
    if on_mesh:
        del model, opt, cache
        model, opt, cache = build(cfg, kind, gbs, seq, mesh)
    rec["placed"] = placed_bytes(model, opt, cache)
    rec["placed_bytes"] = rec["placed"]["placed_bytes"]
    rec["collectives"] = {k: {"bytes": 0, "count": 0}
                          for k in CA.COLLECTIVE_OPS}
    if on_mesh:
        cost = step_cost(cfg, model, kind, input_specs(cfg, shape), opt=opt,
                         cache=cache, seq=seq, world=mesh.size,
                         microbatch=microbatch)
        rec["collectives"] = collectives_record(cost)
        rec["rank_temp_size_in_bytes"] = cost["peak_bytes"]
        rec["rank_host_bytes"] = cost["host_bytes"]
        rec["top_collectives"] = CA.attribute_collectives(cost)
    del model, opt, cache
    rec.update(_whole_step(cfg, shape, microbatch))
    rec["figures"] = ("flops, bytes_accessed and temp_size_in_bytes: the "
                      "whole step on one device")
    return rec


def run_cell(arch: str, shape, multi_pod: bool, out_dir: Path,
             microbatch: int = 0, force: bool = False,
             tp_align: bool = False, fsdp: bool = False) -> dict:
    sname, seq, gbs, kind = shape
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{sname}__{mesh_name}"
    out_file = out_dir / f"{cell}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())

    t0 = time.time()
    rec = {"cell": cell, "arch": arch, "shape": sname, "mesh": mesh_name,
           "kind": kind, "seq": seq, "batch": gbs, "tp_align": tp_align,
           "fsdp": fsdp, "microbatch": microbatch}
    try:
        cfg = config_of(arch, tp_align)
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(estimate(cfg, shape, mesh, microbatch=microbatch,
                            fsdp=fsdp))
        rec["status"] = "ok"
        rec["ok"] = True
    except Exception as e:  # record failures: they are bugs to fix
        rec["status"] = "failed"
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--tp-align", action="store_true",
                    help="pad GQA heads for clean head-sharded TP")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-shard params+optimizer over the data axes")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else C.ARCHS
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t_all = time.time()
    n = dict.fromkeys(("ok", "skip", "fail"), 0)
    for arch in archs:
        for shape, skip in C.arch_shapes(arch):
            if args.shape and shape[0] != args.shape:
                continue
            if skip:
                for mp in meshes:
                    mesh_name = "pod2x16x16" if mp else "pod16x16"
                    cell = f"{arch}__{shape[0]}__{mesh_name}"
                    out_dir.mkdir(parents=True, exist_ok=True)
                    (out_dir / f"{cell}.json").write_text(json.dumps(
                        {"cell": cell, "ok": True, "skipped": skip}))
                    print(f"SKIP {cell}: {skip}")
                    n["skip"] += 1
                continue
            for mp in meshes:
                rec = run_cell(arch, shape, mp, out_dir, force=args.force,
                               microbatch=args.microbatch,
                               tp_align=args.tp_align, fsdp=args.fsdp)
                if rec.get("skipped"):
                    n["skip"] += 1
                    continue
                status = rec.get("status", "ok" if rec["ok"] else "failed")
                n["ok" if status == "ok" else "fail"] += 1
                flops, temp = rec.get("flops"), rec.get("temp_size_in_bytes")
                print(f"{status.upper()} {rec['cell']} "
                      + (f"flops={flops:.3g} temp={temp / 2**30:.2f}GiB "
                         if flops is not None else "")
                      + f"placed={rec.get('placed_bytes', 0) / 2**30:.2f}GiB"
                      f" ({rec.get('total_s', 0)}s)"
                      + (f" :: {rec.get('error')}" if status == "failed"
                         else ""), flush=True)
    print(f"dry-run complete: ok={n['ok']} skip={n['skip']} "
          f"fail={n['fail']} "
          f"({time.time() - t_all:.1f}s)")
    return n["fail"]


if __name__ == "__main__":
    raise SystemExit(main())
