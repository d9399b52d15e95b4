"""Loss and train-step factories, and the serving steps: the port of
``repro.train.step``.

``make_loss_fn`` / ``make_train_step`` take the config and return
functions of the model, as the reference's take the config and return
functions of the parameter tree; the train step updates the model's
parameters in place (the reference donates them).  Training covers
every family (:data:`TRAINABLE`), on one device and, for a model built
on a mesh (``LM(..., mesh=)``), on every rank of it: the MoE layers'
backward sums each gradient over the ranks that fed it
(``models/moe.py``), and AdamW reduces the expert blocks' norm and
scales over 'model' (``LM.sharded_params``).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelCfg
from repro_torch.models.lm import LM
from repro_torch.train import optim

TRAINABLE = ("dense", "vlm", "encdec", "moe", "rwkv", "hybrid")
# why a family does not train (none: every family of the reference does)
UNTRAINABLE: dict = {}


def _check_trainable(cfg: ModelCfg) -> None:
    if cfg.family not in TRAINABLE:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family is not ported "
            f"({UNTRAINABLE.get(cfg.family, 'unknown family')})")


class _Xent(torch.autograd.Function):
    """The masked softmax cross-entropy's value and its gradient
    ``(softmax - onehot) * mask / count``, the f32 logits kept once and
    turned into the gradient in place (at MiniCPM-2B's 8 x 2,048 tokens
    they are 8 GB)."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_real):
        lf = logits.to(torch.float32, copy=True)
        if vocab_real is not None and vocab_real < lf.shape[-1]:
            lf[..., vocab_real:] = -1e30
        lse = torch.logsumexp(lf, -1)
        lab = labels.long().clamp_min(0)
        gold = lf.gather(-1, lab[..., None])[..., 0]
        mask = (labels >= 0).float()
        count = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(lf, lse, lab, mask, count)
        ctx.dtype = logits.dtype
        return ((lse - gold) * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        lf, lse, lab, mask, count = ctx.saved_tensors
        grad = lf.sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, lab[..., None],
                          torch.full(lab[..., None].shape, -1.0,
                                     device=grad.device))
        grad.mul_((g * mask / count)[..., None])
        return grad.to(ctx.dtype), None, None


def xent_loss(logits, labels, vocab_real: int | None = None):
    """Masked softmax cross-entropy in f32; labels < 0 are ignored and the
    padded vocab positions (``>= vocab_real``) are set to -1e30, as in the
    reference.  logits: [..., V]; labels: [...] integers."""
    return _Xent.apply(logits, labels, vocab_real)


def make_loss_fn(cfg: ModelCfg, *, remat: bool = True, aux_weight=0.01):
    """``loss_fn(model, batch) -> (loss, {"lm_loss", "aux"})``: the LM
    loss on ``batch["tokens"]`` / ``batch["labels"]`` ([B, S] integer
    tensors; the VLM family also ``batch["prefix_embed"]``, whose
    positions carry no loss; the enc-dec family ``batch["enc_frames"]``
    [B, Te, d], the encoder's input) plus ``aux_weight`` times the MoE
    aux loss (0 for the families without experts)."""
    _check_trainable(cfg)

    def loss_fn(model: LM, batch):
        kw = {}
        if cfg.family == "vlm":
            kw["prefix_embed"] = batch["prefix_embed"]
        if cfg.family == "encdec":
            kw["enc_frames"] = batch["enc_frames"]
        logits, aux = model(batch["tokens"], with_aux=True, remat=remat,
                            **kw)
        if cfg.family == "vlm":   # prefix positions carry no LM loss
            logits = logits[:, cfg.n_patches:]
        loss = xent_loss(logits, batch["labels"], cfg.vocab) + \
            aux_weight * aux
        return loss, {"lm_loss": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg: ModelCfg, *, peak_lr=3e-4, schedule="cosine",
                    warmup=100, total=10_000, remat=True, microbatch: int = 0):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "gnorm", "lr"})`` (0-d f32 tensors on the model's device).
    The step turns the parameters' ``requires_grad`` on and updates them
    in place.  ``microbatch > 1`` splits the batch into that many chunks
    whose gradients are summed in f32 and divided (the reference's
    ``lax.scan``); without it the gradients keep the parameters' dtype,
    as in the reference.  ``train_step.update(model, opt_state, grads)``
    is the step's update alone, from gradients taken elsewhere."""
    loss_fn = make_loss_fn(cfg, remat=remat)

    def grads_of(model, names, batch):
        loss, _ = loss_fn(model, batch)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        # the update scales the gradients in place: a broadcast view (the
        # gradient of a sum, as of RWKV's wo row sums) gets memory of its
        # own
        return loss.detach(), {n: g.contiguous() for n, g in
                               zip(names, grads)}

    def train_step(model: LM, opt_state: optim.AdamWState, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        names = list(params)
        if microbatch and microbatch > 1:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatch):
                shard = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                loss, g = grads_of(model, names, shard)
                for n in names:
                    acc[n].add_(g[n])
                lsum = lsum + loss
                del g
            grads = {n: a.mul_(optim.recip(microbatch))
                     for n, a in acc.items()}
            loss = lsum * optim.recip(microbatch)
        else:
            loss, grads = grads_of(model, names, batch)
        opt_state, gnorm, lr = update(model, opt_state, grads)
        return model, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    def update(model: LM, opt_state: optim.AdamWState, grads: dict):
        """The step's AdamW update of ``model`` from ``grads`` (by name;
        overwritten): ``(opt_state, gnorm, lr)``."""
        if schedule == "wsd":
            lr = optim.wsd_schedule(opt_state.step, peak_lr=peak_lr,
                                    warmup=warmup, stable=int(total * 0.8),
                                    decay=int(total * 0.2))
        else:
            lr = optim.cosine_schedule(opt_state.step, peak_lr=peak_lr,
                                       warmup=warmup, total=total)
        split = (None if model.mesh is None
                 else model.mesh.groups.get("model"))
        _, opt_state, gnorm = optim.adamw_update(
            dict(model.named_parameters()), grads, opt_state, lr,
            groups=model.stacked_groups(), sharded=model.sharded_params(),
            group=split)
        return opt_state, gnorm, lr

    train_step.update = update
    return train_step


def step_grads(loss_fn, model: LM, batch: dict, microbatch: int = 0) -> dict:
    """The gradient, by name, that a train step with ``microbatch`` takes:
    the batch's, or the mean of its row shards' (a shard's loss is
    normalized by its own token count)."""
    named = dict(model.named_parameters())
    n = max(microbatch, 1)
    total = None
    for i in range(n):
        loss, _ = loss_fn(model, {k: v.reshape(n, -1, *v.shape[1:])[i]
                                  for k, v in batch.items()})
        gs = torch.autograd.grad(loss, list(named.values()))
        total = gs if total is None else [a + g for a, g in zip(total, gs)]
    return {k: g / n for k, g in zip(named, total)}


def make_prefill_step(model: LM, max_len: int):
    """Serve prefill: ``batch["tokens"]`` [B, S] (and, for the VLM family,
    ``batch["prefix_embed"]`` [B, Np, d]; for the enc-dec family,
    ``batch["enc_frames"]`` [B, Te, d]) -> logits of the last position
    [B, 1, V].  As in the reference, it is the full forward and populates
    no cache; ``max_len`` is kept for the reference's signature."""
    family = model.cfg.family

    @torch.no_grad()
    def prefill(batch):
        kw = {}
        if family == "vlm":
            kw["prefix_embed"] = batch["prefix_embed"]
        if family == "encdec":
            kw["enc_frames"] = batch["enc_frames"]
        return model(batch["tokens"], **kw)[:, -1:]

    return prefill


def make_serve_step(model: LM):
    """One-token decode step: ``serve_step(cache, batch) -> (logits
    [B, 1, V], cache)``, with ``batch["enc_frames"]`` for the enc-dec
    family; the cache is updated in place (the reference donates it)."""
    encdec = model.cfg.family == "encdec"

    def serve_step(cache, batch):
        kw = {"enc_frames": batch["enc_frames"]} if encdec else {}
        return model.decode_step(batch["tokens"], cache, **kw)

    return serve_step
