"""The work of the port's model kernels: the FLOPs and bytes one call
needs, the card's peak rates, the least time they allow, and the model
FLOPs of a train step.

One copy for every reader: ``chip_smoke.py`` puts each kernel's time
beside its bound with these formulas, and the dry run
(``launch/cost_analysis.py``) credits a kernel called on the ``meta``
device with the same figures (:func:`credit`), since nothing runs there.
"""
from __future__ import annotations

import contextlib

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
PEAK_FLOPS = {"bf16": 989e12,  # dense tensor-core rate (data sheet)
              "f32": 67e12}    # f32 outside the tensor cores
# exponentials a second: the SFU's 16 ex2 a clock an SM (Hopper's
# arithmetic-instruction throughput table), 132 SMs at the H100 SXM's
# 1.98 GHz boost clock (data sheet)
EXP_PER_S = 16 * 132 * 1.98e9

_SINKS: list = []


@contextlib.contextmanager
def listen(sink):
    """Within the block, ``sink(name, flops, nbytes, products)`` receives
    every :func:`credit`."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def credit(name: str, flops: float, nbytes: float,
           products: bool = True) -> None:
    """Work that a ``meta`` call stood for and did not do (a kernel's, or
    the Mamba scan's token loop), to every sink that :func:`listen`
    holds; ``products`` when its FLOPs are products (a kernel's)."""
    for sink in _SINKS:
        sink(name, flops, nbytes, products)


def _segment_sum(a: int, b: int, s: int, e: int) -> tuple:
    """Over p in [s, e]: the sum of max(0, a + b p) (b in -1, 0, 1) and
    the first and last p where it is positive (None when nowhere)."""
    if b == 0:
        lo, hi = (s, e) if a > 0 else (None, None)
    elif b > 0:
        lo, hi = max(s, 1 - a), e
    else:
        lo, hi = s, min(e, a - 1)
    if lo is None or lo > hi:
        return 0, None, None
    n = hi - lo + 1
    return n * a + b * (lo + hi) * n // 2, lo, hi


def attention_pairs(Sq: int, Sk: int, *, causal: bool, window: int,
                    q_offset: int) -> tuple:
    """The unmasked (query, key) pairs of one head of attention, and the
    first and last key any query sees (``(0, 0, -1)`` when none), in
    closed form: query row i sits at position ``q_offset + i`` and sees
    keys ``[max(0, pos - window + 1), min(Sk - 1, pos)]`` (all keys when
    not causal, from 0 without a window).  The count ``hi - lo + 1`` is
    linear between the positions where ``hi`` or ``lo`` changes branch,
    so each such segment is an arithmetic sum."""
    p0, p1 = q_offset, q_offset + Sq - 1
    cuts = {p0, p1 + 1}
    if causal:
        cuts.add(Sk)              # hi = pos up to Sk - 1, then Sk - 1
    if window:
        cuts.add(window)          # lo = 0 up to window - 1, then pos - w + 1
    edges = sorted(c for c in cuts if p0 <= c <= p1 + 1)
    pairs, first, last = 0, None, None
    for s, nxt in zip(edges, edges[1:]):
        e = nxt - 1
        # hi(p) = hi_a + hi_b p and lo(p) = lo_a + lo_b p on [s, e]
        hi_a, hi_b = (0, 1) if causal and s <= Sk - 1 else (Sk - 1, 0)
        lo_a, lo_b = (0, 0) if not window or s <= window - 1 else \
            (1 - window, 1)
        n, lo, hi = _segment_sum(hi_a - lo_a + 1, hi_b - lo_b, s, e)
        pairs += n
        if lo is not None:
            if first is None:
                first = lo_a + lo_b * lo
            last = hi_a + hi_b * hi
    if first is None:
        return 0, 0, -1
    return pairs, first, last


def attention_work(q, k, *, causal, window, q_offset):
    """(FLOPs, bytes) that one attention call needs: 4 D flops per
    unmasked (query, key) pair (scores and weighted sum), q and o once,
    and the keys and values that some query may see."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    pairs, k_lo, k_hi = attention_pairs(Sq, Sk, causal=causal, window=window,
                                        q_offset=q_offset)
    keys = max(k_hi - k_lo + 1, 0)
    elem = q.element_size()
    flops = 4 * B * Hq * D * pairs
    nbytes_ = elem * (2 * B * Sq * Hq * D + 2 * B * keys * Hkv * D)
    return flops, nbytes_


def attention_bwd_work(q, k, *, causal, window):
    """(FLOPs, bytes) of attention's backward (query row i at position
    i): 2.5x the forward's FLOPs; q, o, dO and dq, and k, v, dk and dv
    once, and the row log-sum-exp."""
    fwd, _ = attention_work(q, k, causal=causal, window=window, q_offset=0)
    B, Sq, Hq, _ = q.shape
    return int(2.5 * fwd), (4 * q.numel() * q.element_size()
                            + 4 * k.numel() * k.element_size()
                            + 4 * B * Hq * Sq)


def rwkv_flops(B, S, H, C):
    """FLOPs of the chunked RWKV-6 time mix (head size 64): per chunk the
    inter-chunk product, the strictly-lower scores and their weighted
    sum, the bonus and the state update; each exp counted as one."""
    hd, n = 64, B * H * (S // C)
    low = C * (C - 1) // 2
    per_chunk = (2 * C * hd * hd            # (r * A) @ S
                 + 4 * low * hd             # scores: r*k*exp(.) and sum
                 + 2 * low * hd             # scores @ v
                 + 5 * C * hd               # bonus
                 + 3 * C * hd + 2 * C * hd  # logw, rdec, kdec
                 + 2 * C * hd * hd + 2 * hd * hd)   # state update
    return n * per_chunk


def rwkv_bwd_flops(B, S, H, C):
    """FLOPs of the chunked RWKV-6 time mix's backward (head size 64): per
    chunk dP and the scores (with their decays), dr's and dk's
    inter-token sums, the products with the start state and its gradient
    (dr's S dy, dk's dS v, dv's kdec dS, the gradient's update, S . dS),
    dv's scores product, the decay scan and the per-position terms; each
    exp counted as one."""
    hd, n = 64, B * H * (S // C)
    low = C * (C - 1) // 2
    per_chunk = (2 * (low + C) * hd        # dP
                 + 4 * low * hd + 3 * C * hd   # scores and the bonus
                 + 2 * 4 * low * hd         # dr's and dk's inter-token sums
                 + 4 * 2 * C * hd * hd      # S dy, dS v, kdec dS, the update
                 + 3 * hd * hd              # S . dS, the update's scale
                 + 2 * (low + C) * hd       # dv's scores product
                 + 12 * C * hd)             # scan, decays, terms, dw, du
    return n * per_chunk


def mamba_scan_work(B, S, E, N, *, states: bool = False,
                    backward: bool = False) -> tuple:
    """(FLOPs, exponentials, bytes) of Mamba's selective scan over x [B,
    S, E] with N states a channel, each input read once and each output
    written once.  Forward, a state element a token: dt A, the drive's
    product with x, the update's multiply and add, y's product and sum (6
    FLOPs) and the decay (1 exponential); x and y, dt, B, C, A, h0 and
    the final state, with ``states`` the checkpoints every 16 tokens.
    Backward: the states again from the checkpoints (4 FLOPs and the
    decay: 1 exponential, which the reverse walk needs), then g, dB's,
    dC's, dx's and dA's shares and sums (2 each), ddt's (5), the carried
    gradient and dt A (1 each): 21 FLOPs; x, dy and dx, dt and ddt, B, C,
    dB and dC, A and dA, the checkpoints, the final state's gradient and
    dh0."""
    el = B * S * E * N
    tok = 4 * B * S * (1 + 2 * N)           # dt, B, C (or their grads)
    state = 4 * B * E * N
    ckpt = 4 * B * -(-S // 16) * E * N
    if backward:
        return (21 * el, el,
                3 * 4 * B * S * E + 2 * tok + 2 * 4 * E * N + ckpt
                + 2 * state)
    return (6 * el, el, 2 * 4 * B * S * E + tok + 4 * E * N + 2 * state
            + (ckpt if states else 0))


def mamba_scan_bound(flops, exps, nbytes_):
    """The least time the card takes for the scan's work, and what bounds
    it: its f32 FLOPs, its exponentials (``EXP_PER_S``) or its bytes."""
    t_ops = max(flops / PEAK_FLOPS["f32"], exps / EXP_PER_S) * 1e3
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def bound_ms(flops, nbytes_, kind):
    """The least time the card takes for the work, and what bounds it:
    the FLOPs at ``kind``'s peak rate or the bytes at the memory rate."""
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def family_flops(model, cfg, B, S, Te) -> tuple:
    """Model FLOPs of one train step: 6 N D over the weights that enter a
    product (not the embedding table, a gather; not RWKV-6's mixing
    coefficients ``t_mix``, elementwise, nor its ``wo``, whose row sums
    scale the channels; MoE routed experts at ``top_k / n_experts`` of
    their parameters, the active share; the encoder's weights over the
    frames, the rest over the tokens), plus attention's forward and its
    backward at 2.5x the forward and the RWKV-6 time mix's forward and
    backward kernels' FLOPs, and the Mamba scan's forward and backward
    (an exponential counted as a FLOP; Mamba's ``A_log`` and ``conv_w``
    are elementwise, not products); remat's recomputation not counted.
    Attention's terms count the model's attention layers.  Returns
    (FLOPs, parameters in products)."""
    n_gemm, flops = 0, 0.0
    for name, p in model.named_parameters():
        if p.ndim < 2 or name == "embed" or name.endswith(
                ("t_mix", "tmix.wo", "A_log", "conv_w")):
            continue
        n = p.numel()
        if ".moe.w_" in name:
            n = n * cfg.moe.top_k / cfg.moe.n_experts
        n_gemm += n
        flops += 6 * n * B * (Te if name.startswith("enc_blocks") else S)

    def attn(sq, sk, causal):
        pairs, _, _ = attention_pairs(sq, sk, causal=causal, window=0,
                                      q_offset=0)
        return 3.5 * 4 * B * cfg.n_heads * cfg.d_head * pairs
    if cfg.family == "rwkv":
        H = cfg.d_model // 64
        flops += cfg.n_layers * (rwkv_flops(B, S, H, 16)
                                 + rwkv_bwd_flops(B, S, H, 16))
    elif cfg.family == "encdec":
        flops += cfg.n_enc_layers * attn(Te, Te, False) + cfg.n_layers * (
            attn(S, S, True) + attn(S, Te, False))
    else:
        kinds = [blk.kind for blk in model.blocks]
        flops += sum(k.startswith("attn") for k in kinds) * attn(S, S, True)
        for k in kinds:
            if k.startswith("mamba"):
                for bwd in (False, True):
                    f, x, _ = mamba_scan_work(B, S, 2 * cfg.d_model,
                                              cfg.d_state, backward=bwd)
                    flops += f + x
    return flops, int(n_gemm)
