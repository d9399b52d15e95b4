"""Plain torch versions of the kernels (and of ``weighted_sample``,
``spritz_select``'s kernel without its buffer front).

Each tick kernel's version mirrors its oracle in ``repro.kernels.ref``
operation for operation, so it is bit-identical to the reference on any
device.  The model kernels' versions (attention, RWKV-6) are f32 and
held to the tolerances of ``tests/test_kernels.py``; ``mha_partials``
and ``combine_partials`` spell out the attention kernel's split path,
``mha_lse`` its row log-sum-exp and ``mha_backward_reference`` the
backward kernel's formula; ``mamba_scan_reference`` is Mamba's token
loop and ``mamba_scan_backward_reference`` its reverse recurrence.
``ops`` calls these for tensors on the CPU;
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch._parity import (f32, fold_in, red_recip, split, uniforms,
                                 xla_cumsum_f32)

_TINY = f32(1e-30)


def spritz_select_reference(w, u, buf_front, packet_count, *,
                            explore_threshold: int):
    """Spritz Algorithm 1's selection core: weighted sample from the
    row prefix sum, explore counter, buffer front."""
    sampled = _sample(w, u)
    explore = packet_count >= explore_threshold
    use_buffer = ~explore & (buf_front >= 0)
    ev = torch.where(use_buffer, buf_front, sampled.to(torch.int32))
    new_count = torch.where(explore, 0, packet_count + 1)
    return ev, new_count.to(torch.int32), use_buffer


def _sample(w, u):
    """Each row's weighted index on its uniform ``u`` [F]: the count of
    prefix sums below ``u`` times the row total, at most P - 1."""
    csum = xla_cumsum_f32(w.float())
    uu = u * csum[:, -1].clamp_min(_TINY)
    return (csum < uu[:, None]).sum(1).clamp_max(w.shape[1] - 1)


def weighted_sample_reference(w, rng, t):
    """The tick's path draw ``u_path`` (:func:`tick_draws_reference`),
    then each row's weighted sample on it, int32 [F]: the reference's
    ``weighted_sample_rows`` on the tick's ``k_path``."""
    u_path = tick_draws_reference(rng, t, n_flows=w.shape[0], n_cand=0)[0]
    return _sample(w, u_path[:, 0]).to(torch.int32)


def tick_draws_reference(rng, t, *, n_flows: int, n_cand: int):
    """The tick's keys ``split(fold_in(rng, t), 2)`` and the two draws on
    them: ``u_path`` [n_flows, 1] and ``unif`` [n_cand], f32 uniforms as
    ``jax.random.uniform`` draws them.  ``rng`` is [2] int64 (uint32
    words) and ``t`` a 0-d integer tensor, both on the output device."""
    k_path, k_mark = split(fold_in((rng[0], rng[1]), t), 2)
    return tuple(uniforms([(k_path, (n_flows, 1)), (k_mark, (n_cand,))],
                          rng.device))


def red_ecn_reference(eport, rank, enq, unif, q_tail, t, *, qsize,
                      kmin, kmax, n_ports):
    """Occupancy, trim, RED/ECN mark and service slot per candidate; the
    tick ``t`` is an int or a 0-d int32 tensor on the inputs' device."""
    tail = q_tail[eport.clamp_max(n_ports - 1)]
    occ = (tail - t).clamp_min(0) + rank
    trim = enq & (occ >= qsize)
    accept = enq & ~trim
    pr = ((occ.float() - f32(kmin)) * red_recip(kmin, kmax)).clamp(0.0, 1.0)
    mark = accept & (unif < pr)
    slot = tail.clamp_min(t) + rank + 1
    return occ, trim, mark, torch.where(accept, slot, 0)


def tick_rank_reference(port, *, n_ports: int):
    """Position among equal port values, ordered by index (a stable
    segmented rank).  Entries outside ``[0, n_ports)`` share one
    overflow bucket."""
    port_c = torch.where((port < 0) | (port >= n_ports), n_ports, port)
    oh = port_c[:, None] == torch.arange(n_ports + 1, dtype=torch.int32,
                                         device=port.device)[None, :]
    pos = torch.cumsum(oh.to(torch.int32), 0, dtype=torch.int32) * oh
    return (pos.sum(-1) - 1).clamp_min(0).to(torch.int32)


def flow_agg_reference(rows, pflow, *, n_flows: int):
    """``out[k, f] = sum(rows[k, pflow == f])`` as one one-hot product
    (integer counts below 2**24 are exact in f32)."""
    oh = (pflow[:, None] == torch.arange(n_flows, dtype=torch.int32,
                                         device=pflow.device)[None, :])
    return (rows.float() @ oh.float()).to(torch.int32)


def _masked_scores(q, k, *, causal: bool, sliding_window: int,
                   q_offset: int):
    """f32 scores [B, Hkv, G, Sq, Sk] = q . k / sqrt(D), the masked ones
    at -1e30 as in the reference."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if sliding_window:
        mask &= kpos[None, :] > qpos[:, None] - sliding_window
    return s.masked_fill(~mask, -1e30)


def mha_reference(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                  q_offset: int = 0):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] (GQA: query head h reads
    kv head h // G) -> [B, Sq, Hq, D] in q's dtype.  f32 softmax; masked
    scores are -1e30, as in the reference."""
    B, Sq, Hq, D = q.shape
    p = torch.softmax(_masked_scores(q, k, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=q_offset), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def mha_lse(q, k, *, causal: bool = True, sliding_window: int = 0,
            q_offset: int = 0):
    """Row log-sum-exp of the scaled, masked scores: f32 [B, Hq, Sq],
    ``lse[b, h, i] = log sum_j exp(q_i . k_j / sqrt(D))`` over the keys
    row i may see (the attention kernel's second output)."""
    B, Sq, Hq, _ = q.shape
    s = _masked_scores(q, k, causal=causal, sliding_window=sliding_window,
                       q_offset=q_offset)
    return torch.logsumexp(s, -1).reshape(B, Hq, Sq)


def mha_backward_reference(q, k, v, o, lse, do, *, causal: bool = True,
                           sliding_window: int = 0):
    """Attention's gradient by the explicit formula, in f32: ``P = exp(S -
    lse)``, ``dV = P^T dO``, ``dS = P (dO V^T - rowsum(dO o O))``, ``dQ =
    dS K / sqrt(D)``, ``dK = dS^T Q / sqrt(D)``, dK and dV summed over each
    kv head's group of G query heads.  q, o, do: [B, Sq, Hq, D]; k, v:
    [B, Sk, Hkv, D]; lse: f32 [B, Hq, Sq] (:func:`mha_lse`).  Query row
    i sits at position i.  Returns (dq, dk, dv) in the inputs' dtypes.
    A masked score is -1e30, so its P is exactly 0; a row that sees no
    key at all (only when Sq > Sk, or with a window) has no gradient
    here, where the softmax of its equal scores would give it one."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, causal=causal, sliding_window=sliding_window,
                       q_offset=0)                      # [B, Hkv, G, Sq, Sk]
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq, 1))
    og, dog = (t.reshape(B, Sq, Hkv, G, D).float() for t in (o, do))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    # rowsum(dO o O), [B, Hkv, G, Sq, 1]
    di = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - di)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.reshape(B, Sq, Hkv, G, D).float()) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def mha_partials(q, k, v, bounds, *, causal: bool = True,
                 sliding_window: int = 0, q_offset: int = 0):
    """The split path's first pass: for each key range ``[lo, hi)`` of
    ``bounds``, the f32 partials of every row over the keys of that range
    alone (keys outside it, and past Sk, weigh nothing).  Returns (m, l,
    acc): m, l [n_split, B, Sq, Hq] and acc [n_split, B, Sq, Hq, D], where
    m is the running max from -1e30 of the masked scores, ``l = sum
    exp(s - m)`` and ``acc = sum exp(s - m) v``."""
    B, Sq, Hq, D = q.shape
    s = _masked_scores(q, k, causal=causal, sliding_window=sliding_window,
                       q_offset=q_offset)
    kpos = torch.arange(k.shape[1], device=q.device)

    def rows(x):                             # [B, Hkv, G, Sq] -> [B, Sq, Hq]
        return x.permute(0, 3, 1, 2).reshape(B, Sq, Hq)
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        si = s.masked_fill(~((kpos >= lo) & (kpos < hi)), -math.inf)
        m = si.amax(-1).clamp_min(-1e30)
        p = torch.exp(si - m[..., None])
        ms.append(rows(m))
        ls.append(rows(p.sum(-1)))
        accs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
                    .reshape(B, Sq, Hq, D))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m, l, acc):
    """The split path's second pass: ``O = sum_s e^(m_s - m*) acc_s /
    max(sum_s e^(m_s - m*) l_s, 1e-30)`` with ``m* = max_s m_s``; f32
    [B, Sq, Hq, D] from :func:`mha_partials`' output."""
    w = torch.exp(m - m.amax(0))
    den = (w * l).sum(0).clamp_min(1e-30)
    return (w[..., None] * acc).sum(0) / den[..., None]


def _rwkv_chunks(a, n: int, C: int):
    """[B, S, H, hd] -> [n, B, C, H, hd]: the chunks of ``a``."""
    B, _, H, hd = a.shape
    return a.reshape(B, n, C, H, hd).transpose(0, 1)


def _rwkv_decays(lwc):
    """``(L, Lprev, L_C)`` of one chunk's log2 decays [B, C, H, hd]: the
    prefix sums over the chunk, the same one token earlier (0 for the
    first), and the chunk's total [B, H, hd]."""
    L = torch.cumsum(lwc, 1)
    Lprev = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], 1)
    return L, Lprev, L[:, -1]


def _pair_decays(L, Lprev):
    """``2^(Lprev_t - L_s)`` [B, C(t), C(s), H, hd] for the pairs s < t,
    0 elsewhere: the exponents of the other pairs are positive and are
    never raised (they could overflow)."""
    C = L.shape[1]
    idx = torch.arange(C, device=L.device)
    below = (idx[None, :] < idx[:, None])[None, :, :, None, None]
    return torch.exp2((Lprev[:, :, None] - L[:, None, :])
                      .masked_fill(~below, -math.inf))


def rwkv6_chunked_reference(r, k, v, w, u, wkv0, *, chunk: int = 16,
                            states: bool = False):
    """Chunked RWKV-6 recurrence in f32, in the CUDA kernel's arithmetic
    (the reference's ``models.ssm.rwkv6_chunked_jnp`` in the log2
    domain): per chunk, with ``L`` the prefix sum of ``log2(w)`` and
    ``Lprev`` the same sum one token earlier, the scores ``P[t, s] =
    sum_c r_t k_s 2^(Lprev_t - L_s)`` for s < t (stable: <= 1), the ``u``
    bonus ``r_t . (u * k_t)`` as their diagonal, ``y = (r * 2^Lprev) @ S
    + P @ V`` and ``S' = diag(2^L_C) S + (k * 2^(L_C - L))^T V``.

    r, k, v, w: [B, S, H, hd]; u: [H, hd]; wkv0: [B, H, hd, hd].  Returns
    (y [B, S, H, hd] f32, wkv_final f32), and with ``states`` also the
    state at the start of each chunk, f32 [B, H, n_chunks, hd, hd] (the
    first is wkv0), which :func:`rwkv6_chunked_backward_reference`
    takes."""
    B, S, H, hd = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"chunk {C} does not divide S = {S}")
    n = S // C
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    log2w = torch.log2(w.clamp_min(1e-30))
    rc, kc, vc, lw = (_rwkv_chunks(a, n, C) for a in (r, k, v, log2w))
    idx = torch.arange(C, device=r.device)
    diag = (idx[None, :] == idx[:, None])[None, :, :, None, None]
    S0 = wkv0.float()
    ys, starts = [], []
    for i in range(n):
        rr, kk, vv = rc[i], kc[i], vc[i]                      # [B,C,H,hd]
        L, Lprev, LC = _rwkv_decays(lw[i])
        starts.append(S0)
        y = torch.einsum("bthk,bhkv->bthv", rr * torch.exp2(Lprev), S0)
        D = _pair_decays(L, Lprev) + torch.where(diag, u[None, None, None],
                                                 0.0)
        P = torch.einsum("bthc,bshc,btshc->btsh", rr, kk, D)
        y = y + torch.einsum("btsh,bshv->bthv", P, vv)
        kdec = kk * torch.exp2(LC[:, None] - L)
        S0 = torch.exp2(LC)[..., None] * S0 + \
            torch.einsum("bshk,bshv->bhkv", kdec, vv)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, S, H, hd)
    if states:
        return y, S0, torch.stack(starts, 2)
    return y, S0


def rwkv6_chunked_backward_reference(r, k, v, w, u, states, dy, dwkv=None,
                                     *, chunk: int = 16):
    """The gradient of :func:`rwkv6_chunked_reference`, in f32, written
    out chunk by chunk in reverse in the same log2 arithmetic (the
    backward kernel's formula).  r, k, v, w, dy: [B, S, H, hd]; u: [H,
    hd]; states: the forward's chunk-start states [B, H, n_chunks, hd,
    hd] (``states[:, :, 0]`` is wkv0); dwkv: the gradient of the final
    state [B, H, hd, hd], or None for 0.  Returns (dr, dk, dv, dw [B, S,
    H, hd], du [H, hd], dwkv0 [B, H, hd, hd]), all f32.

    Per chunk, dS the gradient of the chunk's end state and dP = dy v^T:
    ``dr_t = 2^Lprev_t (S dy_t) + sum_{s<t} dP_ts k_s 2^(Lprev_t - L_s) +
    dP_tt u k_t``; ``dk_s = sum_{t>s} dP_ts r_t 2^(Lprev_t - L_s) + dP_ss
    u r_s + 2^(L_C - L_s) (dS v_s)``; ``dv_s = sum_{t>=s} P_ts dy_t +
    (k_s 2^(L_C - L_s)) dS``; ``du = sum dP_tt r_t k_t``; the start
    state's gradient ``diag(2^L_C) dS + (r 2^Lprev)^T dy``.  The decays
    enter through ``log2 w``, whose gradient (per channel, times ln 2)
    is the reverse prefix sum over the chunk of the terms each position
    puts on the ``L_t`` (``-k_t`` times dk's inter-token and state
    parts) and on the ``Lprev_t`` after it (``r_t`` times dr's), plus the
    chunk total's term ``2^L_C (S . dS) + sum_s k_s 2^(L_C - L_s) (dS
    v_s)``; only the end divides by ``w ln 2``.  ``w`` below 1e-30 has
    no gradient (the forward clamps it there)."""
    B, S, H, hd = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"chunk {C} does not divide S = {S}")
    n = S // C
    r, k, v, w, u, dy = (a.float() for a in (r, k, v, w, u, dy))
    log2w = torch.log2(w.clamp_min(1e-30))
    rc, kc, vc, lw, dyc = (_rwkv_chunks(a, n, C)
                           for a in (r, k, v, log2w, dy))
    dS = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if dwkv is None else dwkv.float().clone())
    idx = torch.arange(C, device=r.device)
    lower = (idx[None, :] <= idx[:, None])[None, :, :, None]  # s <= t
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    grads = [[None] * n for _ in range(4)]
    for i in reversed(range(n)):
        rr, kk, vv, dd = rc[i], kc[i], vc[i], dyc[i]          # [B,C,H,hd]
        S0 = states[:, :, i].float()
        L, Lprev, LC = _rwkv_decays(lw[i])
        A = torch.exp2(LC)                                    # [B,H,hd]
        D = _pair_decays(L, Lprev)                            # s < t only
        P = torch.einsum("bthc,bshc,btshc->btsh", rr, kk, D)
        bonus = (rr * u * kk).sum(-1)                         # [B,C,H]
        dP = torch.einsum("bthv,bshv->btsh", dd, vv) * lower
        dPd = torch.diagonal(dP, dim1=1, dim2=2).transpose(1, 2)  # [B,C,H]
        inter = torch.exp2(Lprev) * torch.einsum("bthv,bhkv->bthk", dd, S0)
        intra_r = torch.einsum("btsh,bshc,btshc->bthc", dP, kk, D)
        intra_k = torch.einsum("btsh,bthc,btshc->bshc", dP, rr, D)
        kdec = kk * torch.exp2(LC[:, None] - L)
        sk = torch.exp2(LC[:, None] - L) * \
            torch.einsum("bshv,bhkv->bshk", vv, dS)
        grads[0][i] = inter + intra_r + dPd[..., None] * u * kk
        grads[1][i] = intra_k + dPd[..., None] * u * rr + sk
        Pd = P + torch.diag_embed(bonus.transpose(1, 2), dim1=1, dim2=2)
        grads[2][i] = torch.einsum("btsh,bthv->bshv", Pd, dd) + \
            torch.einsum("bshk,bhkv->bshv", kdec, dS)
        du += (dPd[..., None] * rr * kk).sum((0, 1))
        # log2 w's gradient over ln 2: xp on Lprev_t (to s < t), xl on L_t
        # (to s <= t), the chunk total's term on every s
        xp = rr * (inter + intra_r)
        xl = -kk * (intra_k + sk)
        tot = A * (S0 * dS).sum(-1) + (kk * sk).sum(1)        # [B,H,hd]
        g = torch.flip(torch.cumsum(torch.flip(xl + xp, (1,)), 1), (1,))
        grads[3][i] = (g - xp + tot[:, None]) * math.log(2.0)
        dS = A[..., None] * dS + torch.einsum(
            "bthk,bthv->bhkv", rr * torch.exp2(Lprev), dd)
    dr, dk, dv, g2 = (torch.stack(g, 1).reshape(B, S, H, hd) for g in grads)
    dw = torch.where(w >= _TINY, g2 / (w * math.log(2.0)), 0.0)
    return dr, dk, dv, dw, du, dS


def rwkv6_reference(r, k, v, w, u, wkv0):
    """Sequential RWKV-6 recurrence in f32, one token per step:
    ``y_t = r_t (S + u * k_t v_t^T)``, ``S = diag(w_t) S + k_t v_t^T``.

    r, k, v, w: [B, S, H, hd]; u: [H, hd]; wkv0: [B, H, hd, hd].  Returns
    (y [B, S, H, hd], wkv_final).  The model's decode step runs this."""
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    wkv = wkv0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               wkv + u[None, :, :, None] * kv))
        wkv = w[:, t, :, :, None] * wkv + kv
    return torch.stack(ys, 1), wkv


MAMBA_SEGMENT = 16   # tokens between the Mamba scan's checkpoint states


def mamba_scan_reference(x, dt, A, Bm, Cm, h0, *, states: bool = False):
    """Mamba's selective scan, one token a step, out of place (so autograd
    differentiates it): ``h_t = exp(dt_t A) h_{t-1} + (dt_t B_t) x_t``,
    ``y_t = sum_n h_t C_t``.  x: [B, S, E]; dt: [B, S]; A: [E, N]; Bm,
    Cm: [B, S, N]; h0: [B, E, N]; all f32.  Returns (y [B, S, E], the
    final state), with ``states`` also the state before every
    ``MAMBA_SEGMENT``-th token, [B, ceil(S / 16), E, N] (the kernel's
    checkpoints)."""
    h, ys, marks = h0, [], []
    for t in range(x.shape[1]):
        if states and t % MAMBA_SEGMENT == 0:
            marks.append(h)
        d = dt[:, t, None, None]
        h = torch.exp(d * A) * h + (d * Bm[:, t, None, :]) * x[:, t, :, None]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1)
    return (y, h, torch.stack(marks, 1)) if states else (y, h)


def mamba_scan_backward_reference(x, dt, A, Bm, Cm, h0, dy, dh_final=None):
    """The scan's gradient, the reverse recurrence written out: with ``G``
    the gradient reaching h_t from later tokens (``dh_final`` at the end,
    None for 0), ``a_t = exp(dt_t A)`` and ``g = G + dy_t C_t``:
    ``dx_t = dt_t sum_n g B_t``, ``dB_t = dt_t sum_e g x_t``, ``dC_t =
    sum_e dy_t h_t``, ``ddt_t = sum (g B_t x_t + g h_{t-1} a_t A)``,
    ``dA = sum_{b,t} g h_{t-1} a_t dt_t``, ``G <- a_t g``; ``dh0`` the
    last G.  Shapes as :func:`mamba_scan_reference`'s, dy [B, S, E].
    Returns ``(dx, ddt, dA, dB, dC, dh0)``."""
    hs = [h0]
    for t in range(x.shape[1]):
        d = dt[:, t, None, None]
        hs.append(torch.exp(d * A) * hs[-1]
                  + (d * Bm[:, t, None, :]) * x[:, t, :, None])
    G = torch.zeros_like(h0) if dh_final is None else dh_final
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), \
        torch.empty_like(Cm)
    ddt, dA = torch.empty_like(dt), torch.zeros_like(A)
    for t in reversed(range(x.shape[1])):
        d = dt[:, t, None, None]
        a = torch.exp(d * A)
        bt, xt = Bm[:, t, None, :], x[:, t, :, None]
        g = G + dy[:, t, :, None] * Cm[:, t, None, :]
        dC[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        dB[:, t] = (g * d * xt).sum(1)
        dx[:, t] = (g * d * bt).sum(-1)
        ga = g * hs[t] * a
        ddt[:, t] = (g * bt * xt).sum((1, 2)) + (ga * A).sum((1, 2))
        dA += (ga * d).sum(0)
        G = a * g
    return dx, ddt, dA, dB, dC, G
