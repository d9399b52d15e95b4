"""Wrappers of the eleven CUDA kernels (four tick kernels, the tick's
random draws, attention, attention's backward, the chunked RWKV-6 time
mix and its backward, Mamba's selective scan and its backward), of the
fused launch of two of them
(``tick_rank_red_ecn``: the rank and the RED/ECN stage on it) and of
``spritz_select``'s kernel without its buffer front
(``weighted_sample``).  The fused launch and the samplers can draw the
tick's uniforms themselves (``rng=``), as the engine's path does.

Each wrapper checks its inputs, then either launches its kernel on the
current CUDA stream (tensors on the card) or calls the kernel's plain
version in :mod:`repro_torch.kernels.ref` (tensors on the CPU, the
analogue of Pallas interpret mode).  There is no fallback: a tensor on
the card runs the kernel or raises.  The model kernels' wrappers
(attention, RWKV-6, the Mamba scan and their backwards) also take
tensors on the ``meta`` device, the dry run's (``launch/dryrun.py``):
they return empty
``meta`` outputs with the shapes, dtypes and scratch buffers of the card
path, launch nothing and credit the call's work from
:mod:`repro_torch.kernels.work` (the plain versions would materialise
scores and per-token loops the kernels never hold).  The tick kernels
refuse ``meta``.  ``LAUNCHES`` counts kernel launches
per wrapper, so a run can show that it went through the kernels;
``FLASH_PATHS``, ``FLASH_BWD_PATHS`` and ``TICK_RANK_PATHS`` count the
path each launch took.
"""
from __future__ import annotations

import math

import torch

from repro_torch._parity import f32, red_recip
from repro_torch.kernels import _build
from repro_torch.kernels import ref as R
from repro_torch.kernels import work

LAUNCHES = dict.fromkeys(("flow_agg", "tick_rank", "red_ecn",
                          "tick_rank_red_ecn", "tick_draws", "spritz_select",
                          "weighted_sample",
                          "flash_attention", "flash_attention_bwd",
                          "rwkv6_chunked", "rwkv6_chunked_bwd",
                          "mamba_scan", "mamba_scan_bwd"), 0)
# flash_attention launches by the path the kernel took (see flash_plan)
FLASH_PATHS = dict.fromkeys(("wgmma", "split", "simt"), 0)
# flash_attention_bwd launches by the path the kernel took (see
# flash_bwd_plan)
FLASH_BWD_PATHS = dict.fromkeys(("wgmma", "simt"), 0)
# tick_rank and tick_rank_red_ecn launches by the path the kernel took
# (see tick_rank_plan)
TICK_RANK_PATHS = dict.fromkeys(("smem", "pairwise"), 0)
_FLASH_CODES = {"simt": 0, "wgmma": 1, "split": 2}   # both kernels' paths
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_ROWS = 64          # rows of the wgmma path's Q tile
SPLIT_ROWS = 16          # most rows (Sq * G) the split path takes
SPLIT_KEYS = 64          # a split holds a multiple of this many keys
SMEM_OPTIN = 232_448     # dynamic shared memory a block may opt in to (sm_90)
H100_SMS = 132           # the H100 SXM's SMs: the split plan on ``meta``
TICK_RANK_SEGS = 16      # most segments of tick_rank's smem path (its warps)
TICK_RANK_BALANCE = 96   # segments ~ sqrt(this * M / buckets): walk vs passes
MAMBA_STATES = 16        # d_state the Mamba scan kernel takes
MAMBA_CHANNELS = 64      # channels a block of its backward (the partials)
# row types the flow_agg kernel reads, by their size in bytes
_AGG_ROWS = {torch.int32: 4, torch.bool: 1, torch.uint8: 1}


_COUNTERS = {"LAUNCHES": LAUNCHES, "FLASH_PATHS": FLASH_PATHS,
             "FLASH_BWD_PATHS": FLASH_BWD_PATHS,
             "TICK_RANK_PATHS": TICK_RANK_PATHS}


def reset_launches() -> None:
    for counts in _COUNTERS.values():
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    """A copy of every launch and path count, by counter and key."""
    return {name: dict(counts) for name, counts in _COUNTERS.items()}


def set_launch_counts(saved: dict) -> None:
    """Restore a :func:`launch_counts` copy.  A CUDA graph's capture
    calls the wrappers without launching anything: the engine's loop
    puts the counts back after it, and credits each replay with the
    launches the capture recorded (:func:`add_launches`)."""
    for name, counts in _COUNTERS.items():
        counts.update(saved[name])


def add_launches(per_replay: dict, replays: int) -> None:
    """Count ``replays`` replays of a captured graph whose capture
    recorded ``per_replay`` launches (a :func:`launch_counts` delta)."""
    for name, counts in _COUNTERS.items():
        for k, n in per_replay[name].items():
            counts[k] += n * replays


def _where(*ts: torch.Tensor, meta: bool = False) -> str:
    """``"cpu"`` (the plain version), ``"cuda"`` (the kernel; inputs
    contiguous) or, with ``meta``, ``"meta"`` (shapes only: the dry
    run's); any other device, or a mix, raises."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu" or (meta and dev.type == "meta"):
        return dev.type
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")
    return "cuda"


def _on_cpu(*ts: torch.Tensor) -> bool:
    return _where(*ts) == "cpu"


def _dtype(t: torch.Tensor, want: torch.dtype, name: str) -> None:
    if t.dtype != want:
        raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _launch(name: str, *args) -> None:
    err = _build.library(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flow_agg(rows: torch.Tensor, pflow: torch.Tensor, *, n_flows: int):
    """rows: [K, N] int32, bool or uint8; pflow: [N] int32.  Returns [K,
    n_flows] int32 ``out[k, f] = sum(rows[k, pflow == f])``; a pflow
    outside ``[0, n_flows)`` adds nothing."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be 2-D [K, N], got shape {tuple(rows.shape)}")
    if pflow.ndim != 1 or rows.shape[1] != pflow.shape[0]:
        raise ValueError(f"rows/pflow length mismatch: {tuple(rows.shape)} "
                         f"vs {tuple(pflow.shape)}")
    if rows.dtype not in _AGG_ROWS:
        raise ValueError(f"rows must be int32, bool or uint8, got "
                         f"{rows.dtype}")
    _dtype(pflow, torch.int32, "pflow")
    if n_flows < 1:
        raise ValueError(f"n_flows must be >= 1, got {n_flows}")
    if _on_cpu(rows, pflow):
        return R.flow_agg_reference(rows, pflow, n_flows=n_flows)
    K, N = rows.shape
    out = torch.zeros((K, n_flows), dtype=torch.int32, device=rows.device)
    _launch("flow_agg", rows.data_ptr(), pflow.data_ptr(), out.data_ptr(),
            K, N, n_flows, _AGG_ROWS[rows.dtype])
    return out


def tick_rank(port: torch.Tensor, *, n_ports: int):
    """port: [M] int32.  Returns [M] int32, the position among equal
    ports in index order; ports outside ``[0, n_ports)`` share one
    overflow bucket."""
    _check_candidates(n_ports, port=port)
    if _on_cpu(port):
        return R.tick_rank_reference(port, n_ports=n_ports)
    rank = torch.empty_like(port)
    path, segs, _ = tick_rank_plan(port.shape[0], n_ports)
    if path == "none":
        return rank
    _launch("tick_rank", port.data_ptr(), rank.data_ptr(), port.shape[0],
            n_ports, segs)
    TICK_RANK_PATHS[path] += 1
    return rank


def tick_rank_plan(M: int, n_ports: int) -> tuple[str, int, int]:
    """The rank kernel's path for ``M`` entries over ``n_ports`` ports,
    as ``(path, segs, smem_bytes)``.

    ``"smem"``: one block walks ``segs`` contiguous segments of ``[0,
    M)``, one a warp, with a row of ``n_ports + 1`` counts each (padded
    to a multiple of 4) in ``smem_bytes`` of shared memory.  More
    segments shorten the rank walk (``M / (32 segs)`` warp steps) and
    lengthen the zero fill and the scan (passes over the rows), so
    ``segs`` is about ``sqrt(TICK_RANK_BALANCE * M / (n_ports + 1))``,
    at most ``TICK_RANK_SEGS``, as many rows as ``SMEM_OPTIN`` holds and
    no empty segment.  ``"pairwise"``: not even one row fits; every
    entry compares against all earlier ones.  ``"none"``: M = 0, nothing
    to launch."""
    if M < 0 or n_ports < 1:
        raise ValueError(f"tick_rank_plan: need M >= 0 and n_ports >= 1, "
                         f"got M={M}, n_ports={n_ports}")
    if M == 0:
        return "none", 0, 0
    stride = -(-(n_ports + 1) // 4) * 4
    fit = SMEM_OPTIN // (4 * stride)
    if fit < 1:
        return "pairwise", 0, 0
    want = round(math.sqrt(TICK_RANK_BALANCE * M / (n_ports + 1)))
    segs = max(1, min(want, fit, TICK_RANK_SEGS))
    seg_len = -(-(-(-M // segs)) // 32) * 32       # the kernel's rounding
    segs = -(-M // seg_len)
    return "smem", segs, segs * stride * 4


_CANDIDATE_TYPES = {"port": torch.int32, "eport": torch.int32,
                    "rank": torch.int32, "enq": torch.bool,
                    "unif": torch.float32}


def _check_candidates(n_ports: int, q_tail=None, **cands) -> None:
    """The [M] per-candidate inputs of the rank and RED/ECN wrappers
    (1-D, one length, their types) and ``q_tail`` [n_ports] int32."""
    if any(c.ndim != 1 for c in cands.values()):
        raise ValueError(f"{'/'.join(cands)} must be 1-D, got shapes "
                         f"{[tuple(c.shape) for c in cands.values()]}")
    if len({c.shape for c in cands.values()}) != 1:
        raise ValueError("ragged inputs: " + ", ".join(
            f"{k} {tuple(c.shape)}" for k, c in cands.items()))
    for k, c in cands.items():
        _dtype(c, _CANDIDATE_TYPES[k], k)
    if n_ports < 1:
        raise ValueError(f"n_ports must be >= 1, got {n_ports}")
    if q_tail is not None:
        _dtype(q_tail, torch.int32, "q_tail")
        if tuple(q_tail.shape) != (n_ports,):
            raise ValueError(f"q_tail shape {tuple(q_tail.shape)} != "
                             f"(n_ports,) = ({n_ports},)")


def _tick(t, device: torch.device):
    """The tick of the RED/ECN wrappers as a 0-d int32 tensor on
    ``device``: a tensor given is checked and passed on (the kernels read
    it from device memory, so a captured graph reads the value of each
    replay), an int is copied there."""
    if not isinstance(t, torch.Tensor):
        return torch.tensor(int(t), dtype=torch.int32, device=device)
    if t.ndim != 0 or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"t must be an int or a 0-d int32 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t


def red_ecn(eport, rank, enq, unif, q_tail, t, *, qsize: int,
            kmin: float, kmax: float, n_ports: int):
    """eport/rank: [M] int32; enq: [M] bool; unif: [M] f32; q_tail:
    [n_ports] int32; t: the tick, an int or a 0-d int32 tensor on the
    inputs' device.  Returns (occ int32, trim bool, mark bool, slot
    int32), each [M]."""
    _check_candidates(n_ports, q_tail, eport=eport, rank=rank, enq=enq,
                      unif=unif)
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=n_ports)
    t = _tick(t, eport.device)
    if _on_cpu(eport, rank, enq, unif, q_tail):
        return R.red_ecn_reference(eport, rank, enq, unif, q_tail, t, **kw)
    M = eport.shape[0]
    occ, slot = torch.empty_like(eport), torch.empty_like(eport)
    trim, mark = torch.empty_like(enq), torch.empty_like(enq)
    _launch("red_ecn", eport.data_ptr(), rank.data_ptr(), enq.data_ptr(),
            unif.data_ptr(), q_tail.data_ptr(), t.data_ptr(), int(qsize),
            f32(kmin), red_recip(kmin, kmax), n_ports, M, occ.data_ptr(),
            trim.data_ptr(), mark.data_ptr(), slot.data_ptr())
    return occ, trim, mark, slot


def tick_rank_red_ecn(port, enq, unif=None, q_tail=None, t=None, *,
                      rng=None, qsize: int, kmin: float, kmax: float,
                      n_ports: int):
    """:func:`tick_rank` of ``port``, then :func:`red_ecn` on that rank
    (``eport`` = ``port``), in one launch that keeps only what the
    engine reads.  port: [M] int32; enq: [M] bool; exactly one of unif
    ([M] f32) and rng (the carry's [2] int64 key: the launch draws
    ``unif`` itself, as :func:`tick_draws` draws it at tick ``t``);
    q_tail: [n_ports] int32; t: an int or a 0-d int32 tensor on the
    inputs' device.  Returns (trim bool, mark bool, slot int32), each
    [M].  The launch takes :func:`tick_rank_plan`'s path."""
    _one_of(unif=unif, rng=rng)
    if q_tail is None or t is None:
        raise ValueError("tick_rank_red_ecn needs q_tail and t")
    if rng is None:
        _check_candidates(n_ports, q_tail, port=port, enq=enq, unif=unif)
    else:
        _check_candidates(n_ports, q_tail, port=port, enq=enq)
        _rng(rng)
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=n_ports)
    t = _tick(t, port.device)
    if _on_cpu(port, enq, q_tail, unif if rng is None else rng):
        if rng is not None:
            unif = R.tick_draws_reference(rng, t, n_flows=0,
                                          n_cand=port.shape[0])[1]
        rank = R.tick_rank_reference(port, n_ports=n_ports)
        return R.red_ecn_reference(port, rank, enq, unif, q_tail, t,
                                   **kw)[1:]
    M = port.shape[0]
    trim, mark = torch.empty_like(enq), torch.empty_like(enq)
    slot = torch.empty_like(port)
    path, segs, _ = tick_rank_plan(M, n_ports)
    if path == "none":
        return trim, mark, slot
    # drawing in place, the launch hands the tick's k_mark from warp 0 to
    # the others through these 8 bytes
    scratch = None if rng is None else torch.empty(
        2, dtype=torch.int32, device=port.device)
    _launch("tick_rank_red_ecn", port.data_ptr(), enq.data_ptr(),
            _ptr(unif), _ptr(rng), _ptr(scratch), q_tail.data_ptr(),
            t.data_ptr(), int(qsize), f32(kmin), red_recip(kmin, kmax),
            n_ports, M, segs, trim.data_ptr(), mark.data_ptr(),
            slot.data_ptr())
    TICK_RANK_PATHS[path] += 1
    return trim, mark, slot


def _one_of(**given) -> None:
    """Exactly one of the two keyword inputs is given (not None)."""
    if sum(v is not None for v in given.values()) != 1:
        raise ValueError(f"give exactly one of {' and '.join(given)}")


def _ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _rng(rng) -> None:
    """The carry's key: [2] int64 (uint32 words)."""
    if tuple(rng.shape) != (2,):
        raise ValueError(f"rng must be [2], got {tuple(rng.shape)}")
    _dtype(rng, torch.int64, "rng")


def tick_draws(rng, t, *, n_flows: int, n_cand: int):
    """The engine's random draws of tick ``t``: the keys ``(k_path,
    k_mark) = split(fold_in(rng, t), 2)`` and ``u_path =
    uniform(k_path, (n_flows, 1))``, ``unif = uniform(k_mark,
    (n_cand,))``, as ``jax.random`` draws them.  rng: [2] int64 (the
    carry's uint32 key words); t: an int or a 0-d int32 tensor on rng's
    device.  Returns (u_path [n_flows, 1] f32, unif [n_cand] f32)."""
    _rng(rng)
    if n_flows < 0 or n_cand < 0:
        raise ValueError(f"need n_flows, n_cand >= 0, got {n_flows}, "
                         f"{n_cand}")
    t = _tick(t, rng.device)
    if _on_cpu(rng, t):
        return R.tick_draws_reference(rng, t, n_flows=n_flows,
                                      n_cand=n_cand)
    u_path = torch.empty((n_flows, 1), dtype=torch.float32,
                         device=rng.device)
    unif = torch.empty(n_cand, dtype=torch.float32, device=rng.device)
    if n_flows + n_cand:
        _launch("tick_draws", rng.data_ptr(), t.data_ptr(), n_flows, n_cand,
                u_path.data_ptr(), unif.data_ptr())
    return u_path, unif


def _check_rows(w) -> tuple[int, int]:
    """The samplers' weights: [F, P] f32 with 1 <= P <= 256."""
    if w.ndim != 2:
        raise ValueError(f"w must be 2-D [F, P], got shape {tuple(w.shape)}")
    _dtype(w, torch.float32, "w")
    F, P = w.shape
    if not 1 <= P <= 256:
        raise ValueError(f"P must be in [1, 256], got {P}")
    return F, P


def spritz_select(w, u, buf_front, packet_count, *, explore_threshold: int,
                  rng=None, t=None):
    """w: [F, P] f32 effective weights (P <= 256); exactly one of u ([F]
    f32 uniforms) and rng (the carry's [2] int64 key, with t the tick:
    the launch draws u itself, the tick's ``u_path`` as
    :func:`tick_draws` draws it); buf_front: [F] int32 (-1 empty);
    packet_count: [F] int32.  Returns (ev int32, new_count int32,
    used_buffer bool), each [F]."""
    _one_of(u=u, rng=rng)
    F, P = _check_rows(w)
    rows = dict(buf_front=buf_front, packet_count=packet_count)
    if u is not None:
        rows = dict(u=u, **rows)
    if any(r.ndim != 1 for r in rows.values()):
        raise ValueError(f"{'/'.join(rows)} must be 1-D")
    if any(r.shape[0] != F for r in rows.values()):
        raise ValueError(f"ragged inputs: w rows {F}, " + ", ".join(
            f"{k} {r.shape[0]}" for k, r in rows.items()))
    if u is not None:
        _dtype(u, torch.float32, "u")
    _dtype(buf_front, torch.int32, "buf_front")
    _dtype(packet_count, torch.int32, "packet_count")
    if rng is not None:
        if t is None:
            raise ValueError("spritz_select with rng needs t")
        _rng(rng)
        t = _tick(t, w.device)
    if _on_cpu(w, buf_front, packet_count, u if rng is None else rng):
        if rng is not None:
            u = R.tick_draws_reference(rng, t, n_flows=F, n_cand=0)[0][:, 0]
        return R.spritz_select_reference(
            w, u, buf_front, packet_count,
            explore_threshold=explore_threshold)
    ev, newcnt = torch.empty_like(buf_front), torch.empty_like(buf_front)
    used = torch.empty(F, dtype=torch.bool, device=w.device)
    _launch("spritz_select", w.data_ptr(), _ptr(u), _ptr(rng), _ptr(t),
            buf_front.data_ptr(), packet_count.data_ptr(), F, P,
            int(explore_threshold), ev.data_ptr(), newcnt.data_ptr(),
            used.data_ptr())
    return ev, newcnt, used


def weighted_sample(w, rng, t):
    """Each row's weighted index on the tick's path draw, int32 [F]:
    ``weighted_sample_rows(u_path, w)`` with ``u_path`` as
    :func:`tick_draws` draws it at tick ``t``, drawn in the launch.  w:
    [F, P] f32 (P <= 256); rng: the carry's [2] int64 key; t: an int or a
    0-d int32 tensor on w's device."""
    F, P = _check_rows(w)
    _rng(rng)
    t = _tick(t, w.device)
    if _on_cpu(w, rng):
        return R.weighted_sample_reference(w, rng, t)
    ev = torch.empty(F, dtype=torch.int32, device=w.device)
    if F:
        _launch("weighted_sample", w.data_ptr(), rng.data_ptr(),
                t.data_ptr(), F, P, ev.data_ptr())
    return ev


def _float_code(name: str, *ts: torch.Tensor) -> int:
    """0 for f32, 1 for bf16; every tensor must have the same type and
    start on a 16-byte boundary (the kernels load vectors)."""
    dt = ts[0].dtype
    if dt not in _FLOAT_CODES or any(t.dtype != dt for t in ts):
        raise ValueError(f"{name}: inputs must all be float32 or all "
                         f"bfloat16, got {[str(t.dtype) for t in ts]}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return _FLOAT_CODES[dt]


def flash_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               dtype: torch.dtype, *, num_sms: int, causal: bool = True,
               q_offset: int = 0, grad: bool = False) -> tuple[str, int, int]:
    """The attention kernel's path for these shapes, as ``(path,
    split_len, n_split)``.

    A row is one (query position, query head) pair, ``Sq * G`` of them
    per (batch, kv head).  ``"split"``: at most ``SPLIT_ROWS`` rows and a
    ``(Hkv, B)`` grid under two blocks per SM; the keys ``[0, kend)`` any
    row may see are cut into ``n_split`` splits of ``split_len`` keys (a
    multiple of ``SPLIT_KEYS``; the last one ragged, none empty), enough
    for about two blocks on each of the card's ``num_sms`` SMs.
    ``"wgmma"``: bf16, at least one 64-row tile and D of 64 or 128.
    ``"simt"``: everything else.  With ``grad`` (a forward whose
    gradient will be taken) the split path, which writes no row
    log-sum-exp, is never chosen.  Shapes without rows or keys have no
    plan (the wrapper launches nothing for them)."""
    if min(B, Sq, Sk, Hq, Hkv) < 1 or num_sms < 1:
        raise ValueError(f"flash_plan: no work to plan for B={B}, Sq={Sq}, "
                         f"Sk={Sk}, Hq={Hq}, Hkv={Hkv} on {num_sms} SMs")
    rows = Sq * (Hq // Hkv)
    if not grad and rows <= SPLIT_ROWS and B * Hkv < 2 * num_sms:
        kend = min(Sk, q_offset + Sq) if causal else Sk
        want = -(-2 * num_sms // (B * Hkv))
        split_len = -(-max(-(-kend // want), 1) // SPLIT_KEYS) * SPLIT_KEYS
        return "split", split_len, -(-kend // split_len)
    if dtype == torch.bfloat16 and rows >= WGMMA_ROWS and D in (64, 128):
        return "wgmma", 0, 0
    return "simt", 0, 0


def flash_bwd_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                   dtype: torch.dtype) -> str:
    """The backward kernel's path for these shapes: ``"wgmma"`` (bf16, D
    of 64 or 128 and at least one 64-row tile, ``Sq * Hq / Hkv >=
    WGMMA_ROWS``), else ``"simt"`` (f32, D 32, fewer rows).  Shapes
    without rows or keys have no plan (the wrapper launches nothing for
    them)."""
    if min(B, Sq, Sk, Hq, Hkv) < 1:
        raise ValueError(f"flash_bwd_plan: no work to plan for B={B}, "
                         f"Sq={Sq}, Sk={Sk}, Hq={Hq}, Hkv={Hkv}")
    if dtype == torch.bfloat16 and D in (64, 128) and \
            Sq * (Hq // Hkv) >= WGMMA_ROWS:
        return "wgmma"
    return "simt"


def _check_attention(q, k, v, q_offset: int, sliding_window: int):
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError("q, k and v must be 4-D [B, S, H, D]")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1 or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"need Sk >= 1 and Hq ({Hq}) a multiple of Hkv "
                         f"({Hkv})")
    if q_offset < 0 or sliding_window < 0:
        raise ValueError("q_offset and sliding_window must be >= 0")


def _flash_forward(q, k, v, *, causal: bool, sliding_window: int,
                   q_offset: int, lse: bool):
    """One launch of the attention kernel on the card: ``(o, lse)``, the
    row log-sum-exp f32 [B, Hq, Sq] written only when ``lse`` (then the
    split path is never taken)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    code = _float_code("flash_attention", q, k, v)
    if D not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel: D must be 32, 64 or 128, "
                         f"got {D}")
    meta = q.is_meta
    path, split_len, n_split = flash_plan(
        B, Sq, Sk, Hq, Hkv, D, q.dtype, causal=causal, q_offset=q_offset,
        num_sms=H100_SMS if meta else torch.cuda.get_device_properties(
            q.device).multi_processor_count, grad=lse)
    o = torch.empty_like(q)
    rowlse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
              if lse else None)
    scratch = None
    if path == "split":
        scratch = torch.empty(B * Hkv * n_split * Sq * (Hq // Hkv) * (D + 2),
                              dtype=torch.float32, device=q.device)
    if meta:
        flops, nb = work.attention_work(q, k, causal=causal,
                                        window=sliding_window,
                                        q_offset=q_offset)
        work.credit("flash_attention", flops,
                    nb + (4 * B * Hq * Sq if lse else 0))
        return o, rowlse
    _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Sq, Sk, Hq, Hkv, D, code, int(bool(causal)),
            int(sliding_window), int(q_offset), 1.0 / math.sqrt(D),
            _FLASH_CODES[path], split_len, n_split,
            None if scratch is None else scratch.data_ptr(),
            None if rowlse is None else rowlse.data_ptr())
    FLASH_PATHS[path] += 1
    return o, rowlse


class _FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel writes
    the row log-sum-exp beside ``o``, the backward is
    :func:`flash_attention_bwd`'s two kernel launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        o, lse = _flash_forward(q, k, v, causal=causal,
                                sliding_window=sliding_window, q_offset=0,
                                lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, sliding_window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window = ctx.mask
        return (*flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     causal=causal, sliding_window=window),
                None, None)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0):
    """GQA attention.  q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D], Hq a
    multiple of Hkv (query head h reads kv head h // (Hq // Hkv)); f32 or
    bf16.  Query row i sits at position ``q_offset + i`` (decode: the
    cache length).  Returns [B, Sq, Hq, D] in q's dtype.  On the card D
    must be 32, 64 or 128; the kernel's path is :func:`flash_plan`'s.

    Differentiable: under grad with an input that requires it, on the
    card the forward kernel also writes the row log-sum-exp and the
    gradient is the backward kernel's (:func:`flash_attention_bwd`;
    ``q_offset`` must then be 0); on the CPU autograd differentiates the
    plain version."""
    _check_attention(q, k, v, q_offset, sliding_window)
    kw = dict(causal=causal, sliding_window=sliding_window,
              q_offset=int(q_offset))
    where = _where(q, k, v, meta=True)
    if q.numel() == 0:                       # no rows: nothing to launch
        return torch.empty_like(q)
    if where == "cpu":
        return R.mha_reference(q, k, v, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset:
            raise ValueError("flash_attention: no gradient with q_offset "
                             f"{q_offset} (training attends from 0)")
        return _FlashAttention.apply(q, k, v, bool(causal),
                                     int(sliding_window))
    return _flash_forward(q, k, v, **kw, lse=False)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0):
    """The forward of a differentiable call without autograd: ``(o,
    lse)``, lse the f32 row log-sum-exp [B, Hq, Sq] that
    :func:`flash_attention_bwd` takes.  One kernel launch on the card
    (never the split path); the plain versions on the CPU."""
    _check_attention(q, k, v, 0, sliding_window)
    kw = dict(causal=causal, sliding_window=sliding_window)
    if _where(q, k, v, meta=True) == "cpu":
        return (R.mha_reference(q, k, v, **kw),
                R.mha_lse(q, k, **kw))
    return _flash_forward(q, k, v, **kw, q_offset=0, lse=True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sliding_window: int = 0):
    """Attention's gradient: ``(dq, dk, dv)`` in the inputs' dtype from q,
    o, do [B, Sq, Hq, D], k, v [B, Sk, Hkv, D] and the forward's row
    log-sum-exp lse (f32 [B, Hq, Sq]); query row i at position i.  On
    the card two launches of ``flash_attention_bwd.cu`` on the path
    :func:`flash_bwd_plan` picks (each launch counted, by path too): dQ
    with ``rowsum(dO o O)``, then dK and dV, each kv head's group summed
    in one block (no atomics: the same inputs give the same bits).  On
    the CPU :func:`ref.mha_backward_reference`."""
    _check_attention(q, k, v, 0, sliding_window)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse "
                         f"{(B, Hq, Sq)}; got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    kw = dict(causal=causal, sliding_window=sliding_window)
    if _where(q, k, v, o, lse, do, meta=True) == "cpu":
        return R.mha_backward_reference(q, k, v, o, lse, do, **kw)
    code = _float_code("flash_attention_bwd", q, k, v, o, do)
    _dtype(lse, torch.float32, "lse")
    if D not in (32, 64, 128):
        raise ValueError(f"flash_attention_bwd kernel: D must be 32, 64 or "
                         f"128, got {D}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    path = flash_bwd_plan(B, Sq, Sk, Hq, Hkv, D, q.dtype)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.is_meta:
        work.credit("flash_attention_bwd", *work.attention_bwd_work(
            q, k, causal=causal, window=sliding_window))
        return dq, dk, dv
    for stage in (0, 1):          # dQ (and delta), then dK / dV
        _launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Sq, Sk, Hq, Hkv, D, code,
                int(bool(causal)), int(sliding_window), 1.0 / math.sqrt(D),
                _FLASH_CODES[path], stage)
        FLASH_BWD_PATHS[path] += 1
    return dq, dk, dv


def _check_rwkv(r, k, v, w, u, wkv0, chunk: int) -> int:
    """The chunk ``min(chunk, S)`` after the shape checks."""
    if not (r.ndim == 4 and r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"r/k/v/w must share a 4-D shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if hd != 64 or tuple(u.shape) != (H, hd) or \
            tuple(wkv0.shape) != (B, H, hd, hd):
        raise ValueError(f"need hd = 64, u [H, 64], wkv0 [B, H, 64, 64]; got "
                         f"r {tuple(r.shape)}, u {tuple(u.shape)}, wkv0 "
                         f"{tuple(wkv0.shape)}")
    C = min(chunk, S)
    if C < 1 or S % C:
        raise ValueError(f"chunk {C} does not divide S = {S}")
    return C


def _rwkv_forward(r, k, v, w, u, wkv0, C: int, states: bool):
    """One launch of the chunked RWKV-6 kernel on the card: ``(y, wkv,
    starts)``, the chunk-start states f32 [B, H, S / C, 64, 64] written
    only with ``states`` (else None)."""
    B, S, H, hd = r.shape
    code = _float_code("rwkv6_chunked", r, k, v, w, u)
    _dtype(wkv0, torch.float32, "wkv0")
    if C > 64:
        raise ValueError(f"rwkv6_chunked kernel: chunk must be <= 64, got {C}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, wkv0)):
        raise ValueError("rwkv6_chunked kernel: r, k, v, w and wkv0 must "
                         "start on a 16-byte boundary")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    sout = torch.empty_like(wkv0)
    starts = (torch.empty((B, H, S // C, hd, hd), dtype=torch.float32,
                          device=r.device) if states else None)
    if r.is_meta:
        work.credit("rwkv6_chunked", work.rwkv_flops(B, S, H, C),
                    sum(t.numel() * t.element_size()
                        for t in (r, k, v, w, u, wkv0, y, sout)
                        + (() if starts is None else (starts,))))
        return y, sout, starts
    _launch("rwkv6_chunked", r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), wkv0.data_ptr(), y.data_ptr(),
            sout.data_ptr(), None if starts is None else starts.data_ptr(),
            B, S, H, C, code)
    return y, sout, starts


class _RWKV6Chunked(torch.autograd.Function):
    """The chunked RWKV-6 time mix on the card with a gradient: the
    forward kernel also writes each chunk's start state, the backward is
    one launch of :func:`rwkv6_chunked_bwd`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, wkv0, chunk):
        y, sout, starts = _rwkv_forward(r, k, v, w, u, wkv0, chunk,
                                        states=True)
        ctx.save_for_backward(r, k, v, w, u, starts)
        ctx.chunk = chunk
        return y, sout

    @staticmethod
    def backward(ctx, dy, dwkv):
        r, k, v, w, u, starts = ctx.saved_tensors
        return (*rwkv6_chunked_bwd(r, k, v, w, u, starts, dy.contiguous(),
                                   dwkv.contiguous(), chunk=ctx.chunk),
                None)


def rwkv6_chunked(r, k, v, w, u, wkv0, *, chunk: int = 64):
    """Chunked RWKV-6 time mix.  r, k, v, w: [B, S, H, 64] and u: [H, 64],
    all f32 or all bf16; wkv0: [B, H, 64, 64] f32.  ``min(chunk, S)``
    must divide S (and be at most 64 on the card, where the tensors must
    also start on a 16-byte boundary).  Returns (y
    [B, S, H, 64] f32, final state [B, H, 64, 64] f32).

    Differentiable: under grad with an input that requires it, on the
    card the forward kernel also writes each chunk's start state and the
    gradient is the backward kernel's (:func:`rwkv6_chunked_bwd`: f32
    inputs and a chunk of at most 32); on the CPU autograd differentiates
    the plain version."""
    C = _check_rwkv(r, k, v, w, u, wkv0, chunk)
    if _where(r, k, v, w, u, wkv0, meta=True) == "cpu":
        return R.rwkv6_chunked_reference(r, k, v, w, u, wkv0, chunk=C)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, wkv0)):
        return _RWKV6Chunked.apply(r, k, v, w, u, wkv0, C)
    return _rwkv_forward(r, k, v, w, u, wkv0, C, states=False)[:2]


def rwkv6_chunked_states(r, k, v, w, u, wkv0, *, chunk: int = 16):
    """The forward of a differentiable call without autograd: ``(y, wkv,
    states)``, states the chunk-start states f32 [B, H, S / C, 64, 64]
    that :func:`rwkv6_chunked_bwd` takes.  One kernel launch on the card;
    the plain version on the CPU."""
    C = _check_rwkv(r, k, v, w, u, wkv0, chunk)
    if _where(r, k, v, w, u, wkv0, meta=True) == "cpu":
        return R.rwkv6_chunked_reference(r, k, v, w, u, wkv0, chunk=C,
                                         states=True)
    return _rwkv_forward(r, k, v, w, u, wkv0, C, states=True)


def rwkv6_chunked_bwd(r, k, v, w, u, states, dy, dwkv=None, *,
                      chunk: int = 16):
    """The chunked RWKV-6 time mix's gradient: ``(dr, dk, dv, dw, du,
    dwkv0)`` from r, k, v, w, dy [B, S, H, 64] and u [H, 64], all f32,
    the forward's chunk-start states f32 [B, H, S / C, 64, 64] (the first
    is wkv0) and the final state's gradient ``dwkv`` [B, H, 64, 64] (None
    for 0).  On the card one launch of ``rwkv6_chunked_bwd.cu`` (chunk at
    most 32, every tensor on a 16-byte boundary): a block a (batch, head)
    walking the chunks in reverse; du is summed from per-(batch, head)
    shares in a fixed order, so the same inputs give the same bits.  On
    the CPU :func:`ref.rwkv6_chunked_backward_reference`."""
    if states.ndim != 5:
        raise ValueError(f"states must be 5-D [B, H, n_chunks, 64, 64], got "
                         f"shape {tuple(states.shape)}")
    C = _check_rwkv(r, k, v, w, u, states[:, :, 0], chunk)
    B, S, H, hd = r.shape
    if tuple(states.shape) != (B, H, S // C, hd, hd) or \
            dy.shape != r.shape or \
            (dwkv is not None and tuple(dwkv.shape) != (B, H, hd, hd)):
        raise ValueError(f"need states {(B, H, S // C, hd, hd)}, dy "
                         f"{tuple(r.shape)} and dwkv {(B, H, hd, hd)}; got "
                         f"{tuple(states.shape)}, {tuple(dy.shape)}, "
                         f"{None if dwkv is None else tuple(dwkv.shape)}")
    ts = (r, k, v, w, u, states, dy) + (() if dwkv is None else (dwkv,))
    if _where(*ts, meta=True) == "cpu":
        return R.rwkv6_chunked_backward_reference(r, k, v, w, u, states, dy,
                                                  dwkv, chunk=C)
    for name, t in zip(("r", "k", "v", "w", "u", "states", "dy", "dwkv"), ts):
        _dtype(t, torch.float32, name)
    if C > 32:
        raise ValueError(f"rwkv6_chunked_bwd kernel: chunk must be <= 32, "
                         f"got {C}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("rwkv6_chunked_bwd kernel: inputs must start on a "
                         "16-byte boundary")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    dupart = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if r.is_meta:
        work.credit("rwkv6_chunked_bwd", work.rwkv_bwd_flops(B, S, H, C),
                    sum(t.numel() * t.element_size() for t in
                        ts + (dr, dk, dv, dw, dupart, ds0)))
        return dr, dk, dv, dw, dupart.sum(0), ds0
    _launch("rwkv6_chunked_bwd", r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dwkv is None else dwkv.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), dupart.data_ptr(),
            ds0.data_ptr(), B, S, H, C)
    return dr, dk, dv, dw, dupart.sum(0), ds0


def _check_mamba(x, dt, A, Bm, Cm, h0) -> tuple:
    """(B, S, E, N) after the shape checks."""
    if x.ndim != 3:
        raise ValueError(f"x must be [B, S, E], got {tuple(x.shape)}")
    B, S, E = x.shape
    N = A.shape[-1] if A.ndim == 2 else -1
    want = {"dt": (B, S), "A": (E, N), "Bm": (B, S, N), "Cm": (B, S, N),
            "h0": (B, E, N)}
    got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "h0": h0}
    bad = [f"{k} {tuple(t.shape)} (want {want[k]})" for k, t in got.items()
           if tuple(t.shape) != want[k]]
    if bad or S < 1:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)}: " + ", ".join(
            bad or ["S must be >= 1"]))
    return B, S, E, N


def _check_mamba_card(N: int, *ts) -> None:
    for name, t in zip(("x", "dt", "A", "Bm", "Cm", "h0"), ts):
        _dtype(t, torch.float32, name)
    if N != MAMBA_STATES:
        raise ValueError(f"mamba_scan kernel: d_state must be "
                         f"{MAMBA_STATES}, got {N}")
    if any(t.data_ptr() % 16 for t in ts[2:]):
        raise ValueError("mamba_scan kernel: A, Bm, Cm and h0 (or the "
                         "states) must start on a 16-byte boundary")


def _mamba_forward(x, dt, A, Bm, Cm, h0, states: bool):
    """One launch of the scan's kernel on the card (or, on ``meta``, its
    outputs and its work credited): ``(y, hT, checkpoints)``, the
    checkpoints [B, ceil(S / 16), E, N] written only with ``states``."""
    B, S, E, N = _check_mamba(x, dt, A, Bm, Cm, h0)
    _check_mamba_card(N, x, dt, A, Bm, Cm, h0)
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    ck = (torch.empty((B, -(-S // R.MAMBA_SEGMENT), E, N),
                      dtype=torch.float32, device=x.device)
          if states else None)
    if x.is_meta:
        f, n_exp, nb = work.mamba_scan_work(B, S, E, N, states=states)
        work.credit("mamba_scan", f + n_exp, nb, products=False)
        return y, hT, ck
    _launch("mamba_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), None if ck is None else ck.data_ptr(), B, S, E)
    return y, hT, ck


class _MambaScan(torch.autograd.Function):
    """The scan on the card with a gradient: the forward kernel also
    writes its checkpoint states, the backward is one call of
    :func:`mamba_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        y, hT, ck = _mamba_forward(x, dt, A, Bm, Cm, h0, states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, ck)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, Cm, ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return mamba_scan_bwd(x, dt, A, Bm, Cm, ck, dy.contiguous(),
                              None if dhT is None else dhT.contiguous())


def mamba_scan(x, dt, A, Bm, Cm, h0):
    """Mamba's selective scan: ``h_t = exp(dt_t A) h_{t-1} + (dt_t B_t)
    x_t``, ``y_t = sum_n h_t C_t``.  x: [B, S, E]; dt: [B, S]; A: [E, N];
    Bm, Cm: [B, S, N]; h0: [B, E, N]; all f32 (N = 16 on the card).
    Returns (y [B, S, E], final state [B, E, N]).

    Differentiable in every input: under grad on the card the forward
    kernel also writes the state before every 16th token and the
    gradient is the backward kernel's (:func:`mamba_scan_bwd`); on the
    CPU autograd differentiates the plain token loop."""
    _check_mamba(x, dt, A, Bm, Cm, h0)
    if _where(x, dt, A, Bm, Cm, h0, meta=True) == "cpu":
        return R.mamba_scan_reference(x, dt, A, Bm, Cm, h0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, Bm, Cm, h0)):
        return _MambaScan.apply(x, dt, A, Bm, Cm, h0)
    return _mamba_forward(x, dt, A, Bm, Cm, h0, states=False)[:2]


def mamba_scan_states(x, dt, A, Bm, Cm, h0):
    """The forward of a differentiable call without autograd: ``(y, hT,
    states)``, states the checkpoints [B, ceil(S / 16), E, N] that
    :func:`mamba_scan_bwd` takes.  One kernel launch on the card; the
    plain version on the CPU."""
    _check_mamba(x, dt, A, Bm, Cm, h0)
    if _where(x, dt, A, Bm, Cm, h0, meta=True) == "cpu":
        return R.mamba_scan_reference(x, dt, A, Bm, Cm, h0, states=True)
    return _mamba_forward(x, dt, A, Bm, Cm, h0, states=True)


def mamba_scan_bwd(x, dt, A, Bm, Cm, states, dy, dhT=None):
    """The scan's gradient: ``(dx, ddt, dA, dB, dC, dh0)`` from the
    forward's inputs, its checkpoint states [B, ceil(S / 16), E, N] (the
    first is h0), dy [B, S, E] and the final state's gradient ``dhT`` [B,
    E, N] (None for 0).  On the card one call of ``mamba_scan.cu``'s
    backward: the scan in reverse, a block 64 channels of one batch, its
    sums over the channels written as per-block partials, then a second
    kernel summing them (and dA over the batch) in a fixed order, so the
    same inputs give the same bits.  On the CPU
    :func:`ref.mamba_scan_backward_reference`."""
    if states.ndim != 4:
        raise ValueError(f"states must be [B, ceil(S / 16), E, N], got "
                         f"{tuple(states.shape)}")
    B, S, E, N = _check_mamba(x, dt, A, Bm, Cm, states[:, 0])
    nseg = -(-S // R.MAMBA_SEGMENT)
    if tuple(states.shape) != (B, nseg, E, N) or dy.shape != x.shape or \
            (dhT is not None and tuple(dhT.shape) != (B, E, N)):
        raise ValueError(f"need states {(B, nseg, E, N)}, dy "
                         f"{tuple(x.shape)} and dhT {(B, E, N)}; got "
                         f"{tuple(states.shape)}, {tuple(dy.shape)}, "
                         f"{None if dhT is None else tuple(dhT.shape)}")
    ts = (x, dt, A, Bm, Cm, states, dy) + (() if dhT is None else (dhT,))
    if _where(*ts, meta=True) == "cpu":
        return R.mamba_scan_backward_reference(x, dt, A, Bm, Cm,
                                               states[:, 0], dy, dhT)
    _check_mamba_card(N, x, dt, A, Bm, Cm, states)
    _dtype(dy, torch.float32, "dy")
    if dhT is not None:
        _dtype(dhT, torch.float32, "dhT")
    nblk = -(-E // MAMBA_CHANNELS)
    dev = x.device
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, dt, Bm, Cm))
    dA, dh0 = torch.empty_like(A), torch.empty((B, E, N), device=dev)
    dBp, dCp = (torch.empty((B, nblk, S, N), device=dev) for _ in range(2))
    ddtp = torch.empty((B, nblk, S), dtype=torch.float64, device=dev)
    dAp = torch.empty((B, E, N), dtype=torch.float64, device=dev)
    if x.is_meta:
        f, n_exp, nb = work.mamba_scan_work(B, S, E, N, backward=True)
        work.credit("mamba_scan_bwd", f + n_exp, nb, products=False)
        return dx, ddt, dA, dB, dC, dh0
    _launch("mamba_scan_bwd", *(t.data_ptr() for t in (
        x, dt, A, Bm, Cm, states, dy)),
        None if dhT is None else dhT.data_ptr(),
        *(t.data_ptr() for t in (dx, ddt, dA, dB, dC, dh0, dBp, dCp, ddtp,
                                 dAp)), B, S, E, nblk)
    return dx, ddt, dA, dB, dC, dh0
