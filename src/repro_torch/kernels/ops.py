"""Wrappers of the four CUDA tick kernels.

Each wrapper checks its inputs, then either launches its kernel on the
current CUDA stream (tensors on the card) or calls the kernel's plain
version in :mod:`repro_torch.kernels.ref` (tensors on the CPU, the
analogue of Pallas interpret mode).  There is no fallback: a tensor on
the card runs the kernel or raises.  ``LAUNCHES`` counts kernel launches
per wrapper, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch._parity import f32, red_recip
from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

LAUNCHES = dict.fromkeys(("flow_agg", "tick_rank", "red_ecn",
                          "spritz_select"), 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")
    return False


def _dtype(t: torch.Tensor, want: torch.dtype, name: str) -> None:
    if t.dtype != want:
        raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _launch(name: str, *args) -> None:
    err = _build.library(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flow_agg(rows: torch.Tensor, pflow: torch.Tensor, *, n_flows: int):
    """rows: [K, N] int32; pflow: [N] int32.  Returns [K, n_flows] int32
    ``out[k, f] = sum(rows[k, pflow == f])``; a pflow outside
    ``[0, n_flows)`` adds nothing."""
    if rows.ndim != 2:
        raise ValueError(f"rows must be 2-D [K, N], got shape {tuple(rows.shape)}")
    if pflow.ndim != 1 or rows.shape[1] != pflow.shape[0]:
        raise ValueError(f"rows/pflow length mismatch: {tuple(rows.shape)} "
                         f"vs {tuple(pflow.shape)}")
    _dtype(rows, torch.int32, "rows")
    _dtype(pflow, torch.int32, "pflow")
    if n_flows < 1:
        raise ValueError(f"n_flows must be >= 1, got {n_flows}")
    if _on_cpu(rows, pflow):
        return R.flow_agg_reference(rows, pflow, n_flows=n_flows)
    K, N = rows.shape
    out = torch.zeros((K, n_flows), dtype=torch.int32, device=rows.device)
    _launch("flow_agg", rows.data_ptr(), pflow.data_ptr(), out.data_ptr(),
            K, N, n_flows)
    return out


def tick_rank(port: torch.Tensor, *, n_ports: int):
    """port: [M] int32.  Returns [M] int32, the position among equal
    ports in index order; ports outside ``[0, n_ports)`` share one
    overflow bucket."""
    if port.ndim != 1:
        raise ValueError(f"port must be 1-D, got shape {tuple(port.shape)}")
    _dtype(port, torch.int32, "port")
    if n_ports < 1:
        raise ValueError(f"n_ports must be >= 1, got {n_ports}")
    if _on_cpu(port):
        return R.tick_rank_reference(port, n_ports=n_ports)
    rank = torch.empty_like(port)
    _launch("tick_rank", port.data_ptr(), rank.data_ptr(), port.shape[0],
            n_ports)
    return rank


def red_ecn(eport, rank, enq, unif, q_tail, t: int, *, qsize: int,
            kmin: float, kmax: float, n_ports: int):
    """eport/rank: [M] int32; enq: [M] bool; unif: [M] f32; q_tail:
    [n_ports] int32.  Returns (occ int32, trim bool, mark bool, slot
    int32), each [M]."""
    if not (eport.ndim == rank.ndim == enq.ndim == unif.ndim == 1):
        raise ValueError("eport/rank/enq/unif must be 1-D")
    if not (eport.shape == rank.shape == enq.shape == unif.shape):
        raise ValueError(
            f"ragged inputs: eport {tuple(eport.shape)}, rank "
            f"{tuple(rank.shape)}, enq {tuple(enq.shape)}, unif "
            f"{tuple(unif.shape)}")
    _dtype(eport, torch.int32, "eport")
    _dtype(rank, torch.int32, "rank")
    _dtype(enq, torch.bool, "enq")
    _dtype(unif, torch.float32, "unif")
    _dtype(q_tail, torch.int32, "q_tail")
    if tuple(q_tail.shape) != (n_ports,):
        raise ValueError(f"q_tail shape {tuple(q_tail.shape)} != "
                         f"(n_ports,) = ({n_ports},)")
    kw = dict(qsize=qsize, kmin=kmin, kmax=kmax, n_ports=n_ports)
    if _on_cpu(eport, rank, enq, unif, q_tail):
        return R.red_ecn_reference(eport, rank, enq, unif, q_tail, t, **kw)
    M = eport.shape[0]
    occ, slot = torch.empty_like(eport), torch.empty_like(eport)
    trim, mark = torch.empty_like(enq), torch.empty_like(enq)
    _launch("red_ecn", eport.data_ptr(), rank.data_ptr(), enq.data_ptr(),
            unif.data_ptr(), q_tail.data_ptr(), int(t), int(qsize),
            f32(kmin), red_recip(kmin, kmax), n_ports, M, occ.data_ptr(),
            trim.data_ptr(), mark.data_ptr(), slot.data_ptr())
    return occ, trim, mark, slot


def spritz_select(w, u, buf_front, packet_count, *, explore_threshold: int):
    """w: [F, P] f32 effective weights (P <= 256); u: [F] f32 uniforms;
    buf_front: [F] int32 (-1 empty); packet_count: [F] int32.  Returns
    (ev int32, new_count int32, used_buffer bool), each [F]."""
    if w.ndim != 2:
        raise ValueError(f"w must be 2-D [F, P], got shape {tuple(w.shape)}")
    if not (u.ndim == buf_front.ndim == packet_count.ndim == 1):
        raise ValueError("u/buf_front/packet_count must be 1-D")
    F, P = w.shape
    if not (u.shape[0] == buf_front.shape[0] == packet_count.shape[0] == F):
        raise ValueError(
            f"ragged inputs: w rows {F}, u {u.shape[0]}, buf_front "
            f"{buf_front.shape[0]}, packet_count {packet_count.shape[0]}")
    _dtype(w, torch.float32, "w")
    _dtype(u, torch.float32, "u")
    _dtype(buf_front, torch.int32, "buf_front")
    _dtype(packet_count, torch.int32, "packet_count")
    if not 1 <= P <= 256:
        raise ValueError(f"P must be in [1, 256], got {P}")
    if _on_cpu(w, u, buf_front, packet_count):
        return R.spritz_select_reference(
            w, u, buf_front, packet_count,
            explore_threshold=explore_threshold)
    ev, newcnt = torch.empty_like(buf_front), torch.empty_like(buf_front)
    used = torch.empty(F, dtype=torch.bool, device=w.device)
    _launch("spritz_select", w.data_ptr(), u.data_ptr(),
            buf_front.data_ptr(), packet_count.data_ptr(), F, P,
            int(explore_threshold), ev.data_ptr(), newcnt.data_ptr(),
            used.data_ptr())
    return ev, newcnt, used
