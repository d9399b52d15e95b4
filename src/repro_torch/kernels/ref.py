"""Plain torch versions of the four tick kernels.

Each mirrors its oracle in ``repro.kernels.ref`` operation for operation,
so it is bit-identical to the reference on any device.  ``ops`` calls
these for tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch._parity import f32, red_recip, xla_cumsum_f32

_TINY = f32(1e-30)


def spritz_select_reference(w, u, buf_front, packet_count, *,
                            explore_threshold: int):
    """Spritz Algorithm 1's selection core: weighted sample from the
    row prefix sum, explore counter, buffer front."""
    csum = xla_cumsum_f32(w.float())
    total = csum[:, -1]
    uu = u * total.clamp_min(_TINY)
    sampled = (csum < uu[:, None]).sum(1).clamp_max(w.shape[1] - 1)
    explore = packet_count >= explore_threshold
    use_buffer = ~explore & (buf_front >= 0)
    ev = torch.where(use_buffer, buf_front, sampled.to(torch.int32))
    new_count = torch.where(explore, 0, packet_count + 1)
    return ev, new_count.to(torch.int32), use_buffer


def red_ecn_reference(eport, rank, enq, unif, q_tail, t: int, *, qsize,
                      kmin, kmax, n_ports):
    """Occupancy, trim, RED/ECN mark and service slot per candidate."""
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
