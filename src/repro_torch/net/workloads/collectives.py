"""AI collective traffic (paper §V-B b): Allreduce (ring and butterfly) and
Alltoall, executed by a subset of endpoints inside a shared network.

Step ordering is expressed through flow dependencies (``Flow.dep``): a step's
flow becomes eligible once the flow carrying its input data completed.  The
optional background permutation (rest of the datacenter on static ECMP paths)
mirrors the paper's shared-environment setup.

Port of ``repro.net.workloads.collectives``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.sim.build import Flow
from repro_torch.net.topology.base import Topology
from repro_torch.net.workloads.synthetic import permutation


def _participants(topo: Topology, m: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return sorted(int(x) for x in rng.choice(topo.n_endpoints, m, replace=False))


def allreduce_ring(topo: Topology, m: int, total_pkts: int, seed: int = 0,
                   with_background: bool = True, bg_pkts: int = 64
                   ) -> tuple[list[Flow], np.ndarray]:
    """Ring allreduce: 2(m-1) steps, chunk = total/m per step per node.

    Flow (s, n): node n -> n+1 at step s; depends on (s-1, n-1) — the chunk
    it forwards arrived in the previous step.
    Returns (flows, collective_mask).
    """
    eps = _participants(topo, m, seed)
    chunk = max(1, total_pkts // m)
    flows: list[Flow] = []
    idx = {}
    for s in range(2 * (m - 1)):
        for n in range(m):
            dep = idx.get((s - 1, (n - 1) % m), -1)
            idx[(s, n)] = len(flows)
            flows.append(Flow(eps[n], eps[(n + 1) % m], chunk, dep=dep))
    mask = np.ones(len(flows), bool)
    flows, mask = _add_background(topo, flows, mask, eps, with_background,
                                  bg_pkts, seed)
    return flows, mask


def allreduce_butterfly(topo: Topology, m: int, total_pkts: int, seed: int = 0,
                        with_background: bool = True, bg_pkts: int = 64
                        ) -> tuple[list[Flow], np.ndarray]:
    """Recursive-doubling allreduce: log2(m) rounds, full vector each round.
    Flow (s, n): n -> n XOR 2^s; depends on the partner flow it received in
    round s-1 (the reduction input)."""
    assert m & (m - 1) == 0, "butterfly needs power-of-two participants"
    eps = _participants(topo, m, seed)
    flows: list[Flow] = []
    idx = {}
    rounds = int(np.log2(m))
    for s in range(rounds):
        for n in range(m):
            partner = n ^ (1 << s)
            dep = idx.get((s - 1, n ^ (1 << (s - 1)))) if s > 0 else -1
            idx[(s, n)] = len(flows)
            flows.append(Flow(eps[n], eps[partner], total_pkts,
                              dep=-1 if dep is None else dep))
    mask = np.ones(len(flows), bool)
    flows, mask = _add_background(topo, flows, mask, eps, with_background,
                                  bg_pkts, seed)
    return flows, mask


def alltoall(topo: Topology, m: int, total_pkts: int, n_parallel: int = 4,
             seed: int = 0, with_background: bool = True, bg_pkts: int = 64
             ) -> tuple[list[Flow], np.ndarray]:
    """Alltoall with at most n_parallel concurrent connections per endpoint
    (paper: 'we limit each endpoint to n parallel connections').  Flows of
    one sender chain in waves via deps; wave w targets (n + w*stride + k)."""
    eps = _participants(topo, m, seed)
    chunk = max(1, total_pkts // m)
    flows: list[Flow] = []
    idx = {}
    for n in range(m):
        for j in range(m - 1):
            tgt = (n + 1 + j) % m
            dep = idx.get((n, j - n_parallel), -1)
            idx[(n, j)] = len(flows)
            flows.append(Flow(eps[n], eps[tgt], chunk, dep=dep))
    mask = np.ones(len(flows), bool)
    flows, mask = _add_background(topo, flows, mask, eps, with_background,
                                  bg_pkts, seed)
    return flows, mask


def _add_background(topo, flows, mask, eps, with_background, bg_pkts, seed):
    if not with_background:
        return flows, mask
    rest = [e for e in range(topo.n_endpoints) if e not in set(eps)]
    bg = permutation(topo, bg_pkts, seed=seed + 1, off_group=False,
                     endpoints=rest, bg=True)
    flows = flows + bg
    mask = np.concatenate([mask, np.zeros(len(bg), bool)])
    return flows, mask


def collective_duration(res_fct, start_ticks, mask) -> int:
    """Completion tick of the last collective flow (duration from t=0)."""
    import numpy as np
    done = np.asarray(res_fct)[mask]
    st = np.asarray(start_ticks)[mask]
    if (done < 0).any():
        return -1
    return int((done + st).max())
