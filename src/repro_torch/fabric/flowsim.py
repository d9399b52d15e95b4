"""Flow-level max-min simulator on torch tensors (DESIGN.md §12).  Port
of ``repro.fabric.flowsim``.

Model: progressive filling.  At every epoch the active flows get their
max-min fair rates (dense iterative water-filling over the padded
``[F, max_hops]`` flow -> link incidence), time advances to the earliest
completion / flow start / failure event, and the registry's
:class:`~repro_torch.net.policies.base.FlowLevelRule` of the scheme
re-selects paths once per epoch (uniform respray, REPS recycling, UGAL
first-hop compare, Spritz hot-link eviction with hysteresis).  Failure
and capacity timelines cap each link at its live fractional capacity.

Host and device.  The path tables (:class:`PathDB`, :class:`FlowTable`,
:func:`build_flow_table`), the failure plan and the flow-start choice
(:func:`_init_choice`, one generator call per flow) are numpy on the
host, as in the reference.  The per-epoch state (``choice``,
``remaining``, ``fct``, link loads and capacities) lives in float64 /
int64 tensors on ``device``, where the water-filler, the samplers and
the re-selection run.  The epoch loop's control stays on the host: ``t``,
``dt`` and the event index are Python numbers, and each decision reads
the device once (a water-fill level reads its fair share ``b`` and the
count of newly frozen flows together).  Every read is counted in
:class:`FlowStats`.

Bit-identity with the reference (PORT.md): every random draw is made on
the host by ``np.random.default_rng(seed)`` in the reference's calls and
shapes and copied to the device; the transcendentals (the Gumbel term
``log(-log1p(-u))`` and the log weights) are numpy's; the row cumsum of
the inverse-CDF sampler adds the columns in numpy's sequential order;
the hot-link quantile is ``np.quantile`` of the load copied to the host;
``remaining - rates * dt`` and ``cap - b * dec`` round twice, as numpy
does.  The one sum whose order differs on the card is the conformance
audit's per-link rate sum, which only feeds a ``> cap + 1e-9`` compare.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.net import paths as P
from repro_torch.net.topology.base import BYTES_PER_TICK, Topology

_F64 = torch.float64
_INF = math.inf


@dataclasses.dataclass
class FlowSpec:
    src_ep: int
    dst_ep: int
    size_bytes: float        # bytes serialized at link rate (wire bytes)
    start: float = 0.0       # byte-time offset (BYTES_PER_TICK per tick)


@dataclasses.dataclass
class FlowStats:
    """What one run cost the host: epochs, water-fill levels and device
    reads (each ``.tolist()``, ``nonzero`` or copy to the host), split
    into those made inside the water-filler and the rest, and the device
    the run's state tensors lived on."""

    scheme: str
    seed: int
    epochs: int
    levels: int
    reads_level: int
    reads_epoch: int
    device: str

    @property
    def host_reads(self) -> int:
        return self.reads_level + self.reads_epoch


@dataclasses.dataclass
class FlowResult:
    fct: np.ndarray          # [F] completion time - start (bytes at link
    #   rate; -1.0 == never finished — filter with ``fct >= 0``)
    reselections: int        # accepted path moves
    epochs: int              # progressive-filling epochs executed
    forced: int = 0          # moves forced by a failed current path
    rate_violations: int = 0  # epochs x links where allocated rate
    #   exceeded the scheduled capacity (conformance audit; must be 0)
    # the run's FlowStats: a plain attribute, not a dataclass field, so
    # the fields (and equality) are the reference's five
    stats = None


class PathDB:
    """Per (src_switch, dst_switch) EV path tables, plus the padded
    per-pair port arrays the vectorized engine gathers from."""

    def __init__(self, topo: Topology, max_paths: int = 64):
        self.topo = topo
        self.max_paths = max_paths
        self._cache: dict[tuple[int, int], P.EVTable] = {}
        self._pair: dict[tuple[int, int], dict] = {}

    def table(self, s: int, d: int) -> P.EVTable:
        key = (s, d)
        if key not in self._cache:
            self._cache[key] = P.build_ev_table(self.topo, s, d,
                                                max_paths=self.max_paths)
        return self._cache[key]

    def pair_arrays(self, s: int, d: int) -> dict:
        """Padded hop-port matrix (no delivery port), hop counts,
        latencies and minimal-path index for one switch pair."""
        key = (s, d)
        if key not in self._pair:
            topo, tb = self.topo, self.table(s, d)
            n = tb.n_paths
            nh = np.asarray([len(h) for h in tb.hops], np.int32)
            ports = np.full((n, max(int(nh.max()), 1) if n else 1), -1,
                            np.int32)
            for p, hops in enumerate(tb.hops):
                u = s
                for hi, v in enumerate(hops):
                    ports[p, hi] = topo.port_id(u, topo.slot_of_edge[(u, v)])
                    u = v
            self._pair[key] = {
                "ports": ports, "n_hops": nh, "lat": tb.latency_ns,
                "n_paths": n, "min_path": int(np.argmax(tb.minimal_mask())),
            }
        return self._pair[key]

    def ports_of(self, fl: FlowSpec, path_idx: int) -> list[int]:
        topo = self.topo
        ssw, dsw = topo.ep_switch(fl.src_ep), topo.ep_switch(fl.dst_ep)
        tb = self.table(ssw, dsw)
        hops = tb.hops[path_idx]
        ports, u = [], ssw
        for v in hops:
            ports.append(topo.port_id(u, topo.slot_of_edge[(u, v)]))
            u = v
        ports.append(topo.delivery_port(fl.dst_ep))
        return ports


@dataclasses.dataclass
class FlowTable:
    """Padded per-flow path tables: the static host-side arrays one
    ``build_flow_table`` call produces and every scheme lane of
    :func:`simulate_batch` shares (path enumeration dominates setup at
    paper scale — build once, sweep all 11 schemes)."""

    topo: Topology
    max_paths: int
    path_ports: np.ndarray   # [F, P, H] global port id per hop, -1 pad
    path_valid: np.ndarray   # [F, P, H] bool
    path_len: np.ndarray     # [F, P] hops incl. delivery port
    path_lat: np.ndarray     # [F, P] f64 path latency ns (0 pad)
    n_paths: np.ndarray      # [F]
    path_mask: np.ndarray    # [F, P] bool — p < n_paths[f]
    min_path: np.ndarray     # [F] index of the minimal route
    size_bytes: np.ndarray   # [F]
    start: np.ndarray        # [F]

    @property
    def n_flows(self) -> int:
        return len(self.n_paths)

    @property
    def n_links(self) -> int:
        return self.topo.n_ports

    def weights(self, w_scale: float) -> np.ndarray:
        """Eq.-1 latency weights at ``w_scale`` for every flow's paths
        (elementwise identical to ``EVTable.weights``), 0 on padding."""
        lat = self.path_lat
        wmax = lat.max(axis=1, keepdims=True)
        w = wmax / np.maximum(lat, 1e-9)
        w = np.where(wmax > 0, w, 1.0)       # degenerate same-switch rows
        w = (w - 1.0) * w_scale + 1.0
        return np.where(self.path_mask, w, 0.0)


def build_flow_table(topo: Topology, flows: list[FlowSpec],
                     max_paths: int = 64, db: PathDB | None = None
                     ) -> FlowTable:
    """Assemble the padded [F, P, H] incidence arrays (cached per switch
    pair; the per-flow delivery port is appended as the final hop)."""
    db = db or PathDB(topo, max_paths)
    F = len(flows)
    pair_of = [(topo.ep_switch(f.src_ep), topo.ep_switch(f.dst_ep))
               for f in flows]
    pairs = {k: db.pair_arrays(*k) for k in set(pair_of)}
    Pm = max((pa["n_paths"] for pa in pairs.values()), default=1)
    Hm = max((int(pa["n_hops"].max()) if pa["n_paths"] else 0
              for pa in pairs.values()), default=0) + 1  # + delivery hop
    path_ports = np.full((F, Pm, Hm), -1, np.int32)
    path_len = np.zeros((F, Pm), np.int32)
    path_lat = np.zeros((F, Pm), np.float64)
    n_paths = np.zeros(F, np.int32)
    min_path = np.zeros(F, np.int32)
    for fi, fl in enumerate(flows):
        pa = pairs[pair_of[fi]]
        n = pa["n_paths"]
        nh = pa["n_hops"]
        path_ports[fi, :n, :pa["ports"].shape[1]] = pa["ports"]
        path_ports[fi, np.arange(n), nh] = topo.delivery_port(fl.dst_ep)
        path_len[fi, :n] = nh + 1
        path_lat[fi, :n] = pa["lat"]
        n_paths[fi] = n
        min_path[fi] = pa["min_path"]
    return FlowTable(
        topo=topo, max_paths=max_paths,
        path_ports=path_ports, path_valid=path_ports >= 0,
        path_len=path_len, path_lat=path_lat, n_paths=n_paths,
        path_mask=np.arange(Pm)[None, :] < n_paths[:, None],
        min_path=min_path,
        size_bytes=np.asarray([f.size_bytes for f in flows], np.float64),
        start=np.asarray([f.start for f in flows], np.float64))


class _DeviceTable:
    """A :class:`FlowTable`'s arrays as tensors on one device: ``safe``
    is the port id with padding at 0 (masked by ``valid`` wherever it is
    read), so gathers and scatters need no clamp."""

    def __init__(self, table: FlowTable, device: torch.device):
        def on(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        self.device = device
        self.valid = on(table.path_valid, torch.bool)
        self.safe = on(np.where(table.path_valid, table.path_ports, 0),
                       torch.int64)
        self.mask = on(table.path_mask, torch.bool)
        self.lat = on(table.path_lat, _F64)
        self.size = on(table.size_bytes, _F64)
        self.start = on(table.start, _F64)


class _Reads:
    """Counts the loop's device reads; every read goes through here."""

    def __init__(self):
        self.level = 0
        self.epoch = 0

    def values(self, xs: list[torch.Tensor], level: bool = False) -> list:
        """0-d tensors -> Python floats, in one read."""
        if level:
            self.level += 1
        else:
            self.epoch += 1
        return torch.stack([x.to(_F64) for x in xs]).tolist()

    def array(self, x: torch.Tensor) -> np.ndarray:
        self.epoch += 1
        return x.cpu().numpy()

    def nonzero(self, mask: torch.Tensor) -> torch.Tensor:
        self.epoch += 1
        return torch.nonzero(mask).flatten()


# ------------------------------------------------------------ water-filling
def _maxmin_rates_dense(link_idx: torch.Tensor, link_valid: torch.Tensor,
                        active: torch.Tensor, n_links: int,
                        cap0: torch.Tensor | None = None,
                        reads: _Reads | None = None) -> torch.Tensor:
    """Dense max-min fair rates over the padded incidence matrix, on the
    device of ``link_idx``.

    ``link_idx [F, H]`` / ``link_valid [F, H]`` are each flow's current
    links.  Per-link unfrozen counts and capacities update incrementally;
    a fill level freezes every unfrozen flow that crosses a link whose
    fair share is within 1e-12 of the smallest, at that share.  Each
    level reads the share and the count of newly frozen flows in one
    read (``reads.level``).  ``cap0`` (live capacities) zeroes failed
    links, so flows pinned across them freeze at rate 0."""
    reads = reads if reads is not None else _Reads()
    dev = link_idx.device
    F = link_idx.shape[0]
    rates = torch.zeros(F, dtype=_F64, device=dev)
    inc = link_valid & active[:, None]
    safe = torch.where(link_valid, link_idx, 0).long()
    flat = safe.reshape(-1)
    cap = torch.ones(n_links, dtype=_F64, device=dev) if cap0 is None \
        else cap0.to(_F64).clone()
    cnt = torch.zeros(n_links, dtype=torch.int64, device=dev).index_add_(
        0, flat, inc.reshape(-1).long())
    frozen = ~active
    while True:
        fair = torch.where(cnt > 0, cap / cnt, _INF)
        b = fair.min() if n_links else torch.tensor(_INF, device=dev)
        tight = fair <= b + 1e-12
        newly = (tight[safe] & inc).any(1) & ~frozen
        bv, n_new = reads.values([b, newly.sum()], level=True)
        if not (math.isfinite(bv) and n_new):
            break
        rates = torch.where(newly, b, rates)
        frozen |= newly
        dec = torch.zeros(n_links, dtype=torch.int64, device=dev).index_add_(
            0, flat, (newly[:, None] & link_valid).reshape(-1).long())
        cnt -= dec
        # two roundings (product, then difference), as numpy computes it
        cap = torch.clamp_min(cap - b * dec, 0.0)
    return rates


def _maxmin_rates(flow_links: list[np.ndarray], n_links: int,
                  active: np.ndarray, device=None) -> np.ndarray:
    """List-of-arrays front end for the dense water-filler (the
    reference's pre-vectorization signature), on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    F = len(flow_links)
    H = max((len(l) for l in flow_links), default=0) or 1
    idx = np.zeros((F, H), np.int64)
    valid = np.zeros((F, H), bool)
    for f, links in enumerate(flow_links):
        idx[f, :len(links)] = links
        valid[f, :len(links)] = True
    return _maxmin_rates_dense(
        torch.as_tensor(idx, device=dev), torch.as_tensor(valid, device=dev),
        torch.as_tensor(np.asarray(active, bool), device=dev),
        n_links).cpu().numpy()


# ------------------------------------------------------------- sampling
def _sample_rows(rng: np.random.Generator, w: torch.Tensor) -> torch.Tensor:
    """One weighted index per row (inverse CDF, one host uniform per
    row); all-zero rows return -1.  The row cumsum adds the columns one
    after another, numpy's order."""
    n, p = w.shape
    csum = w.clone()
    for j in range(1, p):
        csum[:, j] += csum[:, j - 1]
    tot = csum[:, -1:]
    u = torch.as_tensor(rng.random((n, 1)), device=w.device) * tot
    idx = (csum < u).sum(1).clamp_max(p - 1)
    return torch.where(tot[:, 0] > 0, idx, -1)


def _sample_rows_topk(rng: np.random.Generator, w: torch.Tensor, k: int,
                      logw: torch.Tensor) -> torch.Tensor:
    """``k`` distinct weighted draws per row in sampled order (Gumbel
    top-k); columns past a row's positive-weight count are -1.  ``logw``
    is numpy's ``log(max(w, 1e-300))`` wherever ``w > 0`` (the engine's
    per-run logs of its candidate weights).  The Gumbel term is numpy's,
    from the host draw."""
    gum = np.log(-np.log1p(-rng.random(tuple(w.shape))))
    g = torch.where(w > 0, logw - torch.as_tensor(gum, device=w.device),
                    -_INF)
    order = torch.topk(g, min(k, w.shape[1]), dim=1).indices
    valid = torch.gather(w, 1, order) > 0
    return torch.where(valid, order, -1)


# ---------------------------------------------------------------- engine
def _hot_links(load: torch.Tensor, load_host: np.ndarray,
               hot_frac: float) -> torch.Tensor:
    """Links whose load is at least the ``hot_frac`` quantile of the
    positive loads (and at least 1).  The quantile is numpy's, on the
    host copy ``load_host`` of ``load``; the compare runs on the
    device."""
    if not (load_host > 0).any():
        return torch.zeros(load.shape, dtype=torch.bool, device=load.device)
    thr = max(1.0, np.quantile(load_host[load_host > 0], hot_frac))
    return load >= float(thr)


def _registry():
    from repro_torch.net.policies import registry as REG
    return REG


def _init_choice(rule, table: FlowTable, rng: np.random.Generator,
                 w_scale: float) -> np.ndarray:
    """Flow-start path choice.  Per-flow draws (not batched) so the
    stream matches the scalar reference generator call-for-call — init
    is one-shot, the per-epoch hot path stays dense."""
    F = table.n_flows
    choice = np.zeros(F, np.int64)
    if rule.init == "minimal":
        return table.min_path.astype(np.int64).copy()
    if rule.init == "uniform":
        for fi in range(F):
            choice[fi] = rng.integers(table.n_paths[fi])
        return choice
    w = table.weights(w_scale)
    for fi in range(F):
        n = int(table.n_paths[fi])
        wr = w[fi, :n]
        choice[fi] = rng.choice(n, p=wr / wr.sum())
    return choice


def _compile_plan(topo: Topology, failure_plan):
    """FailureSchedule | FailurePlan -> (event byte-times, ports, caps).

    Event capacities are the fractional line rate ``1/event_ivl`` the
    packet engine's service intervals quantize to (0 = down), so both
    fidelities consume the identical compiled schedule."""
    if failure_plan is None:
        return None
    plan = failure_plan.compile() if hasattr(failure_plan, "compile") \
        else failure_plan
    ivl = np.asarray(plan.event_ivl, np.float64)
    caps = np.where(ivl > 0, 1.0 / np.maximum(ivl, 1.0), 0.0)
    return (plan.event_tick.astype(np.float64) * BYTES_PER_TICK,
            plan.port_id.astype(np.int64), caps)


def _run(rule, name: str, table: FlowTable, tab: _DeviceTable, *, seed: int,
         w_scale: float, hot_frac: float, max_epochs: int, plan,
         t_end: float | None) -> FlowResult:
    """One lane: the reference's epoch loop with its state on
    ``tab.device`` (see the module docstring)."""
    dev = tab.device
    rng = np.random.default_rng(seed)
    reads = _Reads()
    F = table.n_flows
    n_links = table.n_links
    ar = torch.arange(F, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    levels = 0

    choice = torch.as_tensor(_init_choice(rule, table, rng, w_scale),
                             device=dev)
    remaining = tab.size.clone()
    start = tab.start
    fct = torch.full((F,), -1.0, dtype=_F64, device=dev)
    done = torch.zeros(F, dtype=torch.bool, device=dev)
    t = 0.0
    resel = forced = rviol = zero
    epoch = -1

    cap_host = np.ones(n_links)    # live fractional capacity (0 = down)
    port_cap = torch.as_tensor(cap_host, device=dev)
    ev_i = 0
    path_alive = None        # [F, P] — lazily maintained under a plan

    # candidate weights per rule (static per run; failure events mask
    # dead paths at use time) and their logs, numpy's, for Gumbel top-k
    if rule.cands == "uniform":
        w_cand = table.path_mask.astype(np.float64)
    elif rule.cands == "eq1":
        w_cand = table.weights(1.0)
    else:
        w_cand = table.weights(w_scale)
    logw_cand = torch.as_tensor(np.log(np.maximum(w_cand, 1e-300)),
                                device=dev)
    w_cand = torch.as_tensor(w_cand, device=dev)
    w_unif = tab.mask.to(_F64)

    def apply_due_events(now: float) -> bool:
        nonlocal ev_i, path_alive, port_cap
        applied = False
        while ev_i < len(plan[0]) and plan[0][ev_i] <= now + 1e-9:
            cap_host[plan[1][ev_i]] = plan[2][ev_i]
            ev_i += 1
            applied = True
        if applied:
            port_cap = torch.as_tensor(cap_host.copy(), device=dev)
            path_alive = ~((port_cap == 0)[tab.safe] & tab.valid).any(dim=2)
        return applied

    def pending(now: float) -> list:
        """[any flow left, any active at ``now``, earliest pending
        start], one read."""
        left = remaining > 0
        first = torch.where(left, start, _INF).min() if F else \
            torch.tensor(_INF, device=dev)
        return reads.values([left.any(), (left & (start <= now + 1e-12))
                             .any(), first])

    if plan is not None:
        apply_due_events(0.0)   # tick <= 0 events are initial conditions

    known = None    # pending(t) when read at the end of the last epoch
    for epoch in range(max_epochs):
        if t_end is not None and t >= t_end - 1e-9:
            break                       # open-loop horizon reached
        if plan is not None:
            apply_due_events(t)
        next_ev = float(plan[0][ev_i]) if plan is not None \
            and ev_i < len(plan[0]) else None

        active = (remaining > 0) & (start <= t + 1e-12)
        any_left, any_active, first_start = known or pending(t)
        known = None
        if not any_active:
            if not any_left:
                break
            t_next = first_start
            if next_ev is not None:
                t_next = min(t_next, next_ev)
            t = t_next
            continue

        cur_safe = tab.safe[ar, choice]        # [F, H]
        cur_valid = tab.valid[ar, choice]

        # ---- per-epoch re-selection through the registry lane rule ----
        # epoch 0 runs the forced lane only (dead current paths under a
        # t<=0 plan): load feedback does not exist yet
        if rule.kind != "static" and (epoch > 0 or plan is not None):
            inc = active[:, None] & cur_valid
            load = torch.zeros(n_links, dtype=torch.int64, device=dev) \
                .index_add_(0, cur_safe.reshape(-1),
                            inc.reshape(-1).long()).to(_F64)
            if plan is not None:
                # capacity-normalized load (the raw count for binary plans)
                load = load / torch.where(port_cap > 0, port_cap, 1.0)
            hot = _hot_links(load, reads.array(load), hot_frac)
            cross_hot = (hot[cur_safe] & cur_valid).any(dim=1)
            if plan is not None:
                dead_cur = ((port_cap == 0)[cur_safe] & cur_valid).any(dim=1)
            else:
                dead_cur = torch.zeros(F, dtype=torch.bool, device=dev)
            if epoch == 0:
                aff = reads.nonzero(active & dead_cur)
            elif rule.kind == "respray":
                aff = reads.nonzero(active)
            else:
                aff = reads.nonzero(active & (cross_hot | dead_cur))
            if len(aff):
                alive = path_alive[aff] if path_alive is not None \
                    else tab.mask[aff]
                cand_w = torch.where(alive, w_cand[aff], 0.0)
                if rule.kind == "ugal":
                    # one uniform candidate vs current, by first-hop load
                    cand = _sample_rows(rng, torch.where(alive, w_unif[aff],
                                                         0.0))
                    cnd0 = tab.safe[aff, cand.clamp_min(0), 0]
                    cur0 = cur_safe[aff, 0]
                    moved = (cand >= 0) & (dead_cur[aff]
                                           | (load[cnd0] < load[cur0]))
                elif rule.kind == "evict":
                    cands = _sample_rows_topk(rng, cand_w, rule.n_cands,
                                              logw_cand[aff])
                    csafe = cands.clamp_min(0)
                    cports = tab.safe[aff[:, None], csafe]
                    cvalid = (tab.valid[aff[:, None], csafe]
                              & (cands >= 0)[:, :, None])
                    cload = torch.where(cvalid, load[cports], 0.0).amax(2)
                    cload = torch.where(cands < 0, _INF, cload)
                    key = cload
                    if rule.latency_pref:
                        key = cload + tab.lat[aff[:, None], csafe] * 1e-12
                    best_k = key.argmin(dim=1, keepdim=True)
                    cand = cands.gather(1, best_k)[:, 0]
                    best_load = cload.gather(1, best_k)[:, 0]
                    cur_load = torch.where(cur_valid[aff],
                                           load[cur_safe[aff]], 0.0).amax(1)
                    cur_load = torch.where(dead_cur[aff], _INF, cur_load)
                    moved = (cand >= 0) & (best_load
                                           < rule.hysteresis * cur_load)
                else:       # respray, recycle
                    if rule.kind == "recycle":
                        cand_w = torch.where(alive, w_unif[aff], 0.0)
                    cand = _sample_rows(rng, cand_w)
                    moved = cand >= 0
                was = choice[aff]
                changed = moved & (was != cand)
                choice[aff] = torch.where(moved, cand, was)
                resel = resel + changed.sum()
                forced = forced + (dead_cur[aff] & changed).sum()
                cur_safe = tab.safe[ar, choice]
                cur_valid = tab.valid[ar, choice]

        # ---- dense progressive filling --------------------------------
        before = reads.level
        rates = _maxmin_rates_dense(cur_safe, cur_valid, active, n_links,
                                    cap0=port_cap if plan is not None
                                    else None, reads=reads)
        levels += reads.level - before - 1    # the last read ends the loop
        if plan is not None:
            # conformance audit: allocated per-link rate never exceeds
            # the scheduled capacity (counts violating links per epoch).
            # The only sum in atomic order on the card; it feeds nothing
            # but this compare (PORT.md)
            link_r = torch.zeros(n_links, dtype=_F64, device=dev).index_add_(
                0, cur_safe.reshape(-1),
                torch.where(active[:, None] & cur_valid, rates[:, None],
                            0.0).reshape(-1))
            rviol = rviol + (link_r > port_cap + 1e-9).sum()
        pos = rates > 1e-15
        future = (remaining > 0) & (start > t)
        any_pos, dt_fill, first_future = reads.values([
            pos.any(), torch.where(pos, remaining / rates, _INF).min(),
            torch.where(future, start, _INF).min()])
        if not any_pos:
            cands_t = [first_future] if first_future < _INF else []
            if next_ev is not None:
                cands_t.append(next_ev)
            if not cands_t:
                break           # permanently stalled (e.g. static scheme
            t = min(cands_t)    # pinned across a dead link, no recovery)
            continue
        dt = dt_fill
        if first_future < _INF:
            dt = min(dt, first_future - t)
        if next_ev is not None:
            dt = min(dt, next_ev - t)
        if t_end is not None:
            # clamp the fill interval at the serving horizon: completions
            # exactly at t_end still record, the next epoch breaks
            dt = min(dt, t_end - t)
        remaining = remaining - rates * dt
        t += dt
        done_now = active & (remaining <= 1e-9) & ~done
        fct = torch.where(done_now, t - start, fct)
        done |= done_now
        remaining = torch.where(done_now, 0.0, remaining)
        known = pending(t)
        if not known[0]:
            break

    resel, forced, rviol = (int(v) for v in reads.values([resel, forced,
                                                          rviol]))
    res = FlowResult(fct=reads.array(fct), reselections=resel,
                     epochs=epoch + 1, forced=forced, rate_violations=rviol)
    res.stats = FlowStats(scheme=name, seed=int(seed), epochs=epoch + 1,
                          levels=levels, reads_level=reads.level,
                          reads_epoch=reads.epoch,
                          device=f"{choice.device.type}/"
                                 f"{remaining.device.type}")
    return res


def simulate(topo: Topology, flows: list[FlowSpec], scheme, *,
             seed: int = 0, w_scale: float = 3.0, max_paths: int = 64,
             hot_frac: float = 0.85, max_epochs: int = 100000,
             failure_plan=None, table: FlowTable | None = None,
             t_end: float | None = None, device=None) -> FlowResult:
    """Run the flow-level simulation for one registry scheme on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).

    ``scheme`` is a registry name / code / PolicyDef; its
    ``flow_level`` rule drives path init and per-epoch re-selection.
    ``table`` shares a prebuilt :class:`FlowTable` across runs.
    ``failure_plan`` is a ``FailureSchedule`` or compiled ``FailurePlan``
    in ticks; events convert to byte-times via ``BYTES_PER_TICK``.
    ``t_end`` (byte-time) is the open-loop serving horizon (DESIGN.md
    §15): the epoch loop stops once time reaches it and flows still in
    flight keep ``fct == -1``."""
    dev = resolve_device(device)
    REG = _registry()
    table = table if table is not None else build_flow_table(
        topo, flows, max_paths=max_paths)
    return _run(REG.flow_rule(scheme), REG.resolve(scheme).name, table,
                _DeviceTable(table, dev), seed=seed, w_scale=w_scale,
                hot_frac=hot_frac, max_epochs=max_epochs,
                plan=_compile_plan(topo, failure_plan), t_end=t_end)


def simulate_batch(topo: Topology, flows: list[FlowSpec], schemes,
                   seeds=(0,), *, w_scale: float = 3.0,
                   max_paths: int = 64, hot_frac: float = 0.85,
                   max_epochs: int = 100000, failure_plan=None,
                   table: FlowTable | None = None,
                   t_end: float | None = None, device=None
                   ) -> dict[str, list[FlowResult]]:
    """Scheme x seed sweep over ONE shared :class:`FlowTable`, moved to
    ``device`` once (the card by default).  Returns ``{registry_name:
    [FlowResult per seed]}`` in the order of the ``schemes`` argument;
    every lane equals its solo :func:`simulate`."""
    dev = resolve_device(device)
    REG = _registry()
    table = table if table is not None else build_flow_table(
        topo, flows, max_paths=max_paths)
    names = [REG.resolve(s).name for s in schemes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate schemes in sweep: {names} — lanes "
                         "are keyed by registry name")
    tab = _DeviceTable(table, dev)
    plan = _compile_plan(topo, failure_plan)
    return {name: [_run(REG.flow_rule(name), name, table, tab, seed=seed,
                        w_scale=w_scale, hot_frac=hot_frac,
                        max_epochs=max_epochs, plan=plan, t_end=t_end)
                   for seed in seeds]
            for name in names}
