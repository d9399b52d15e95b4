"""Host-side failure/capacity schedule builder (DESIGN.md §10).

Port of ``repro.net.sim.failures`` (numpy only): the same schedules
compile to the same :class:`~repro_torch.net.sim.types.FailurePlan`
arrays, with the same errors.

Declarative front-end for the engine's capacity timeline: scenarios say
*what* degrades and *when* in topology terms (links, switches, flapping
periods, brownout rates) and :meth:`FailureSchedule.compile` lowers
that to the sorted per-port event arrays a
:class:`~repro_torch.net.sim.types.FailurePlan` holds.  Binary failures are
the ``rate == 0`` special case of the same timeline, so every builder
compiles into one event stream:

    sched = FailureSchedule(topo)
    sched.fail_links(at=2048, links=[(0, 5), (3, 7)])
    sched.degrade_links(at=4096, links=[(1, 2)], rate=0.25, until=30000)
    sched.drain_switch(at=8192, switch=3, over=4096, steps=4)
    sched.recover(at=32768)                    # everything degraded/down
    spec = build_spec(topo, flows, SPRAY_W, failure_plan=sched)

Rates are fractions of line rate in ``[0, 1]`` and quantize to integer
*service intervals* (ticks per packet, ``ivl = round(1/rate)``): 1 tick
= one full-rate packet serialization, so a 0.25-rate brownout services
one packet every 4 ticks.  ``rate=0`` compiles to exactly the event a
``fail_links`` call emits — the bit-identity the conformance suite
pins.

A link is an undirected switch pair ``(u, v)``: both directed ports
change state together.  A switch event takes every port that touches
the switch — its egress ports, each neighbor's port pointing at it, and
the delivery ports of its endpoints.  ACK/NACK reverse paths are
abstract (prop-only ``ret_ticks``) and never degrade — see DESIGN.md
§10.
"""
from __future__ import annotations

import numpy as np

from repro_torch.net.sim.types import FailurePlan
from repro_torch.net.topology.base import Topology

# intervals longer than this would overflow horizon arithmetic long
# before they are physically meaningful (2^16 ticks/packet ~ 6 Mb/s on
# a 400 Gb/s link); use rate=0 / fail_links for a dead link instead
MAX_IVL = 1 << 16


def rate_to_ivl(rate: float) -> int:
    """Quantize a fractional line rate to the integer service interval
    the device timeline uses (``0`` = down, ``1`` = full rate, ``k`` =
    one packet every ``k`` ticks).  Both engines consume the *quantized*
    rate, so packet- and flow-level fidelities see identical schedules."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be within [0, 1], got {rate}")
    if rate == 0.0:
        return 0
    ivl = int(round(1.0 / rate))
    if ivl > MAX_IVL:
        raise ValueError(f"rate {rate} quantizes to interval {ivl} > "
                         f"{MAX_IVL}; use rate=0 (down) instead")
    return max(ivl, 1)


def ivl_to_rate(ivl: int) -> float:
    """Inverse of :func:`rate_to_ivl`: 0 ticks/packet means down."""
    return 0.0 if ivl <= 0 else 1.0 / ivl


class FailureSchedule:
    """Accumulates (tick, port, interval) declarations; ``compile()``
    deduplicates same-tick same-port redeclarations (last write wins)
    and sorts deterministically by (tick, port)."""

    def __init__(self, topo: Topology):
        self.topo = topo
        self._ev: list[tuple[int, int, int]] = []

    # ------------------------------------------------------------- resolvers
    def _check_switch(self, sw: int) -> int:
        sw = int(sw)
        if not 0 <= sw < self.topo.n_switches:
            raise ValueError(f"switch {sw} out of range "
                             f"[0, {self.topo.n_switches})")
        return sw

    def _link_ports(self, u: int, v: int) -> list[int]:
        topo = self.topo
        u, v = self._check_switch(u), self._check_switch(v)
        try:
            return [topo.port_id(u, topo.slot_of_edge[(u, v)]),
                    topo.port_id(v, topo.slot_of_edge[(v, u)])]
        except KeyError:
            raise ValueError(f"no link between switches {u} and {v}") \
                from None

    def _switch_ports(self, sw: int) -> list[int]:
        topo = self.topo
        sw = self._check_switch(sw)
        ports = []
        for r in range(topo.radix):
            nb = int(topo.nbr[sw, r])
            if nb < 0:
                continue
            ports.append(topo.port_id(sw, r))
            ports.append(topo.port_id(nb, topo.slot_of_edge[(nb, sw)]))
        for ep in range(sw * topo.eps_per_switch,
                        (sw + 1) * topo.eps_per_switch):
            ports.append(topo.delivery_port(ep))
        return ports

    # ----------------------------------------------------------- primitives
    def set_port_ivl(self, at: int, ports, ivl: int) -> "FailureSchedule":
        """Lowest level: schedule raw port ids to a service interval
        (``0`` = down, ``1`` = full rate, ``k`` = rate ``1/k``)."""
        if at < 0:
            raise ValueError(f"event tick must be >= 0, got {at}")
        if not 0 <= ivl <= MAX_IVL:
            raise ValueError(f"interval {ivl} out of range [0, {MAX_IVL}]")
        for p in ports:
            p = int(p)
            if not 0 <= p < self.topo.n_ports:
                raise ValueError(f"port {p} out of range")
            self._ev.append((int(at), p, int(ivl)))
        return self

    def set_ports(self, at: int, ports, up: bool) -> "FailureSchedule":
        """Low-level: schedule raw port ids to a binary state at a tick."""
        return self.set_port_ivl(at, ports, 1 if up else 0)

    # ----------------------------------------------------------- link level
    def fail_links(self, at: int, links) -> "FailureSchedule":
        for (u, v) in links:
            self.set_port_ivl(at, self._link_ports(u, v), 0)
        return self

    def recover_links(self, at: int, links) -> "FailureSchedule":
        for (u, v) in links:
            self.set_port_ivl(at, self._link_ports(u, v), 1)
        return self

    def set_rate(self, at: int, links, rate: float) -> "FailureSchedule":
        """Set each link's two ports to a fractional line rate at a tick.
        ``rate=0`` compiles to the identical event ``fail_links`` emits;
        ``rate=1`` restores full capacity (== ``recover_links``)."""
        ivl = rate_to_ivl(rate)
        for (u, v) in links:
            self.set_port_ivl(at, self._link_ports(u, v), ivl)
        return self

    def degrade_links(self, at: int, links, rate: float, *,
                      until: int | None = None) -> "FailureSchedule":
        """Brownout window: the links run at ``rate`` from ``at``, and —
        when ``until`` is given — return to full rate there."""
        self.set_rate(at, links, rate)
        if until is not None:
            if until <= at:
                raise ValueError(f"until ({until}) must be > at ({at})")
            self.recover_links(until, links)
        return self

    def oversubscribe(self, at: int, links, factor: float, *,
                      until: int | None = None) -> "FailureSchedule":
        """Oversubscribed uplinks: ``factor``x the traffic shares each
        link, so the per-flow effective capacity is ``1/factor`` of line
        rate (the classic ``factor:1`` taper)."""
        if factor < 1.0:
            raise ValueError(f"oversubscription factor must be >= 1, "
                             f"got {factor}")
        return self.degrade_links(at, links, 1.0 / factor, until=until)

    def background_tenant(self, at: int, links, share: float, *,
                          until: int | None = None) -> "FailureSchedule":
        """A co-located tenant consumes ``share`` of each link's
        bandwidth outside this simulation's traffic; the foreground
        workload sees the remaining ``1 - share``."""
        if not 0.0 <= share < 1.0:
            raise ValueError(f"background share must be in [0, 1), "
                             f"got {share}")
        return self.degrade_links(at, links, 1.0 - share, until=until)

    def recover(self, at: int) -> "FailureSchedule":
        """Restore full rate on every port scheduled down *or degraded*
        before ``at`` (and not already back at full rate by then) — 'the
        outage ends here'."""
        impaired = set()
        for t, p, ivl in sorted(self._ev, key=lambda e: e[0]):
            if t >= at:
                continue
            (impaired.discard if ivl == 1 else impaired.add)(p)
        return self.set_port_ivl(at, sorted(impaired), 1)

    # --------------------------------------------------------- switch level
    def fail_switch(self, at: int, switch: int) -> "FailureSchedule":
        return self.set_port_ivl(at, self._switch_ports(switch), 0)

    def recover_switch(self, at: int, switch: int) -> "FailureSchedule":
        return self.set_port_ivl(at, self._switch_ports(switch), 1)

    def drain_switch(self, at: int, switch: int, *, over: int = 0,
                     steps: int = 4,
                     until: int | None = None) -> "FailureSchedule":
        """Rolling maintenance drain: ramp every port touching the
        switch from full rate down to 0 across ``steps`` rate events
        spanning ``over`` ticks (fully down at ``at + over``), then —
        when ``until`` is given — bring the switch back at full rate.
        ``over=0`` degenerates to ``fail_switch``."""
        ports = self._switch_ports(switch)
        if over < 0:
            raise ValueError(f"drain span must be >= 0, got {over}")
        if over == 0 or steps <= 1:
            self.set_port_ivl(at, ports, 0)
        else:
            for k in range(steps):
                rate = 1.0 - (k + 1) / steps
                self.set_port_ivl(at + (k * over) // (steps - 1), ports,
                                  rate_to_ivl(rate))
        if until is not None:
            if until <= at + over:
                raise ValueError(f"until ({until}) must be > drain end "
                                 f"({at + over})")
            self.set_port_ivl(until, ports, 1)
        return self

    def flap(self, links, period: int, *, at: int = 0,
             until: int, down_frac: float = 0.5) -> "FailureSchedule":
        """Periodic fail/recover: down at ``at + k*period`` and back up
        ``down_frac`` of a period later, for all cycles before ``until``.
        The links are healthy after the window — a final down-phase that
        would outlive ``until`` is cut short by a recovery at ``until``."""
        if period <= 0:
            raise ValueError("flap period must be positive")
        down_ticks = max(1, int(round(period * down_frac)))
        if down_ticks >= period:
            raise ValueError("down_frac must leave up-time within a period")
        t = int(at)
        while t < until:
            self.fail_links(t, links)
            self.recover_links(min(t + down_ticks, until), links)
            t += period
        return self

    # -------------------------------------------------------------- compile
    def compile(self) -> FailurePlan:
        """Lower to sorted event arrays.  Repeated declarations for the
        same (tick, port) collapse to the **last** one in declaration
        order (the state the engine's scatter-max tiebreak would land on
        anyway — deduplicating here makes the compiled plan canonical),
        then events sort deterministically by (tick, port)."""
        last: dict[tuple[int, int], int] = {}
        for t, p, ivl in self._ev:
            last[(t, p)] = ivl
        order = sorted(last)
        ivls = np.asarray([last[k] for k in order], np.int32)
        return FailurePlan(
            event_tick=np.asarray([t for t, _ in order], np.int32),
            port_id=np.asarray([p for _, p in order], np.int32),
            port_up=ivls > 0,
            event_ivl=ivls,
        )


def all_links(topo: Topology) -> list[tuple[int, int]]:
    """Every undirected switch-switch link, one ``(u, v)`` per pair."""
    seen, out = set(), []
    for s in range(topo.n_switches):
        for r in range(topo.radix):
            v = int(topo.nbr[s, r])
            if v >= 0 and (v, s) not in seen:
                seen.add((s, v))
                out.append((s, v))
    return out


def sample_links(topo: Topology, k: int, seed: int = 0
                 ) -> list[tuple[int, int]]:
    """``k`` distinct undirected links, uniformly sampled — the common
    fixture for failure scenarios (benchmarks and tests share it)."""
    links = all_links(topo)
    rng = np.random.default_rng(seed)
    return [links[i] for i in rng.choice(len(links), k, replace=False)]


def static_plan(topo: Topology, links, at: int = 0) -> FailurePlan:
    """Plan equivalent of a ``failed_links=`` build: the given links go down
    at tick ``at`` (default 0 — folded into the initial mask) and stay down."""
    return FailureSchedule(topo).fail_links(at, links).compile()


def chaos_schedule(topo: Topology, *, horizon: int, seed: int,
                   n_events: int = 4, max_links: int = 3,
                   settle_frac: float = 0.5) -> FailureSchedule:
    """Seeded randomized capacity schedule — the chaos tier's generator.

    Draws ``n_events`` independent degradation waves from
    ``default_rng(seed)``: brownouts, full outages, oversubscription,
    background tenants, flapping links and rolling switch drains, each
    over randomly sampled links/switches with random onset inside the
    first ``settle_frac`` of ``horizon``.  Every wave recovers before
    ``settle_frac * horizon``, so an *adaptive* scheme has the back half
    of the horizon to degrade gracefully — the guard contract chaos
    cells assert.  Identical ``(topo, horizon, seed, ...)`` always
    yields the identical compiled plan; recording the seed reproduces
    the cell.
    """
    if horizon <= 8:
        raise ValueError(f"chaos horizon too short: {horizon}")
    rng = np.random.default_rng(seed)
    sched = FailureSchedule(topo)
    links = all_links(topo)
    settle = max(2, int(horizon * settle_frac))
    rates = (0.5, 0.25, 0.125, 0.0)
    for _ in range(n_events):
        kind = rng.choice(["brownout", "outage", "oversub", "tenant",
                           "flap", "drain"])
        k = int(rng.integers(1, max_links + 1))
        ev_links = [links[i] for i in
                    rng.choice(len(links), k, replace=False)]
        at = int(rng.integers(1, max(2, settle // 2)))
        until = int(rng.integers(at + 1, settle + 1))
        if kind == "brownout":
            sched.degrade_links(at, ev_links,
                                rate=float(rng.choice(rates[:-1])),
                                until=until)
        elif kind == "outage":
            sched.fail_links(at, ev_links)
            sched.recover_links(until, ev_links)
        elif kind == "oversub":
            sched.oversubscribe(at, ev_links,
                                factor=float(rng.choice([2.0, 4.0, 8.0])),
                                until=until)
        elif kind == "tenant":
            sched.background_tenant(at, ev_links,
                                    share=float(rng.choice([0.5, 0.75])),
                                    until=until)
        elif kind == "flap":
            period = max(2, (until - at) // max(int(rng.integers(1, 4)), 1))
            sched.flap(ev_links, period=period, at=at, until=until)
        else:
            sw = int(rng.integers(topo.n_switches))
            over = max(0, (until - at) // 2)
            sched.drain_switch(at, sw, over=over, steps=4, until=until)
    # belt-and-braces: nothing may stay impaired past the settle point
    sched.recover(settle)
    return sched
