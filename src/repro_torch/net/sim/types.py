"""Static simulation spec + runtime state containers for the packet sim.

Port of ``repro.net.sim.types``: the same fields and codes, so a spec
built by either package carries across (``spec_from_arrays``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------- LB schemes
MINIMAL = 0
VALIANT = 1
UGAL_L = 2
ECMP = 3
FLICR_W = 4
OPS_U = 5
OPS_W = 6
SCOUT = 7       # Spritz-Scout (weighted)
SPRAY_U = 8     # Spritz-Spray (uniform)
SPRAY_W = 9     # Spritz-Spray (weighted)
REPS = 10       # REPS entropy recycling (arXiv:2407.21625)

# Integer codes are the spec/CSV ABI; names, device functions and host
# lane rules live in repro_torch.net.policies.registry (DESIGN.md §11) — it
# validates itself against this table at import time.
SCHEME_NAMES = {
    MINIMAL: "minimal", VALIANT: "valiant", UGAL_L: "ugal_l", ECMP: "ecmp",
    FLICR_W: "flicr_w", OPS_U: "ops_u", OPS_W: "ops_w",
    SCOUT: "spritz_scout", SPRAY_U: "spritz_spray_u", SPRAY_W: "spritz_spray_w",
    REPS: "reps",
}

# ------------------------------------------------------------- packet states
P_FREE, P_QUEUED, P_PROP, P_ACKWAIT, P_NACKWAIT, P_LOST = 0, 1, 2, 3, 4, 5

# ------------------------------------------------------------ feedback codes
FB_ACK_OK, FB_ACK_ECN, FB_NACK, FB_TIMEOUT, FB_NONE = 0, 1, 2, 3, 4


def enqueue_bound(n_pkt: int, n_ports: int, n_eps: int) -> int:
    """Per-tick enqueue bound M (DESIGN.md §14): each port services <= 1
    packet/tick with constant per-port propagation latency, so forwarded
    arrivals are <= n_ports; endpoint arbitration admits <= 1 injection
    per source endpoint.  The engine's compacted enqueue arrays are [M],
    never [n_pkt] — per-tick FIFO/RED/trim work scales with the active
    set, not the table."""
    return int(min(n_pkt, n_ports + n_eps + 8))


def _empty_i32() -> np.ndarray:
    return np.zeros(0, np.int32)


def _empty_bool() -> np.ndarray:
    return np.zeros(0, bool)


@dataclasses.dataclass
class FailurePlan:
    """Time-scheduled port capacity events (DESIGN.md §10).

    Each event sets one port's *service interval* ``event_ivl``: ticks
    per serviced packet.  ``0`` means the port is down, ``1`` is full
    rate, ``k`` is rate ``1/k`` of line rate — so a binary up/down
    timeline is the ``ivl ∈ {0, 1}`` special case and ``port_up`` is
    always exactly ``event_ivl > 0``.  Sorted by ``event_tick`` (stable
    in declaration order for ties — the last event at a tick wins per
    port).  Events at tick <= 0 are initial conditions: the engine folds
    them into the starting ``port_up``/``port_ivl`` state, so a plan
    whose down-events all fire at t=0 is bit-identical to a static
    ``failed_links`` build.  Usually produced by
    :class:`repro_torch.net.sim.failures.FailureSchedule`, not by hand.
    """

    event_tick: np.ndarray           # [E] i32, sorted ascending
    port_id: np.ndarray              # [E] i32
    port_up: np.ndarray              # [E] bool (True = link recovers)
    event_ivl: np.ndarray | None = None  # [E] i32 ticks/packet (0 = down);
    #   synthesized from port_up (up -> 1, down -> 0) when omitted, so
    #   pre-rate callers keep the three-array constructor.

    def __post_init__(self):
        self.event_tick = np.asarray(self.event_tick, np.int32)
        self.port_id = np.asarray(self.port_id, np.int32)
        self.port_up = np.asarray(self.port_up, bool)
        if self.event_ivl is None:
            self.event_ivl = np.where(self.port_up, 1, 0).astype(np.int32)
        self.event_ivl = np.asarray(self.event_ivl, np.int32)
        if not (len(self.event_tick) == len(self.port_id)
                == len(self.port_up) == len(self.event_ivl)):
            raise ValueError("FailurePlan arrays must share one length")
        if len(self.event_tick) and (np.diff(self.event_tick) < 0).any():
            raise ValueError("FailurePlan events must be sorted by tick")
        if len(self.event_tick) and (self.event_tick < 0).any():
            raise ValueError("FailurePlan event ticks must be >= 0")
        if len(self.port_id) and (self.port_id < 0).any():
            raise ValueError("FailurePlan port ids must be >= 0")
        if len(self.event_ivl) and (self.event_ivl < 0).any():
            raise ValueError("FailurePlan intervals must be >= 0")
        if len(self.event_ivl) and \
                ((self.event_ivl > 0) != self.port_up).any():
            raise ValueError("FailurePlan port_up must equal event_ivl > 0")

    @property
    def n_events(self) -> int:
        return len(self.event_tick)

    @property
    def has_rate_events(self) -> bool:
        """True when any event sets a *degraded* (not binary) rate — the
        engine runs the rate machinery only for such plans."""
        return bool((self.event_ivl > 1).any())

    def port_ivl_at(self, t: int, n_ports: int) -> np.ndarray:
        """Host-side oracle: per-port service interval *during* tick
        ``t`` (events at tick <= t applied, in order).  A down port
        keeps its pre-outage interval."""
        ivl = np.ones(n_ports, np.int32)
        for i in range(self.n_events):
            if self.event_tick[i] > t:
                break
            if self.event_ivl[i] > 0:
                ivl[self.port_id[i]] = int(self.event_ivl[i])
        return ivl


@dataclasses.dataclass
class SimSpec:
    """Host-built static spec: all arrays are NumPy, converted once by run()."""

    name: str
    scheme: int
    n_ports: int
    qsize: int                       # packets per port (1 x BDP)
    kmin: float                      # ECN RED thresholds (packets)
    kmax: float
    n_ticks: int
    n_pkt: int                       # packet table capacity
    rto_ticks: int
    cwnd_init: float                 # 1.5 x BDP (packets)
    cwnd_max: float

    # flows
    src_ep: np.ndarray               # [F]
    dst_ep: np.ndarray               # [F]
    size_pkts: np.ndarray            # [F]
    start_tick: np.ndarray           # [F]
    dep: np.ndarray                  # [F] flow that must complete first (-1 none)
    bg_mask: np.ndarray              # [F] True => background flow pinned to ECMP

    # per-flow path tables (padded to P_MAX / H_MAX)
    path_ports: np.ndarray           # [F, P, H] global port id, -1 pad
    path_len: np.ndarray             # [F, P] hops incl. delivery port
    path_lat_ns: np.ndarray          # [F, P] Table-I latency (no delivery)
    n_paths: np.ndarray              # [F]
    weights: np.ndarray              # [F, P] sampling weights for this scheme
    valiant_w: np.ndarray            # [F, P] per-hop-uniform Valiant weights
    static_path: np.ndarray          # [F] ECMP/minimal static choice
    min_path: np.ndarray             # [F] index of the minimal/static route
    ret_ticks: np.ndarray            # [F, P] ACK return latency (ticks)
    rem_ticks: np.ndarray            # [F, P, H] fwd prop remaining from hop h
    port_lat: np.ndarray             # [n_ports] per-link prop+switch ticks
    port_failed: np.ndarray          # [n_ports] bool — link state before the
    #   first timeline event (failed_links= builds set it; timeline events at
    #   tick <= 0 are folded on top by the engine's init)

    # failure timeline (DESIGN.md §10): compiled FailurePlan arrays.  Empty
    # arrays (the default) mean a static network — the engine skips the
    # whole event phase at trace time.
    fail_event_tick: np.ndarray = dataclasses.field(
        default_factory=_empty_i32)  # [E] i32 sorted
    fail_event_port: np.ndarray = dataclasses.field(
        default_factory=_empty_i32)  # [E] i32
    fail_event_up: np.ndarray = dataclasses.field(
        default_factory=_empty_bool)  # [E] bool
    fail_event_ivl: np.ndarray = dataclasses.field(
        default_factory=_empty_i32)  # [E] i32 ticks/packet (0 = down); may
    #   be left empty by pre-rate callers — the engine then derives the
    #   binary encoding (up -> 1, down -> 0) from fail_event_up

    # spritz
    explore_threshold: int = 44
    ecn_threshold: int = 8
    min_bias_factor: float = 8.0
    block_ticks: int = 1 << 18   # timeout-block (§IV-C "global timer"):
    #   tuned to production failure durations — long relative to experiment
    #   horizons, so a dead path is probed at most a handful of times

    # flicr
    flicr_ecn_move: int = 8          # marks on current path before moving
    flicr_gap: int = 64              # flowlet gap (ticks)

    # cc
    dctcp_g: float = 1.0 / 16.0
    quick_adapt: bool = True
    fast_increase: bool = True

    # engine kernel dispatch: route the tick's dense phases
    # (rank/RED-ECN/flow-agg/spritz-select) through repro_torch.kernels.ops
    # — the CUDA kernels for tensors on the card, their plain torch
    # versions for tensors on the CPU.  None (the default) means on;
    # False runs the engine's own torch forms of the same phases.
    use_kernels: bool | None = None

    @property
    def n_flows(self) -> int:
        return len(self.src_ep)


class SimResult(NamedTuple):
    fct_ticks: np.ndarray            # [F] completion tick - start (-1 if not done)
    delivered: np.ndarray            # [F] packets delivered OK
    trims: np.ndarray                # [F] trimmed (NACKed) packets
    timeouts: np.ndarray             # [F] timeout events
    ooo: np.ndarray                  # [F] out-of-order deliveries (PSN skew)
    retx: np.ndarray                 # [F] retransmissions injected
    done: np.ndarray                 # [F] bool
    # engine counters (DESIGN.md §4): virtual time covered vs device steps
    # actually executed — their ratio is the event-compression factor.
    ticks_simulated: int = -1
    steps_executed: int = -1
    # conformance counter (DESIGN.md §10): services across a down port.
    # The kill rule + enqueue mask must keep this at exactly 0; the
    # failover property suite asserts it.
    down_violations: int = 0
    # conformance counter (DESIGN.md §10): services spaced closer than a
    # port's scheduled interval (i.e. throughput above the scheduled
    # rate).  The analytic slot math must keep this at exactly 0; the
    # capacity-schedule property suite asserts it.
    rate_violations: int = 0
    # the port's loop (not in the reference): gated steps it ran, those
    # past the stop included (>= steps_executed; see engine.run)
    replays: int = -1

    @property
    def compression(self) -> float:
        """Virtual ticks covered per executed device step."""
        return self.ticks_simulated / max(self.steps_executed, 1)


def spec_from_arrays(fields: dict) -> SimSpec:
    """A :class:`SimSpec` from another package's spec fields
    (``dataclasses.asdict`` of a spec with the same field names, arrays
    as NumPy).  Arrays are copied with the dtypes this package builds."""
    names = {f.name for f in dataclasses.fields(SimSpec)}
    missing = names - set(fields)
    if missing:
        raise ValueError(f"spec fields missing: {sorted(missing)}")
    kw = {}
    for f in dataclasses.fields(SimSpec):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = np.array(v, dtype=_ARRAY_DTYPES.get(f.name, v.dtype))
        kw[f.name] = v
    return SimSpec(**kw)


_ARRAY_DTYPES = {
    "src_ep": np.int32, "dst_ep": np.int32, "size_pkts": np.int32,
    "start_tick": np.int32, "dep": np.int32, "bg_mask": bool,
    "path_ports": np.int32, "path_len": np.int32,
    "path_lat_ns": np.float32, "n_paths": np.int32, "weights": np.float32,
    "valiant_w": np.float32, "static_path": np.int32, "min_path": np.int32,
    "ret_ticks": np.int32, "rem_ticks": np.int32, "port_lat": np.int32,
    "port_failed": bool, "fail_event_tick": np.int32,
    "fail_event_port": np.int32, "fail_event_up": bool,
    "fail_event_ivl": np.int32,
}
