"""Sender-policy registry (DESIGN.md §11).

Port of ``repro.net.policies.registry``.  The host table is complete:
all 11 schemes with their name, code, family, lane rules, failover flag
and flow-level rule, which ``build_spec`` and ``lane_arrays`` read.  The
device functions exist for the static and Spritz families; asking the
engine for any other scheme raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.net.policies import base as PB
from repro_torch.net.policies import spritz as _spritz
from repro_torch.net.policies import static as _static
from repro_torch.net.sim import types as T

_TODO = 'ROADMAP.md queue 1, "The rest of the policy layer"'

# schemes whose device functions are still to port: host rules only
_HOST_ONLY = (
    PB.PolicyDef(name="ugal_l", code=T.UGAL_L, family=None,
                 flow_level=PB.FlowLevelRule("ugal", init="weighted",
                                             n_cands=1),
                 doc="UGAL-L adaptive routing", todo=_TODO),
    PB.PolicyDef(name="flicr_w", code=T.FLICR_W, family="flicr",
                 flow_level=PB.FlowLevelRule("evict", init="weighted",
                                             cands="eq1_scaled", n_cands=1,
                                             hysteresis=1.0),
                 doc="FLICR flowlet switching, Eq.-1 weights", todo=_TODO),
    PB.PolicyDef(name="ops_u", code=T.OPS_U, family=None,
                 uniform_weights=True, failover=True,
                 flow_level=PB.FlowLevelRule("respray"),
                 doc="oblivious packet spraying, uniform over live paths",
                 todo=_TODO),
    PB.PolicyDef(name="ops_w", code=T.OPS_W, family=None, failover=True,
                 flow_level=PB.FlowLevelRule("respray", init="weighted",
                                             cands="eq1_scaled"),
                 doc="oblivious packet spraying, Eq.-1 weights", todo=_TODO),
    PB.PolicyDef(name="reps", code=T.REPS, family="reps",
                 uniform_weights=True, failover=True,
                 flow_level=PB.FlowLevelRule("recycle", n_cands=1),
                 doc="REPS entropy recycling", todo=_TODO),
)


def _build() -> tuple[PB.PolicyDef, ...]:
    defs = [*_static.make_policies((T.MINIMAL, T.ECMP, T.VALIANT)),
            *_spritz.make_policies((T.SCOUT, T.SPRAY_U, T.SPRAY_W)),
            *_HOST_ONLY]
    defs.sort(key=lambda p: p.code)
    codes = [p.code for p in defs]
    if codes != list(range(len(defs))):
        raise RuntimeError(f"policy codes must be contiguous 0..n-1: {codes}")
    for p in defs:
        if T.SCHEME_NAMES.get(p.code) != p.name:
            raise RuntimeError(f"policy {p.name} (code {p.code}) disagrees "
                               f"with types.SCHEME_NAMES")
    return tuple(defs)


_POLICIES: tuple[PB.PolicyDef, ...] = _build()
_BY_NAME = {p.name: p for p in _POLICIES}


# ------------------------------------------------------------------ lookup
def all_policies() -> tuple[PB.PolicyDef, ...]:
    """Every registered policy, ordered by scheme code."""
    return _POLICIES


def by_code(code: int) -> PB.PolicyDef:
    if not 0 <= code < len(_POLICIES):
        raise ValueError(f"unknown scheme code {code}")
    return _POLICIES[code]


def by_name(name: str) -> PB.PolicyDef:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; known: {sorted(_BY_NAME)}") from None


def resolve(scheme) -> PB.PolicyDef:
    """Name, PolicyDef or integer code -> PolicyDef."""
    if isinstance(scheme, PB.PolicyDef):
        return scheme
    if isinstance(scheme, str):
        return by_name(scheme)
    return by_code(int(scheme))


def as_code(scheme) -> int:
    return resolve(scheme).code


def names() -> list[str]:
    return [p.name for p in _POLICIES]


def device_policy(scheme) -> PB.PolicyDef:
    """The policy with its device functions; raises for a scheme whose
    device functions the port does not have yet."""
    p = resolve(scheme)
    if p.choose_path is None:
        raise NotImplementedError(
            f"scheme {p.name!r} is not ported to repro_torch yet: {p.todo}")
    return p


# --------------------------------------------------- device-side assembly
def init_state(weights: np.ndarray, static_path: np.ndarray,
               device) -> dict:
    """The policy state dict: one substate per ported family."""
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    sp = torch.as_tensor(np.asarray(static_path, np.int32), device=device)
    out: dict = {}
    for p in _POLICIES:
        if p.family and p.init_state is not None and p.family not in out:
            out[p.family] = p.init_state(w, sp)
    return out


# ------------------------------------------------------- host lane rules
def lane_weights(spec, scheme) -> np.ndarray:
    """A scheme lane's sampling weights derived from a base spec,
    mirroring ``build_spec``'s per-scheme rules (DESIGN.md §5)."""
    p = resolve(scheme)
    if p.uniform_weights:
        F, P = spec.weights.shape
        w = np.zeros((F, P), np.float32)
        for fi in range(F):
            w[fi, :int(spec.n_paths[fi])] = 1.0
        return w
    if resolve(spec.scheme).uniform_weights:
        raise ValueError(
            "cannot derive weighted-scheme lanes from a uniform-weight "
            "base spec; build the base spec with e.g. SPRAY_W")
    return np.asarray(spec.weights, np.float32)


def lane_static_path(spec, scheme) -> np.ndarray:
    """A scheme lane's static path choice derived from a base spec."""
    p = resolve(scheme)
    if p.pin_minimal:
        return np.asarray(
            np.where(spec.bg_mask, spec.static_path, spec.min_path),
            np.int32)
    if resolve(spec.scheme).pin_minimal:
        raise ValueError(
            "cannot derive ECMP-style lanes from a MINIMAL base spec; "
            "build the base spec with e.g. SPRAY_W")
    return np.asarray(spec.static_path, np.int32)


def lane_arrays(spec, scheme) -> tuple[np.ndarray, np.ndarray]:
    return lane_weights(spec, scheme), lane_static_path(spec, scheme)
