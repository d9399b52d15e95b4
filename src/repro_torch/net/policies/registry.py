"""Sender-policy registry (DESIGN.md §11).

Port of ``repro.net.policies.registry``: all 11 schemes with their name,
code, family, device functions, lane rules, failover flag and flow-level
rule.  ``build_spec`` and ``lane_arrays`` read the host rules; the
engine calls a scheme's device functions through :func:`device_policy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.net.policies import base as PB
from repro_torch.net.policies import flicr as _flicr
from repro_torch.net.policies import ops as _ops
from repro_torch.net.policies import reps as _reps
from repro_torch.net.policies import spritz as _spritz
from repro_torch.net.policies import static as _static
from repro_torch.net.policies import ugal as _ugal
from repro_torch.net.sim import types as T

# module -> the scheme codes it registers, in the reference's order
_MODULES = (
    (_static, (T.MINIMAL, T.ECMP, T.VALIANT)),
    (_ugal, (T.UGAL_L,)),
    (_flicr, (T.FLICR_W,)),
    (_ops, (T.OPS_U, T.OPS_W)),
    (_spritz, (T.SCOUT, T.SPRAY_U, T.SPRAY_W)),
    (_reps, (T.REPS,)),
)


def _build() -> tuple[PB.PolicyDef, ...]:
    defs = [p for mod, codes in _MODULES for p in mod.make_policies(codes)]
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


def flow_rule(scheme) -> PB.FlowLevelRule:
    """A scheme's flow-level re-selection rule (DESIGN.md §12): the host
    lane the flow engine (``repro_torch.fabric.flowsim``) dispatches path
    init and per-epoch re-selection through."""
    return resolve(scheme).flow_level


def device_policy(scheme) -> PB.PolicyDef:
    """The policy with its device functions; raises ``ValueError`` for an
    unknown scheme."""
    return resolve(scheme)


# --------------------------------------------------- device-side assembly
def init_state(weights: np.ndarray, static_path: np.ndarray,
               device) -> dict:
    """The stacked policy state: one substate per family, whatever the
    scheme, keyed in sorted order (the order the reference's carry comes
    back in from ``jax.jit``)."""
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    sp = torch.as_tensor(np.asarray(static_path, np.int32), device=device)
    out: dict = {}
    for p in _POLICIES:
        if p.family and p.family not in out:
            out[p.family] = p.init_state(w, sp)
    return dict(sorted(out.items()))


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
