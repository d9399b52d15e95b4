"""Declarative experiment matrix on the port (DESIGN.md §13).  Port of
``repro.exp``.

The same matrix (:mod:`repro_torch.exp.matrix`, all 82 cells) and one
runner (``python -m repro_torch.exp run --tier smoke``) that dispatches
the packet, host and packet-fidelity open-loop cells through the port's
packet engine on the card, caches per-cell JSON results by content hash
under ``results/exp_torch/``, and gates the reference's ratio and
counter guards.  The flow-level cells wait for the port's flow engine
(ROADMAP.md queue 1, item 5).
"""
from repro_torch.exp.spec import ENGINES, TIERS, Cell, validate_result

__all__ = ["Cell", "ENGINES", "TIERS", "validate_result"]
