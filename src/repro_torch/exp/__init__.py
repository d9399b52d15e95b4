"""Declarative experiment matrix on the port (DESIGN.md §13).  Port of
``repro.exp``.

The same matrix (:mod:`repro_torch.exp.matrix`, all 82 cells) and one
runner (``python -m repro_torch.exp run --tier smoke``) that dispatches
every cell (packet, flow, cross-engine, open-loop and host) through the
port's packet and flow engines on the card, caches per-cell JSON results
by content hash under ``results/exp_torch/``, and gates the reference's
ratio and counter guards.
"""
from repro_torch.exp.spec import ENGINES, TIERS, Cell, validate_result

__all__ = ["Cell", "ENGINES", "TIERS", "validate_result"]
