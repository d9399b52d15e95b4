"""Backwards-compatibility module: the Spritz core lives in
``repro_torch.net.policies.spritz`` (the sender-policy layer, DESIGN.md
§11), as the reference's ``repro.core.spritz`` re-exports
``repro.net.policies.spritz``.  Import from there in new code.

``_weighted_sample`` is the port's shared draw, ``weighted_sample_rows(u,
w)``: it takes the uniform draws where the reference takes a key."""
from repro_torch.net.policies.base import (  # noqa: F401
    weighted_sample_rows as _weighted_sample)
from repro_torch.net.policies.spritz import (  # noqa: F401
    ACK_ECN, ACK_OK, BUF_SLOTS, NACK, NO_FB, SCOUT, SPRAY, TIMEOUT,
    SpritzConfig, SpritzState, _buffer_insert_sorted, _buffer_push_back,
    _buffer_remove, effective_weights, feedback_logic, init_state,
    send_logic)
