"""The flow-level engine and the trainer-to-fabric bridge on the port
(DESIGN.md §12).  Port of ``repro.fabric``."""
from repro_torch.fabric import bridge, flowsim  # noqa: F401
