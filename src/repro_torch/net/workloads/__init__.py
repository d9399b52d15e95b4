"""Traffic generators (host side, numpy only): the reference's
re-exports."""
from repro_torch.net.workloads.synthetic import (adversarial,
                                                 incast_bystanders,
                                                 motivational, permutation)
from repro_torch.net.workloads.collectives import (allreduce_butterfly,
                                                   allreduce_ring, alltoall)
from repro_torch.net.workloads.trace import websearch

__all__ = [
    "permutation", "adversarial", "motivational", "incast_bystanders",
    "allreduce_ring", "allreduce_butterfly", "alltoall", "websearch",
]
