"""Platform topology: host groups of the stacked workers.  Counterpart of
``repro/topology``; see ``repro_torch.comm.hier`` for the transport that
rides its two tiers."""

from repro_torch.topology.topology import Topology

__all__ = ["Topology"]
