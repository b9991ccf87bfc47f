"""Platform topology: host groups of the workers, stacked or a process
each.  Counterpart of
``repro/topology``; see ``repro_torch.comm.hier`` for the transport that
rides its two tiers."""

from repro_torch.topology.topology import (Groups, Topology, grid_groups,
                                           make_host_groups,
                                           make_production_groups,
                                           make_worker_groups,
                                           production_grid)

__all__ = ["Groups", "Topology", "grid_groups", "make_host_groups",
           "make_production_groups", "make_worker_groups", "production_grid"]
