from repro_torch.comm import HierarchicalTransport  # noqa: F401
from repro_torch.engine.api import (SCHEMES, Executor,  # noqa: F401
                                    get_executor, validate_scheme)
from repro_torch.engine.chaos import (ChaosEvent, ChaosNetwork,  # noqa: F401
                                      ChaosSchedule)
from repro_torch.engine.elastic import (ElasticMeshExecutor,  # noqa: F401
                                        ResizeEvent, ResizeSchedule,
                                        ResizeStats)
from repro_torch.engine.merge import (AverageMerge, DeltaMerge,  # noqa: F401
                                      DynamicMerge, MergeStrategy,
                                      QuorumMerge, SparseDeltaMerge,
                                      get_merge)
from repro_torch.engine.mesh import MeshExecutor  # noqa: F401
from repro_torch.engine.network import (FixedLatencyNetwork,  # noqa: F401
                                        GeometricDelayNetwork, InstantNetwork,
                                        NetworkModel, Tier1BudgetController,
                                        get_network)
from repro_torch.engine.threads import ThreadExecutor  # noqa: F401
from repro_torch.topology import Topology  # noqa: F401
